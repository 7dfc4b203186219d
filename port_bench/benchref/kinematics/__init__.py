"""Frozen copy of the port's kinematics stage, less its batch loop."""
