"""Frozen copy of the port's ops (interp only)."""
