"""Host I/O: the kinematics file format shared with the JAX package."""
