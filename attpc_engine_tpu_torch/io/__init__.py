"""Host I/O: the kinematics file format shared with the JAX package.

``kinematics_file`` imports h5py only when a file is opened, so this
package imports where h5py is missing (the card's Python has none)."""

from .kinematics_file import KinematicsReader, KinematicsWriter

__all__ = ["KinematicsWriter", "KinematicsReader"]
