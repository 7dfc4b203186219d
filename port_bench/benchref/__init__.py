"""The benchmark's plain reference and input generator: frozen copies of the
port's plain PyTorch and numpy code (each file names its source), so that
later changes to the port cannot move the yardstick. Imports nothing of
the port, of the JAX package or of JAX."""

from .nuclear.masses import NuclearDataMap

nuclear_map = NuclearDataMap()
