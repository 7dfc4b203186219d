"""attpc_engine_tpu_torch: the AT-TPC detector simulation on PyTorch and CUDA.

A port of ``attpc_engine_tpu`` (JAX, Pallas) to PyTorch on an NVIDIA
Hopper GPU. The JAX package stays beside it as the reference the port is
tested against; module names follow it, so each module's counterpart is
found under the same path there.

This package imports ``torch`` and never ``jax``. Host modules that the JAX
package holds without any framework code are copied here (each says which
file it copies), because importing anything under ``attpc_engine_tpu``
imports jax; the files it uses as files (the pad assets, the writer child
script) are copies too, and the C++ sources ``native/*.cpp`` at the
repository's root are built by path.
"""

from .nuclear.masses import NuclearDataMap, NucleusData

# Global nuclide lookup, as ``attpc_engine_tpu.nuclear_map``.
nuclear_map = NuclearDataMap()

__version__ = "0.1.0"

__all__ = ["nuclear_map", "NuclearDataMap", "NucleusData", "__version__"]
