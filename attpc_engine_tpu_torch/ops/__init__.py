"""Low-level array ops: Szudzik pairing (a copy of the JAX package's) and
``interp``, a PyTorch copy of ``jnp.interp``'s formula."""

from .interp import interp
from .pairing import pair, unpair, pair_arrays, unpair_arrays

__all__ = ["pair", "unpair", "pair_arrays", "unpair_arrays", "interp"]
