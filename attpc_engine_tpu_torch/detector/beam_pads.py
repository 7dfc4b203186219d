# Copied from attpc_engine_tpu/detector/beam_pads.py; the port imports no jax, so it holds its own copy.
"""Beam-region pad ids.

The reference hardcodes the beam-pad id list in source
(upstream attpc_engine/detector/beam_pads.py:11-137); here the
ids live in the packaged geometry bundle (they are detector hardware data)
and this module exposes them under the same names for API parity. The veto
applied in the transport kernels uses the O(1) boolean LUT ``BEAM_MASK``
rather than a per-pixel linear membership scan.
"""

import numpy as np

from .parameters import PAD_ASSETS

with np.load(PAD_ASSETS) as _bundle:
    BEAM_PADS_ARRAY: np.ndarray = _bundle["beam_pads"]
    BEAM_MASK: np.ndarray = _bundle["beam_mask"]

BEAM_PADS: list[int] = BEAM_PADS_ARRAY.tolist()

__all__ = ["BEAM_PADS", "BEAM_PADS_ARRAY", "BEAM_MASK"]
