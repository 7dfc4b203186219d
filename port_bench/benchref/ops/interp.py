# Frozen copy of attpc_engine_tpu_torch/ops/interp.py; the benchmark's reference imports nothing of the port.
"""One-dimensional linear interpolation on tensors, as ``jnp.interp``
computes it (torch has no ``interp``).

The formula and its association are ``jnp.interp``'s, so that the two agree
to the last bit on the same IEEE operations: ``i = clip(searchsorted(xp, x,
side="right"), 1, len(xp) - 1)``, ``fp[i-1] + (delta / dx) * df`` with
``fp[i-1]`` where ``|dx| <= spacing(eps)``, and ``fp[0]`` / ``fp[-1]``
outside ``[xp[0], xp[-1]]``. ``np.interp`` associates differently.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["interp"]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Interpolate ``fp`` (sampled at the ascending 1-D ``xp``) at ``x``."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64
                                    else np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
