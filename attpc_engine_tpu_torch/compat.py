"""A ``spyral_utils`` shim backed by the port (port of
attpc_engine_tpu/compat.py).

Upstream ``attpc_engine`` user scripts import from its ``spyral_utils``
dependency (``from spyral_utils.nuclear.target import load_target,
GasTarget``; ``from spyral_utils.nuclear import NucleusData``; ``from
spyral_utils.nuclear.nuclear_map import NuclearDataMap``: the complete set
used in the reference's source and docs). :func:`install_spyral_utils_shim`
registers synthetic ``spyral_utils`` modules in ``sys.modules``, backed by
the port's ``nuclear/masses.py`` and ``nuclear/target.py``, so that such a
script runs where neither jax nor ``spyral_utils`` is installed.

The shim NEVER shadows a real install: when ``spyral_utils`` is importable
(or already imported) it is a no-op. Set ``ATTPC_NO_SPYRAL_SHIM=1`` to
suppress it entirely. The top-level ``attpc_engine`` alias package stays
pointed at the JAX package.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types

__all__ = ["install_spyral_utils_shim"]


def _real_spyral_utils_available() -> bool:
    if "spyral_utils" in sys.modules:
        # already imported (real or a previous shim): never overwrite
        return True
    try:
        return importlib.util.find_spec("spyral_utils") is not None
    except (ImportError, ValueError):
        return False


def install_spyral_utils_shim(force: bool = False) -> bool:
    """Register ``spyral_utils.nuclear[.target|.nuclear_map]`` aliases.

    Returns True when the shim modules were installed, False when skipped
    (real package present or imported, or ``ATTPC_NO_SPYRAL_SHIM`` set).
    ``force=True`` skips the availability checks (tests only).
    """
    if not force:
        if os.environ.get("ATTPC_NO_SPYRAL_SHIM"):
            return False
        if _real_spyral_utils_available():
            return False

    from .nuclear import masses as masses_mod
    from .nuclear import target as target_mod

    root = types.ModuleType("spyral_utils")
    root.__doc__ = (
        "Compatibility shim installed by attpc_engine_tpu_torch.compat: the "
        "real spyral_utils is not installed; this exposes the subset of "
        "its API that attpc_engine user scripts import, backed by "
        "attpc_engine_tpu_torch.nuclear."
    )
    root.__path__ = []  # a package; submodules resolve via sys.modules

    nuclear = types.ModuleType("spyral_utils.nuclear")
    nuclear.__doc__ = root.__doc__
    nuclear.__path__ = []
    nuclear.NuclearDataMap = masses_mod.NuclearDataMap
    nuclear.NucleusData = masses_mod.NucleusData

    nuclear_map = types.ModuleType("spyral_utils.nuclear.nuclear_map")
    nuclear_map.__doc__ = root.__doc__
    nuclear_map.NuclearDataMap = masses_mod.NuclearDataMap
    nuclear_map.NucleusData = masses_mod.NucleusData

    root.nuclear = nuclear
    nuclear.nuclear_map = nuclear_map
    # the target surface is the port's module, registered under the alias:
    # the same classes, so isinstance checks in user scripts hold across
    # both import spellings
    nuclear.target = target_mod

    sys.modules["spyral_utils"] = root
    sys.modules["spyral_utils.nuclear"] = nuclear
    sys.modules["spyral_utils.nuclear.nuclear_map"] = nuclear_map
    sys.modules["spyral_utils.nuclear.target"] = target_mod
    return True
