"""Run records (copy of attpc_engine_tpu/utils/manifest.py, with torch device fields in place of the JAX ones).

``write_run_manifest`` writes one JSON file per driver invocation next to
the run's output (``<stem>.run.json`` for file outputs,
``run_manifest_<n>.json`` inside directory outputs): what was simulated,
with which seed and budgets, on which device, and how long each phase
took.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any

import torch

__all__ = ["write_run_manifest", "device_record"]


def _jsonable(value: Any) -> Any:
    """Best-effort conversion to a JSON-serializable value."""
    import numpy as np

    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist() if value.size <= 64 else f"<array {value.shape}>"
    if isinstance(value, Path):
        return str(value)
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return repr(value)


def _nvidia_smi_card() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them, or None where
    nvidia-smi is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        res = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0] if lines else None


def device_record(device) -> dict:
    """The device fields of a run record: platform ("gpu" or "cpu"), the
    card's name, the nvidia-smi card line (name and power limit), the
    devices the run used and their number; torch's and CUDA's versions.
    ``device`` is the device the run ran on, or the list of them."""
    devices = ([torch.device(d) for d in device]
               if isinstance(device, (list, tuple)) else [torch.device(device)])
    dev = devices[0]
    record = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "devices": [str(d) for d in devices],
        "n_devices": len(devices),
    }
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        record.update(
            kind=torch.cuda.get_device_name(index),
            nvidia_smi=_nvidia_smi_card(),
        )
    else:
        record.update(kind="cpu", nvidia_smi=None)
    return record


def write_run_manifest(
    target: Path | str,
    *,
    stage: str,
    seed: int,
    event_range: tuple[int, int],
    device: torch.device | str | list,
    config: dict | None = None,
    budgets: dict | None = None,
    phase_seconds: dict | None = None,
    wall_seconds: float | None = None,
    extra: dict | None = None,
) -> Path | None:
    """Write a run-record JSON next to ``target``, the run's output file or
    directory; ``device`` is the device the run ran on, or the list of
    them. Returns the manifest path, or None if the record could not be
    written (a record never fails a run: an OSError is swallowed)."""
    from .. import __version__

    target = Path(target)
    try:
        record = {
            "engine": "attpc_engine_tpu_torch",
            "version": __version__,
            "stage": stage,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "seed": int(seed),
            "event_range": [int(event_range[0]), int(event_range[1])],
            "backend": device_record(device),
            "config": _jsonable(config or {}),
            "budgets": _jsonable(budgets or {}),
            "phase_seconds": _jsonable(phase_seconds or {}),
            "wall_seconds": wall_seconds,
        }
        if extra:
            record.update(_jsonable(extra))
        if target.is_dir():
            # exclusive create: several processes may finish into the same
            # directory at once
            n = 0
            while True:
                path = target / f"run_manifest_{n}.json"
                try:
                    with open(path, "x") as f:
                        json.dump(record, f, indent=2)
                    return path
                except FileExistsError:
                    n += 1
        else:
            path = target.with_suffix(target.suffix + ".run.json")
            with open(path, "w") as f:
                json.dump(record, f, indent=2)
            return path
    except OSError:
        return None
