"""The port's ``spyral_utils`` shim (``attpc_engine_tpu_torch.compat``) and
its trace helper (``utils.trace_to``), on the CPU.

The shim mutates ``sys.modules``, so each of its tests runs in a
subprocess, with ``sys.modules['jax'] = None`` so that nothing can import
jax: the reference user scripts' ``spyral_utils`` imports resolve to the
port's classes, ``load_target`` reads a target JSON into the port's
``GasTarget``, a real ``spyral_utils`` is never shadowed and
``ATTPC_NO_SPYRAL_SHIM`` turns the shim off.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import torch

from attpc_engine_tpu_torch.utils import trace_to

REPO = Path(__file__).resolve().parents[1]

NO_JAX = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
"""


def _run(tmp_path, code: str, env_extra=None, pythonpath=None):
    """Run ``code`` in a subprocess where jax cannot be imported; returns
    the completed process."""
    script = tmp_path / "snippet.py"
    script.write_text(NO_JAX.format(repo=str(REPO)) + textwrap.dedent(code))
    env = {k: v for k, v in os.environ.items()
           if k not in ("ATTPC_NO_SPYRAL_SHIM", "PYTHONPATH")}
    if pythonpath is not None:
        env["PYTHONPATH"] = str(pythonpath)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_import_surface_resolves_to_the_port(tmp_path):
    res = _run(tmp_path, """
        from attpc_engine_tpu_torch.compat import install_spyral_utils_shim
        assert install_spyral_utils_shim() is True
        from spyral_utils.nuclear.target import load_target, GasTarget
        from spyral_utils.nuclear import NucleusData
        from spyral_utils.nuclear.nuclear_map import NuclearDataMap
        from attpc_engine_tpu_torch.nuclear import masses, target
        assert GasTarget is target.GasTarget
        assert load_target is target.load_target
        assert NucleusData is masses.NucleusData
        assert NuclearDataMap is masses.NuclearDataMap
        bad = [k for k in sys.modules if sys.modules[k] is not None
               and (k == "attpc_engine_tpu" or k.startswith(
                   ("jax.", "attpc_engine_tpu.")))]
        assert not bad, bad
        print("OK")
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "OK"


def test_load_target_gives_the_ports_gas_target(tmp_path):
    (tmp_path / "target.json").write_text(json.dumps(
        {"compound": [[1, 2, 2]], "pressure(Torr)": 300.0}))
    res = _run(tmp_path, """
        from attpc_engine_tpu_torch.compat import install_spyral_utils_shim
        install_spyral_utils_shim()
        from spyral_utils.nuclear.nuclear_map import NuclearDataMap
        from spyral_utils.nuclear.target import load_target
        from attpc_engine_tpu_torch.nuclear.target import GasTarget
        gas = load_target("target.json", NuclearDataMap())
        assert type(gas) is GasTarget, type(gas)
        print(gas.pressure, gas.density > 0)
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["300.0", "True"]


def test_shim_never_shadows_a_real_module(tmp_path):
    real = tmp_path / "site" / "spyral_utils"
    real.mkdir(parents=True)
    (real / "__init__.py").write_text("REAL = True\n")
    res = _run(tmp_path, """
        from attpc_engine_tpu_torch.compat import install_spyral_utils_shim
        assert install_spyral_utils_shim() is False
        import spyral_utils
        assert spyral_utils.REAL
        print("OK")
    """, pythonpath=tmp_path / "site")
    assert res.returncode == 0, res.stderr
    # an already-imported module (a real one, or a shim) is kept as well
    res = _run(tmp_path, """
        import types
        sys.modules["spyral_utils"] = mod = types.ModuleType("spyral_utils")
        from attpc_engine_tpu_torch.compat import install_spyral_utils_shim
        assert install_spyral_utils_shim() is False
        assert sys.modules["spyral_utils"] is mod
        print("OK")
    """)
    assert res.returncode == 0, res.stderr


def test_environment_opt_out(tmp_path):
    res = _run(tmp_path, """
        from attpc_engine_tpu_torch.compat import install_spyral_utils_shim
        assert install_spyral_utils_shim() is False
        try:
            import spyral_utils
        except ImportError:
            print("OK")
    """, env_extra={"ATTPC_NO_SPYRAL_SHIM": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "OK"


def test_trace_to_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace_to(log_dir):
        (torch.arange(1000.0) * 2.0).sum()
    (trace,) = log_dir.glob("trace_*.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)


def test_trace_to_none_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace_to(None):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []
