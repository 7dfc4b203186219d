"""The PyTorch port's host modules against the JAX package.

The port holds its own copies of the framework-free host code (it may not
import anything under attpc_engine_tpu, which imports jax); these tests
hold the copies to the originals: masses, stopping tables, the detector
configuration tables and the GET response. A subprocess shows that every
module of the port imports with jax unavailable. Also home of the config
helpers the other test_torch_* files share.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import attpc_engine_tpu_torch as port
from attpc_engine_tpu import nuclear_map
from attpc_engine_tpu.detector import parameters as jparams
from attpc_engine_tpu.detector.response import get_response as jax_response
from attpc_engine_tpu.nuclear import GasTarget
from attpc_engine_tpu_torch.detector import parameters as tparams
from attpc_engine_tpu_torch.detector.response import (
    apply_response_batch,
    get_response,
)
from attpc_engine_tpu_torch.nuclear import GasTarget as TGasTarget

REPO = Path(__file__).resolve().parents[1]

# flagship detector (bench.py:134-174)
DET = dict(length=1.0, efield=45000.0, bfield=2.85, mpgd_gain=175000,
           diffusion=0.277, fano_factor=0.2, w_value=34.0)
ELEC = dict(clock_freq=6.25, amp_gain=900, shaping_time=1000,
            micromegas_edge=10, windows_edge=560, adc_threshold=40)


def jax_config():
    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    return jparams.Config(jparams.DetectorParams(gas_target=gas, **DET),
                          jparams.ElectronicsParams(**ELEC),
                          jparams.PadParams())


def torch_config():
    gas = TGasTarget([(1, 2, 2)], 300.0, port.nuclear_map)
    return tparams.Config(tparams.DetectorParams(gas_target=gas, **DET),
                          tparams.ElectronicsParams(**ELEC),
                          tparams.PadParams())


@pytest.mark.parametrize("za", [(0, 1), (1, 1), (1, 2), (2, 4), (6, 12),
                                (6, 13), (10, 20), (19, 41), (26, 56)])
def test_nuclear_map_matches(za):
    a = nuclear_map.get_data(*za)
    b = port.nuclear_map.get_data(*za)
    assert (a.mass, a.atomic_mass, a.isotopic_symbol, a.is_estimated) == (
        b.mass, b.atomic_mass, b.isotopic_symbol, b.is_estimated)


@pytest.fixture(params=["native", "numpy"])
def stopping_generator(request):
    """Both packages' stopping-power generator set to one kind: "native",
    the C++ library built from ``native/stopping.cpp``, or "numpy", the
    pure-Python version. The two agree only to ~1e-15 relative, so a
    comparison must hold both packages to the same one.

    The JAX package builds its library in place, where a concurrent test
    worker can find the file half written and fall back to numpy for the
    rest of its life. So the native case loads, for both packages, the
    library the port builds atomically (same source, same flags); where
    it cannot be built the case fails. The handles are restored after."""
    import attpc_engine_tpu.native as jnative
    import attpc_engine_tpu_torch.native as tnative

    saved = (jnative._LIB, jnative._TRIED, tnative._libs.get("stopping"),
             "stopping" in tnative._libs)
    try:
        if request.param == "native":
            tnative._libs.pop("stopping", None)
            lib = tnative.get_stopping_lib()
            assert lib is not None, "the stopping-power library did not build"
            jlib = ctypes.CDLL(lib._name)
            d = ctypes.POINTER(ctypes.c_double)
            # the signatures attpc_engine_tpu.native.get_stopping_lib sets
            jlib.mass_stopping_power.argtypes = [
                ctypes.c_int, ctypes.c_double, d, ctypes.c_int,
                d, d, d, ctypes.c_int, ctypes.c_double, d,
            ]
            jlib.mass_stopping_power.restype = None
            jlib.csda_range.argtypes = [d, d, ctypes.c_int, d]
            jlib.csda_range.restype = None
            jnative._LIB, jnative._TRIED = jlib, True
        else:
            tnative._libs["stopping"] = None
            jnative._LIB, jnative._TRIED = None, True
        yield request.param
    finally:
        jnative._LIB, jnative._TRIED = saved[0], saved[1]
        if saved[3]:
            tnative._libs["stopping"] = saved[2]
        else:
            tnative._libs.pop("stopping", None)


@pytest.mark.parametrize("za", [(1, 1), (1, 2), (2, 4), (6, 12), (6, 13)])
def test_dedx_tables_match(za, stopping_generator):
    """The dE/dx tables of both packages, bit for bit, under one
    stopping-power generator (``stopping_generator``), with fresh
    GasTargets (each caches its tables)."""
    jgas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    tgas = TGasTarget([(1, 2, 2)], 300.0, port.nuclear_map)
    jl, jd = jgas.dedx_interp_arrays(nuclear_map.get_data(*za))
    tl, td = tgas.dedx_interp_arrays(port.nuclear_map.get_data(*za))
    np.testing.assert_array_equal(jl, tl)
    np.testing.assert_array_equal(jd, td)
    assert jgas.density == tgas.density


def test_config_tables_match():
    jc, tc = jax_config(), torch_config()
    assert jc.drift_velocity == tc.drift_velocity
    jd, td = jc.device_arrays(), tc.device_arrays()
    for k in ("key_grid_mm", "edges", "centers", "sizes", "response"):
        np.testing.assert_array_equal(jd[k], td[k], err_msg=k)
    assert (jd["grid_lo_mm"], jd["grid_n_mm"]) == (td["grid_lo_mm"],
                                                   td["grid_n_mm"])
    # the pad-id table the lookup kernel reads == the TPU kernel's planes
    np.testing.assert_array_equal(
        (jd["plane_hi"] * 128 + jd["plane_lo"]).astype(np.int32),
        td["pad_table"])
    np.testing.assert_array_equal(jc.beam_mask, tc.beam_mask)


def test_pad_table_rule_on_random_grid():
    from attpc_engine_tpu.detector.deposit_pallas import build_plane_tables

    rng = np.random.default_rng(0)
    grid = rng.integers(-1, 10240, size=(559, 559)).astype(np.int64)
    beam = np.zeros(10240, bool)
    beam[rng.integers(0, 10240, 122)] = True
    hi, lo = build_plane_tables(grid, beam)
    np.testing.assert_array_equal((hi * 128 + lo).astype(np.int32),
                                  tparams.build_pad_table(grid, beam))
    with pytest.raises(ValueError):
        tparams.build_pad_table(np.zeros((560, 560), np.int64), beam)


def test_response_matches():
    jc, tc = jax_config(), torch_config()
    np.testing.assert_array_equal(jax_response(jc), get_response(tc))
    resp = torch.from_numpy(get_response(tc))
    electrons = torch.tensor([0.0, 1.0, 7.5, 1e4], dtype=torch.float64)
    amp, integral = apply_response_batch(resp, electrons)
    ref = np.minimum(get_response(tc)[None, :] * electrons.numpy()[:, None],
                     4095.0)
    np.testing.assert_allclose(amp.numpy(), ref.max(axis=1), rtol=1e-12)
    np.testing.assert_allclose(integral.numpy(), ref.sum(axis=1), rtol=1e-12)


def test_kinematics_file_roundtrip(tmp_path):
    """The port's kinematics copy reads what the JAX package writes."""
    from attpc_engine_tpu.io.kinematics_file import KinematicsWriter
    from attpc_engine_tpu_torch.io.kinematics_file import KinematicsReader

    rng = np.random.default_rng(1)
    vert = rng.normal(size=(5, 3))
    mom = rng.normal(size=(5, 4, 4))
    for schema in ("columnar", "reference"):
        path = tmp_path / f"{schema}.h5"
        w = KinematicsWriter(path, 5, [1, 6, 1, 6], [2, 12, 1, 13],
                             schema=schema)
        w.write_batch(vert, mom)
        w.close()
        r = KinematicsReader(path)
        v, m = r.read_range(1, 4)
        r.close()
        np.testing.assert_array_equal(v, vert[1:4])
        np.testing.assert_array_equal(m, mom[1:4])


def test_smoke_kinematics_matches_reader_schema(tmp_path):
    """The committed smoke input loads and has the reader's schema; written
    with the port's KinematicsWriter it reads back unchanged."""
    from attpc_engine_tpu_torch.io.kinematics_file import (
        KinematicsReader,
        KinematicsWriter,
    )

    data = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                   / "smoke_kinematics.npz")
    vert, mom = data["vertices"], data["momenta"]
    z, a = data["proton_numbers"], data["mass_numbers"]
    assert vert.shape == (1536, 3) and vert.dtype == np.float64
    assert mom.shape == (1536, 4, 4) and mom.dtype == np.float64
    assert list(z) == [1, 6, 1, 6] and list(a) == [2, 12, 1, 13]
    assert np.isfinite(vert).all() and np.isfinite(mom).all()
    path = tmp_path / "smoke.h5"
    w = KinematicsWriter(path, len(vert), z, a)
    w.write_batch(vert, mom)
    w.close()
    r = KinematicsReader(path)
    assert r.n_events == 1536
    np.testing.assert_array_equal(r.proton_numbers, z)
    v, m = r.read_range(384, 768)
    r.close()
    np.testing.assert_array_equal(v, vert[384:768])
    np.testing.assert_array_equal(m, mom[384:768])


def test_port_imports_without_jax():
    """Every module of the port imports with jax unavailable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import attpc_engine_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if sys.modules[k] is not None and ("
        "k in ('jax', 'attpc_engine_tpu') "
        "or k.startswith(('jax.', 'attpc_engine_tpu.')))]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    assert len(names) >= 38
    assert {f"attpc_engine_tpu_torch.{m}" for m in (
        "compat", "io.spyral_child", "parallel", "parallel.multihost",
        "utils.profiling")} <= set(names)


# ----------------------------------------------------------------------- #
# the port uses no file of the JAX package


def _copy_cuts(header: str) -> set[int]:
    """The source lines a copy's header says it leaves out ("less its
    lines 21-26, ... and 406-422 (...)"), 1-based."""
    import re

    listed = header.split("less its lines", 1)[1]
    cut = set()
    for a, b in re.findall(r"(\d+)-(\d+)", listed):
        cut.update(range(int(a), int(b) + 1))
    return cut


def test_writer_child_is_the_jax_child_less_its_cuts():
    """The port's writer child is the JAX package's, line for line, less
    its one-line header and the source lines the header lists; every cut
    line is one of the recycle path's, or of the docstring paragraph that
    names a path outside the repository."""
    src = (REPO / "attpc_engine_tpu" / "io" / "spyral_child.py").read_text()
    copy = (REPO / "attpc_engine_tpu_torch" / "io" / "spyral_child.py"
            ).read_text()
    header, body = copy.split("\n", 1)
    assert header.startswith(
        "# Copy of attpc_engine_tpu/io/spyral_child.py less its lines")
    cut = _copy_cuts(header)
    lines = src.splitlines(keepends=True)
    assert body == "".join(l for i, l in enumerate(lines, 1) if i not in cut)
    cut_text = "".join(lines[i - 1] for i in sorted(cut))
    assert "_mem = True" in cut_text and "_recycle" in cut_text
    assert "recycle" not in body.replace("io/recycle.py", "")


def test_pad_assets_are_a_copy():
    from attpc_engine_tpu_torch.detector.parameters import PAD_ASSETS

    src = REPO / "attpc_engine_tpu" / "detector" / "data" / "pad_assets.npz"
    assert PAD_ASSETS == (REPO / "attpc_engine_tpu_torch" / "data"
                          / "pad_assets.npz")
    assert PAD_ASSETS.read_bytes() == src.read_bytes()


def test_writer_proc_launches_the_ports_child(tmp_path):
    """SpyralWriterProc's child is the port's script (the byte-identity
    tests of tests/test_torch_driver.py run it against SpyralWriter)."""
    from attpc_engine_tpu_torch.detector import SpyralWriterProc
    from attpc_engine_tpu_torch.detector.writer import SPYRAL_CHILD

    assert SPYRAL_CHILD == (REPO / "attpc_engine_tpu_torch" / "io"
                            / "spyral_child.py")
    w = SpyralWriterProc(tmp_path, torch_config())
    try:
        assert w._proc.args[1] == str(SPYRAL_CHILD)
    finally:
        w.close()


def _jax_package_literals(source: str) -> list[str]:
    """String literals of ``source``, docstrings excepted, that name
    ``attpc_engine_tpu`` (a path under it, or a module of it)."""
    import ast

    tree = ast.parse(source)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docstrings.add(id(first.value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings
            and "attpc_engine_tpu" in node.value.replace(
                "attpc_engine_tpu_torch", "")]


def test_no_string_names_the_jax_package():
    """No string literal of the port, docstrings excepted, names a path or
    a module under attpc_engine_tpu; the scan finds the kind of literal
    that once pointed the writer child and the pad assets there."""
    assert _jax_package_literals(
        '"""attpc_engine_tpu/io in a docstring."""\n'
        'P = Path(x).parents[2] / "attpc_engine_tpu" / "io"\n'
        'Q = "attpc_engine_tpu_torch/io"\n') == ["attpc_engine_tpu"]
    found = {str(p.relative_to(REPO)): _jax_package_literals(p.read_text())
             for p in sorted((REPO / "attpc_engine_tpu_torch").rglob("*.py"))}
    assert len(found) >= 38
    assert {k: v for k, v in found.items() if v} == {}
