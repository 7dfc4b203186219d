"""The port's libraries are built once per source set, not once per
process, on the CPU.

``kernels.build`` names the CUDA library by a hash of ``csrc/``, the
flags and ``nvcc --version``, and builds it under a lock; here a stand-in
for nvcc (a script that logs each call and writes its ``-o`` file) shows
that processes started together run one build, that a built library is
reused and that a changed source is built anew. ``native.py``'s host
libraries follow the same rule with the real g++. The build on the card
is held by tests/test_torch_cuda.py::test_concurrent_first_users_run_one_build.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from attpc_engine_tpu_torch import kernels, native

REPO = Path(__file__).resolve().parents[1]

FAKE_NVCC = '''#!{python}
import os, sys, time
args = sys.argv[1:]
if args == ["--version"]:
    print("stand-in nvcc, release 0.0")
    sys.exit(0)
with open(os.environ["FAKE_NVCC_LOG"], "a") as log:
    log.write(" ".join(args) + "\\n")
time.sleep(1.0)
with open(args[args.index("-o") + 1], "w") as out:
    out.write("stand-in object")
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """CUDA_HOME with a stand-in nvcc; returns its call log."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.touch()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    return log


def _compiles(log: Path) -> list[str]:
    return log.read_text().splitlines()


def test_processes_started_together_run_one_build(fake_nvcc, tmp_path):
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from attpc_engine_tpu_torch import kernels\n"
        "kernels.BUILD_DIR = Path(sys.argv[1])\n"
        "kernels.build()\n"
        "print(json.dumps(kernels.build_seconds()))\n"
    )
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    builds = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert sorted(b["built"] for b in builds) == [False, False, True]
    assert len({b["library"] for b in builds}) == 1
    # one nvcc per source and one link, by one process
    assert len(_compiles(fake_nvcc)) == len(kernels.SOURCES) + 1
    assert sorted(p.name for p in build.iterdir()) == sorted(
        [builds[0]["library"], "kernels.lock"])


def test_built_library_is_reused_and_a_changed_source_rebuilt(
        fake_nvcc, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(kernels._state, "build", None)
    monkeypatch.setitem(kernels._state, "path", None)
    first = kernels.build()
    assert kernels.build_seconds()["built"]
    assert first.name.startswith("libattpc_kernels-")
    n = len(_compiles(fake_nvcc))
    assert kernels.build() == first
    assert not kernels.build_seconds()["built"]
    assert len(_compiles(fake_nvcc)) == n
    # a header that every source may include changes the key
    header = csrc / "radix_warp.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    second = kernels.build()
    assert second != first and kernels.build_seconds()["built"]
    assert len(_compiles(fake_nvcc)) == 2 * n


def test_native_library_keyed_by_its_source(tmp_path, monkeypatch):
    """A host library is built once and reused by name; a changed source
    gets a library of its own."""
    src = tmp_path / "native"
    shutil.copytree(REPO / "native", src)
    monkeypatch.setattr(native, "_NATIVE_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_paths", {})
    first = native._build("stopping", "stopping.cpp")
    assert first is not None and first.name.startswith("libstopping-")
    mtime = first.stat().st_mtime_ns
    monkeypatch.setattr(native, "_paths", {})  # as a second process
    assert native._build("stopping", "stopping.cpp") == first
    assert first.stat().st_mtime_ns == mtime
    cpp = src / "stopping.cpp"
    cpp.write_text(cpp.read_text() + "\n// changed\n")
    monkeypatch.setattr(native, "_paths", {})
    second = native._build("stopping", "stopping.cpp")
    assert second is not None and second != first
    assert sorted(p.name for p in (tmp_path / "build").glob("*.so")) == sorted(
        [first.name, second.name])
