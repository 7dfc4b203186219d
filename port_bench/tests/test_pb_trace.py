"""The device trace's arithmetic: the union of device intervals that
overlap across streams, the idle share, the breakdown, and the per-layer
readers on a trace made by hand; the rooflines' byte counts against
chip_smoke.py's."""

import importlib.util
from types import SimpleNamespace

import pytest

from pbench import cells, roofline
from pbench.runner import MAIN_PHASES, WRITER_PHASES
from pbench.trace import Trace, union

from conftest import REPO


def test_union_merges_overlapping_and_nested_intervals():
    got = union([(5, 8), (0, 2), (1, 3), (6, 7), (10, 10), (8, 9), (12, 13)])
    assert got == [(0, 3), (5, 9), (12, 13)]


def chrome(events):
    return {"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in events]}


def test_idle_share_counts_overlapping_streams_once():
    """A kernel and a copy on two streams that overlap count once: a sum
    of device times would read 0.7 busy where the card was 0.5 busy."""
    data = chrome([
        ("cpu_op", "aten::item", 0, 100),
        ("kernel", "(anonymous namespace)::radix_cluster_kernel(unsigned "
         "long long const*, unsigned long long*, long, int)", 10, 30),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 20, 40),
        ("kernel", "void attpc::deposit_rows_kernel<4>(float const*)", 70,
         10),
        ("cuda_runtime", "cudaStreamSynchronize", 85, 15),
    ])
    t = Trace.from_chrome(data, batches=2, dispatches=[(384, 576, 12288)])
    assert t.window_s() == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(60e-6)  # [10, 60) and [70, 80)
    assert t.gaps() == [(0, 10), (60, 70), (80, 100)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["Memcpy DtoH", pytest.approx(40e-6)]
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx(
        {"cudaStreamSynchronize": 20e-6, "aten::item": 20e-6})

    run = SimpleNamespace(
        trace=t, batches=2, phase_seconds={}, main_phases=MAIN_PHASES,
        writer_phases=WRITER_PHASES, roofline=roofline,
        kernel_names=cells.load_json(cells.HERE / "kernel_names.json"))
    read = lambda name: cells.metric_reader(name)(run)  # noqa: E731
    assert read("device.idle_share") == pytest.approx(0.4)
    assert read("device.kernel_ms_per_batch") == pytest.approx(0.02)
    assert read("sort_rows_roofline") == pytest.approx(
        100 * roofline.bound_s(roofline.dispatch_sort_bytes(384, 576, 12288))
        / 30e-6)
    assert read("deposit_rows_roofline") == pytest.approx(
        100 * roofline.bound_s(roofline.rows_bytes(384, 576)) / 10e-6)


def test_the_compaction_roofline_sums_its_three_kernels():
    """The totals, carry and write kernels of each traced step against the
    bytes of each step's merge rows and slots; other kernels not counted."""
    data = chrome([
        ("kernel", "(anonymous namespace)::compact_runs_totals_kernel(long "
         "long const*, long, int, float*, int*)", 0, 200),
        ("kernel", "compact_runs_carry_kernel(float const*, int)", 200, 20),
        ("kernel", "compact_runs_write_kernel(long long const*)", 220, 180),
        ("kernel", "radix_cluster_kernel(long long const*)", 400, 500),
    ])
    steps = [(384, 1920, 12288), (384, 1920, 12288)]
    run = SimpleNamespace(
        trace=Trace.from_chrome(data, batches=2, dispatches=steps),
        batches=2, roofline=roofline,
        kernel_names=cells.load_json(cells.HERE / "kernel_names.json"))
    n_bytes = 2 * roofline.compact_bytes(384, 192_000, 12_288)
    assert cells.metric_reader("compact_runs_roofline")(run) == (
        pytest.approx(100 * roofline.bound_s(n_bytes) / 400e-6))


def test_readers_find_nothing_without_a_trace():
    run = SimpleNamespace(trace=None, batches=4,
                          phase_seconds={"read": 0.004, "dispatch": 0.04,
                                         "h5py-write": 0.2},
                          main_phases=MAIN_PHASES,
                          writer_phases=WRITER_PHASES, roofline=roofline,
                          kernel_names={})
    for name in ("device.idle_share", "device.kernel_ms_per_batch",
                 "sort_rows_roofline", "deposit_rows_roofline",
                 "compact_runs_roofline"):
        assert cells.metric_reader(name)(run) is None
    assert cells.metric_reader("driver.main_ms_per_batch")(run) == (
        pytest.approx(11.0))
    assert cells.metric_reader("driver.writer_ms_per_batch")(run) == (
        pytest.approx(50.0))


@pytest.mark.parametrize("phase", ["imports", "config", "kinematics",
                                   "warmup"])
def test_setup_readers_read_their_phase(phase):
    seconds = {"imports": 1.5, "config": 0.25, "kinematics": 0.5,
               "warmup": 4.0, "kernel_library": 0.125}
    run = SimpleNamespace(trace=None, batches=0, setup_seconds=seconds)
    assert cells.metric_reader(f"setup.{phase}_s")(run) == seconds[phase]


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bytes", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_byte_counts_match_chip_smoke_at_the_flagship_shapes():
    cs = chip_smoke()
    for e, pb in ((384, 576), (384, 1024), (128, 2048)):
        assert roofline.rows_bytes(e, pb) == cs.rows_bytes(e, pb)
    assert roofline.HBM_BYTES_PER_S == cs.HBM_BYTES_PER_S
    # K3 at the tuned [384, 57600]: 0.1056 ms (PERF.md's kernel table)
    assert 1e3 * roofline.bound_s(roofline.sort_bytes(384, 57600)) == (
        pytest.approx(0.1056, abs=5e-5))
    # the deposit rows at point budget 1,024: 0.0968 ms on 324 MB
    assert roofline.rows_bytes(384, 1024) == 324_263_936
    # one merge sort and the convert sort a step
    assert roofline.dispatch_sort_bytes(384, 576, 12288) == 16 * 384 * (
        57600 + 12288)


@pytest.mark.parametrize("w, cap, bound_ms", [
    (192_000, 24_576, 0.1986),  # c16dd's merge width (2 x uniq slots)
    (819_200, 49_152, 0.7963),  # the chain's (4 x uniq slots)
    (102_400, 12_288, 0.1052),  # the flagship's
])
def test_compaction_bytes_match_the_kernel_table(w, cap, bound_ms):
    """The run-end compaction's bound (PERF.md's kernel table, row C):
    the sorted rows read once, the cap slots of keys and charges
    written."""
    got = roofline.bound_s(roofline.compact_bytes(384, w, cap))
    assert 1e3 * got == pytest.approx(bound_ms, abs=5e-5)


def test_a_step_compacts_its_merge_rows_into_its_uniq_slots():
    assert roofline.dispatch_compact_bytes(384, 1920, 12288) == (
        roofline.compact_bytes(384, 192_000, 12_288))
    # a merge row narrower than the uniq budget has as many slots as lanes
    assert roofline.dispatch_compact_bytes(4, 64, 12288) == (
        roofline.compact_bytes(4, 6_400, 6_400))


def test_short_names_of_kernels():
    from pbench.trace import short_name, symbol

    assert short_name("void at::native::(anonymous namespace)::foo<float>("
                      "int)") == "at::native::foo"
    assert symbol("(anonymous namespace)::merge_tile_kernel(long long "
                  "const*)") == "merge_tile_kernel"
    assert short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


@pytest.mark.parametrize("name", ["sort_rows_roofline",
                                  "deposit_rows_roofline",
                                  "compact_runs_roofline"])
def test_a_roofline_with_its_kernel_but_no_recorded_step_raises(name):
    """Where the window stops going through ``simulate_batch`` the shapes
    are not recorded; the reader says so rather than going silent."""
    data = chrome([
        ("kernel", "radix_cluster_kernel(long long const*)", 0, 30),
        ("kernel", "void attpc::deposit_rows_kernel<4>(float const*)", 40,
         10),
        ("kernel", "compact_runs_write_kernel(long long const*)", 50, 5),
    ])
    run = SimpleNamespace(
        trace=Trace.from_chrome(data, batches=1, dispatches=[]), batches=1,
        phase_seconds={}, roofline=roofline,
        kernel_names=cells.load_json(cells.HERE / "kernel_names.json"))
    with pytest.raises(RuntimeError, match="simulate_batch"):
        cells.metric_reader(name)(run)
