"""The benchmark of the PyTorch and CUDA port (``attpc_engine_tpu_torch``):
one run of one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also ``breakdown``,
and last ``checks``: each number compared beside its limit); the last lines
of standard error are the same numbers. Exits with another code than 0,
and prints no result, where torch finds no card or fewer cards than the
cell asks for, where the port is not there, and where a module of JAX or
of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path[:0] = [str(HERE), str(ROOT)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from pbench import cells, runner

    cell = cells.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = runner.run(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_START)
    found = runner.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"card: {result['device']['card']}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
