"""The readings that a cell's limits are set from (not run by the
benchmark's own runs): the program's numbers over many seeds, each a full
run of the cell at ``--seconds``, and the control's over some of them.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 3 [--out readings.json]

The control is the reference put in the program's place and computed in
the next lower precision than the configuration's f32 step (bfloat16: the
transport state and the merged charges stored in it), over the same
sampled events as a run at the cell's own size, compared with the
reference in f32. Prints one JSON line a reading; ``--out`` collects them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def control(cell_name: str, seed: int, n_events: int, device="cuda") -> dict:
    """The control's numbers for ``seed``: the reference in bfloat16
    against the reference in f32 over a run's sample of events [0, n)."""
    import numpy as np
    import torch

    from benchref import nuclear_map
    from benchref.detector.plain import PlainDetector
    from pbench import cells, compare
    from pbench.inputs import Events

    cell = cells.find(cell_name)
    events = Events(cell.config, n_events,
                    cell.config["kinematics"].get("seed", seed), device)
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(n_events, min(compare.SAMPLE_EVENTS, n_events),
                             replace=False))
    args = (events.vertices[ids], events.momenta[ids], ids, seed)
    nuclei = (events.proton_numbers, events.mass_numbers, nuclear_map, device)
    ref = PlainDetector(cell.config, *nuclei).simulate(*args)
    low = PlainDetector(cell.config, *nuclei, low=torch.bfloat16).simulate(
        *args)
    return compare.compare(low, ref)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control-events", type=int, default=3072)
    parser.add_argument("--out")
    args = parser.parse_args()

    from pbench import runner

    readings = []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        result, _ = runner.run(args.workload, seed, args.seconds, False,
                               time.perf_counter())
        r = {"kind": "program", "seed": seed, **result["compared"],
             "correct": result["correct"], "metrics": result["metrics"],
             "attempted": result["attempted"], "card": result["device"]["card"],
             "seconds": time.perf_counter() - t0}
        print(json.dumps(r), flush=True)
        readings.append(r)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        r = {"kind": "control", "seed": seed,
             **control(args.workload, seed, args.control_events),
             "seconds": time.perf_counter() - t0}
        print(json.dumps(r), flush=True)
        readings.append(r)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
