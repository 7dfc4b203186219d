"""The latency bound of K1: the critical path of one RK4 step in its SASS.

K1 (``attpc_engine_tpu_torch/csrc/transport.cu``) runs one thread per track
and every step of a track is one chain of dependent instructions, so the
least time the card could take for a window is the longest chain through
one step, times the steps the longest-lived track runs, at the SM clock.
This tool gives the first factor, on a machine with the card and nvcc:

1. builds ``transport.cu`` to a cubin with the library's flags
   (``kernels.NVCC_FLAGS``) and ``tools/sm90_latency_probe.cu`` to a
   library, one nvcc each, all at once, and disassembles both with
   ``cuobjdump -sass``;
2. runs the probe, which times dependent chains of each instruction class
   on the card;
3. takes the loop of ``rk4_window_kernel`` in the SASS, follows its fast
   path (every branch to a slow path, a division's or a square root's
   special-case code, not taken), builds the graph of register and
   predicate dependences over one step, gives each instruction its class's
   measured latency (``LATENCY_CLASS`` below) and prints the longest path:
   its cycles, the instructions on it, and the cycles by class.

It does so for both kinds of step the kernel has: the branch-free fast
paths (built with ``-DATTPC_K1_FAST_ONLY``: the step a live track runs,
whose path is K1's latency bound) and the compiler's IEEE operators
(``-DATTPC_K1_IEEE_ONLY``, the design before the fast paths).
``chip_smoke.py`` and ``tools/profile_torch_step.py --transport-steps``
call ``analyse`` for the fast paths in their own runs.

Run from the repository root: ``python3 tools/k1_critical_path.py [DIR]``;
with DIR the SASS and the results are written there too.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from attpc_engine_tpu_torch import kernels  # noqa: E402

PROBE = REPO / "tools" / "sm90_latency_probe.cu"
KERNEL = "rk4_window_kernel"
# the two kinds of step, each built alone (transport.cu's analysis defines)
STEPS = {"fast paths": "-DATTPC_K1_FAST_ONLY",
         "IEEE operators": "-DATTPC_K1_IEEE_ONLY"}
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# The latency class of each SASS mnemonic: its own where the probe
# measures it, else the class of the pipe it runs on. Integer ALU, vote and
# predicate ops take IADD3's latency; constant-bank and special-register
# reads have no register input (their values are ready before the chain
# needs them) and take LDS's.
LATENCY_CLASS = {
    "FADD": "FADD", "FMUL": "FMUL", "FFMA": "FFMA", "FMNMX": "FMNMX",
    "FSEL": "FSEL", "FSETP": "FSETP", "HFMA2": "FFMA",
    "MUFU.RCP": "MUFU.RCP", "MUFU.RSQ": "MUFU.RSQ",
    "FRND": "FRND", "F2I": "F2I", "I2FP": "I2FP",
    "IADD3": "IADD3", "LOP3": "IADD3", "LEA": "IADD3", "ISETP": "IADD3",
    "MOV": "IADD3", "PRMT": "IADD3", "SEL": "IADD3", "SHF": "IADD3",
    "UIADD3": "IADD3", "UMOV": "IADD3", "CS2R": "IADD3", "VOTE": "IADD3",
    "PLOP3": "IADD3", "P2R": "IADD3", "R2P": "IADD3", "IABS": "IADD3",
    "IMAD": "IMAD", "LDS": "LDS", "LDC": "LDS", "ULDC": "LDS", "S2R": "LDS",
}
# control and stores: no register results on the data path
NO_RESULT = ("BRA", "BSSY", "BSYNC", "CALL", "EXIT", "RET", "STG", "STS",
             "ST", "NOP", "WARPSYNC", "BAR", "FCHK")


def sass_class(op: str) -> str:
    """The latency class of a SASS mnemonic ("F2I.FLOOR.NTZ" is F2I)."""
    for key in sorted(LATENCY_CLASS, key=len, reverse=True):
        if op == key or op.startswith(key + "."):
            return LATENCY_CLASS[key]
    raise KeyError(f"no latency class for {op!r}")


def cuobjdump() -> str:
    return str(Path(kernels.nvcc()).parent / "cuobjdump")


def disassemble(path: Path) -> str:
    return subprocess.run([cuobjdump(), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def build(defines: list[str]) -> tuple[Path, dict]:
    """The probe's library and, for each define, a cubin of transport.cu
    built with the library's flags and it: one nvcc each, all at once.
    Returns (probe library, {define: cubin})."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / "libsm90_latency_probe.so"
    cubins = {d: kernels.BUILD_DIR / f"transport{d}.cubin" for d in defines}
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    kernels.run_parallel(
        [[kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
          str(PROBE)]]
        + [[kernels.nvcc(), *flags, d, "-cubin", "-o", str(c),
            str(kernels.CSRC / "transport.cu")] for d, c in cubins.items()])
    return so, cubins


def probe_latencies(so: Path) -> tuple[dict, list, str]:
    """Cycles of each instruction class on the card, solved from the probe
    library ``so``: (latencies, one row per chain, the probe's SASS)."""
    lib = ctypes.CDLL(str(so))
    lib.attpc_latency_probe.argtypes = [ctypes.c_void_p]
    lib.attpc_latency_probe_name.argtypes = [ctypes.c_int]
    lib.attpc_latency_probe_name.restype = ctypes.c_char_p
    n = lib.attpc_latency_probe_count()
    out = torch.zeros(n + 1, device="cuda")
    best = None
    for _ in range(5):  # the least of five runs
        err = lib.attpc_latency_probe(ctypes.c_void_p(out.data_ptr()))
        if err:
            raise RuntimeError(f"latency probe failed ({err})")
        v = out[:n].cpu().tolist()
        best = v if best is None else [min(a, b) for a, b in zip(best, v)]
    sass = disassemble(so)
    names = [lib.attpc_latency_probe_name(k).decode() for k in range(n)]
    lat, rows = solve_latencies(sass, names, best)
    return lat, rows, sass


def analyse(steps: dict) -> dict:
    """Build, probe and walk: for each ``{name: define}`` of ``steps`` the
    critical path of one live step (``critical_path``'s dict, with the
    SASS under "sass"), beside "latencies", "probe" (the probe's chains)
    and "probe_sass"."""
    so, cubins = build(list(steps.values()))
    lat, rows, probe_sass = probe_latencies(so)
    result = {"latencies": lat, "probe": rows, "probe_sass": probe_sass}
    for name, define in steps.items():
        sass = disassemble(cubins[define])
        result[name] = {**critical_path(fast_path(parse_sass(sass, KERNEL)),
                                        lat), "sass": sass}
    return result


def fast_step() -> dict:
    """The critical path of the step a live track runs (the fast paths),
    built and measured in this process: K1's latency bound a step."""
    return analyse({"fast paths": STEPS["fast paths"]})["fast paths"]


def solve_latencies(sass: str, names: list[str], cycles: list[float],
                    links: int = 512) -> tuple[dict, list]:
    """Latency of each class from the probe's chains: the SASS between the
    2k-th and (2k+1)-th clock read is chain k; its cycles (``cycles[k]`` a
    link) less those of the classes already known, over the count of its
    new classes' instructions (shared equally where a chain brings two).
    Classes with fewer than links / 4 instructions in a chain are set-up
    code scheduled into it, not links: they are left out of the solve."""
    ins = [t for _, t in parse_sass(sass, "probe_kernel")]
    clocks = [k for k, t in enumerate(ins) if "SR_CLOCKLO" in t]
    lat, rows = {}, []
    for k, name in enumerate(names):
        body = ins[clocks[2 * k] + 1:clocks[2 * k + 1]]
        count: dict = {}
        for t in body:
            cls = sass_class(split(t)[1])
            count[cls] = count.get(cls, 0) + 1
        count = {c: v for c, v in count.items() if v >= links // 4}
        total = cycles[k] * links
        new = [c for c in count if c not in lat]
        rest = total - sum(lat[c] * count[c] for c in count if c in lat)
        for c in new:
            lat[c] = rest / sum(count[x] for x in new)
        rows.append({"chain": name, "cycles_per_link": cycles[k],
                     "sass": count, "solved": {c: lat[c] for c in new}})
    return lat, rows


def parse_sass(sass: str, function: str) -> list[tuple[int, str]]:
    """(address, instruction text) of ``function`` in cuobjdump's SASS."""
    out, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        m = LINE.search(line)
        if inside and m:
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def split(text: str):
    """(guard, mnemonic, operands) of one SASS instruction."""
    guard = None
    if text.startswith("@"):
        guard, text = text.split(None, 1)
    op, _, rest = text.partition(" ")
    operands = [o.strip() for o in rest.split(",")] if rest.strip() else []
    return guard, op, operands


def _regs(operand: str) -> list[str]:
    """The registers an operand reads or names ("R4.64" is R4 and R5)."""
    found = []
    for m in re.finditer(r"(?<![A-Z])(U?R\d+|U?P\d)(\.64)?", operand):
        found.append(m.group(1))
        if m.group(2):
            found.append(f"R{int(m.group(1)[1:]) + 1}")
    return found


def defs_uses(guard, op: str, operands: list[str]):
    """Registers written and read by one instruction."""
    base = op.split(".")[0]
    if base in NO_RESULT or op.startswith("CALL"):
        dests, srcs = [], operands
    else:
        n_dest = 1
        first = operands[0] if operands else ""
        if base in ("FSETP", "ISETP", "DSETP", "PLOP3") or (
                first.startswith("P") and base == "LOP3"):
            n_dest = 2
        elif (base in ("IADD3", "LEA", "IMAD") and len(operands) > 1
              and re.fullmatch(r"P\d", operands[1])):
            n_dest = 2
        dests, srcs = operands[:n_dest], operands[n_dest:]
    d = [r for o in dests for r in _regs(o)]
    if ".WIDE" in op and d:
        d.append(f"R{int(d[0][1:]) + 1}")
    u = [r for o in srcs for r in _regs(o)]
    if guard is not None:  # a guarded write keeps the old value otherwise
        u += _regs(guard) + d
    return d, u


def fast_path(ins: list[tuple[int, str]]) -> list[str]:
    """One step of the RK4 loop as a live track runs it: the instructions
    from the loop's head to its back edge (the backward branch spanning the
    most code), every branch around a slow-path call (a short region
    holding a CALL) taken, every other branch not taken."""
    at = {a: k for k, (a, _) in enumerate(ins)}

    def target(text):
        _, op, operands = split(text)
        return int(operands[-1], 16) if op == "BRA" else None

    back = max((k for k, (a, t) in enumerate(ins)
                if target(t) is not None and target(t) < a),
               key=lambda k: ins[k][0] - target(ins[k][1]))
    k = at[target(ins[back][1])]
    path = []
    while k != back:
        text = ins[k][1]
        guard, op, operands = split(text)
        if op == "BRA":
            to = at[target(text)]
            region = [t for _, t in ins[k + 1:to]]
            slow = 0 < len(region) <= 8 and any("CALL" in t for t in region)
            if guard is None or (to > k and slow):
                k = to
                continue
        elif not op.startswith(("BSSY", "BSYNC")):
            path.append(text)
        k += 1
    return path


def critical_path(path: list[str], lat: dict) -> dict:
    """The longest chain of dependences through one step that starts and
    ends at the same loop-carried register (the steady state cannot run a
    step faster), with each instruction at its class's latency."""
    parsed = [(t, *defs_uses(*split(t))) for t in path]
    carried, written = [], set()
    for _, d, u in parsed:
        carried += [r for r in u if r not in written and r not in carried]
        written.update(d)
    carried = [r for r in carried if r in written]

    def latency(t):
        cls = sass_class(split(t)[1])
        return lat[cls], cls

    best = {"cycles": 0.0}
    for r in carried:
        ready = {r: (0.0, None)}  # register: (time, index of its producer)
        done = []
        for k, (t, d, u) in enumerate(parsed):
            src = [ready[x] for x in u if x in ready]
            if not src or not d:
                for x in d:  # overwritten by a value that does not depend on r
                    ready.pop(x, None)
                done.append(None)
                continue
            start, prev = max(src, key=lambda v: v[0])
            cyc, _ = latency(t)
            done.append((start + cyc, prev))
            for x in d:
                ready[x] = (start + cyc, k)
        if r in ready and ready[r][1] is not None and ready[r][0] > best["cycles"]:
            chain, k = [], ready[r][1]
            while k is not None:
                chain.append(k)
                k = done[k][1]
            best = {"cycles": ready[r][0], "register": r,
                    "chain": [parsed[k][0] for k in reversed(chain)]}
    by_class: dict = {}
    for t in best.get("chain", []):
        cyc, cls = latency(t)
        by_class[cls] = by_class.get(cls, 0.0) + cyc
    best["by_class"] = by_class
    best["carried"] = carried
    best["instructions"] = len(path)
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    result = analyse(STEPS)
    print("latency probe (cycles a link; SASS instructions a chain; solved "
          "latencies):")
    for r in result["probe"]:
        print(f"  {r['chain']:18s} {r['cycles_per_link']:7.2f}  {r['sass']}"
              f"  -> " + ", ".join(f"{c} {v:.2f}"
                                   for c, v in r["solved"].items()))
    for name, define in STEPS.items():
        cp = result[name]
        print(f"K1 step through the {name}: {cp['instructions']} "
              f"instructions on the live path; critical path "
              f"{cp['cycles']:.0f} SM cycles, from {cp['register']} back to "
              f"itself through {len(cp['chain'])} instructions; cycles by "
              f"class: " + ", ".join(
                  f"{c} {v:.0f}" for c, v in sorted(cp["by_class"].items(),
                                                     key=lambda kv: -kv[1])))
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"transport{define}.sass").write_text(cp.pop("sass"))
    if out_dir is not None:
        (out_dir / "latency_probe.sass").write_text(result.pop("probe_sass"))
        for name in STEPS:
            result[name].pop("sass", None)
        (out_dir / "k1_critical_path.json").write_text(
            json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
