"""Readings for the limits of a cell's check, on the card at the cell's
size, many seeds in one process (the benchmark's own runs never run
this).

    python3 cardbench/control.py --workload <cell> --seeds 11,12,13 \
        [--control 11,12,13] [--fault half_batch] [--out FILE]

For each seed of ``--seeds`` it sets the cell up, produces the timed
path's outputs (train: the check steps of set-up; prefill: the sampled
requests; decode: one request) and prints the numbers of the check
against the float32 reference ("program"); for each seed of
``--control`` also the same numbers of the control, the reference
computed with fp8 products in the program's place ("control"); with
``--fault`` the program runs with that fault planted ("fault:<name>").
One JSON line per reading goes to standard output and to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]


def program_outputs(loop) -> None:
    """The timed path's outputs that the check compares, without a
    window."""
    kind = loop.run.traffic["kind"]
    if kind == "prefill":
        for j in loop.sample:
            loop.request(loop.prompt(0, j), keep=j)
    elif kind == "decode":
        loop.request(0)


def worst_leaves(prog: dict, ref: dict, n: int) -> list:
    """The n leaves of the largest first-gradient gaps: (leaf, program's
    norm, reference's norm, gap over the larger of the reference's norm
    and the median leaf's)."""
    import statistics
    med = statistics.median(ref["grad"].values())
    rows = [(k, prog["grad"][k], ref["grad"][k],
             abs(prog["grad"][k] - ref["grad"][k]) / max(ref["grad"][k], med))
            for k in ref["grad"]]
    return sorted(rows, key=lambda r: -r[3])[:n]


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--dump", default=None,
                   help="train cells: append every leaf's norms to DUMP")
    p.add_argument("--leaves", type=int, default=0,
                   help="train cells: also give the N leaves whose first "
                        "gradient's norm differs most")
    args = p.parse_args(argv)
    import torch
    from benchlib import harness
    from benchlib.loops import loop_for
    from benchlib.spec import Benchmark
    from reference.plain import FP8, Float32
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    bench = Benchmark(ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        t0 = time.perf_counter()
        run = harness.make_run(bench, args.workload, seed, "cuda",
                               fault=args.fault)
        loop = loop_for(run.traffic["kind"])(run)
        loop.setup()
        program_outputs(loop)
        prog = loop.kept()
        peak = torch.cuda.max_memory_allocated()
        loop.release()
        ref = loop.reference(Float32, prog)
        lines = [("program" if args.fault is None else f"fault:{args.fault}",
                  loop.compare(prog, ref))]
        if args.leaves and "grad" in prog:
            lines[0][1]["leaves"] = worst_leaves(prog, ref, args.leaves)
        low = None
        if seed in control:
            low = loop.reference(FP8, prog)
            lines.append(("control", loop.compare(low, ref)))
        if args.dump and "grad" in prog:
            with open(args.dump, "a") as f:
                print(json.dumps({"seed": seed, "fault": args.fault,
                                  "program": prog, "reference": ref,
                                  "control": low}), file=f)
        for what, numbers in lines:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "what": what, "numbers": numbers,
                               "memory_peak_bytes": peak,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                print(line, file=out, flush=True)
        del loop, prog, ref
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
