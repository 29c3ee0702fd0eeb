"""Run one cell of the port's benchmark on the card and print its result.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the port (``src/repro_torch``).  The last line of standard output is
the result as one JSON object; the numbers that decide ``correct``, each
beside its limit, are the last lines of standard error.  Without a CUDA
device (or with fewer than the cell asks for), without the port, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
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
# CUDA's JIT kernel cache at a fixed path inside the checkout
os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".cardbench_cache" / "nv")
sys.path[:0] = [str(HERE), str(ROOT / "src")]

# whole top-level module names that the process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m.partition(".")[0] for m in sys.modules} &
                  set(FORBIDDEN))


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchlib.spec import Benchmark
    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("error: the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    from benchlib import harness
    run = harness.make_run(bench, args.workload, args.seed, "cuda")
    result = harness.run_cell(bench, run, args.seconds, bool(args.trace),
                              T_START)
    found = forbidden_modules()
    if found:
        print(f"error: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
