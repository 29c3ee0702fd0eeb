"""Run a test module's reference side and its port ranks as subprocesses.

A module defines ``ref_main(out_path)`` (the JAX package, on forced CPU
devices) and ``rank_main(rank, world, store, out_dir)`` (one gloo rank of
the port, meeting the others through a ``FileStore`` at ``store``); each
writes an npz.  ``run_sides`` starts all of them at once and waits for
them within one deadline.
"""
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def _env(xla_devices: int = 0) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([HERE, SRC]),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    if xla_devices:
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                            f"{xla_devices}")
    return env


def run_sides(tmp, module: str, world: int, ref_devices: int,
              timeout: float):
    """Start ``module.ref_main`` on ``ref_devices`` forced devices and
    ``world`` ranks of ``module.rank_main``; wait for all within
    ``timeout`` seconds (then kill what is left and fail).  Returns
    (the reference's npz, [each rank's npz]) as dicts."""
    calls = [("ref", f"t.ref_main({str(tmp / 'ref.npz')!r})",
              _env(ref_devices))]
    store = str(tmp / "store")
    calls += [(f"rank{r}", f"t.rank_main({r}, {world}, {store!r}, "
               f"{str(tmp)!r})", _env()) for r in range(world)]
    procs, logs = [], []
    try:
        for name, call, env in calls:
            logs.append(open(tmp / f"{name}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import {module} as t; {call}"],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for (name, _, _), p in zip(calls, procs):
        if p.returncode != 0:
            tail = (tmp / f"{name}.log").read_text()[-4000:]
            raise AssertionError(f"{name} exited {p.returncode}:\n{tail}")
    ref = dict(np.load(tmp / "ref.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    return ref, ranks
