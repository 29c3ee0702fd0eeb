"""The check that decides ``correct``, driven on the CPU at a small size:
the plain references against the port's CPU path, the control (the
reference with fp8 products in the program's place) and each fault the
cell can have, planted in the timed path, come out as not correct."""
import time

import pytest

import smoke
from benchlib import harness
from benchlib.loops import loop_for

TRAIN, PREFILL, DECODE = ("granite-moe-3b.train-4x1024",
                          "qwen2-7b.prefill-8k-32k", "qwen2-7b.decode-24x32k")
# the faults each cell can have (one card: no exchange between chips; a
# prefill of one prompt has no half batch, a train step serves no token)
FAULTS = [(TRAIN, "unchanged"), (TRAIN, "half_batch"),
          (PREFILL, "unchanged"), (PREFILL, "altered"),
          (DECODE, "unchanged"), (DECODE, "half_batch"), (DECODE, "altered")]
SEED = 2 ** 31 + 123


def _run(bench, cell, fault=None, seed=SEED):
    run = smoke.smoke_run(bench, cell, seed, fault)
    return harness.run_cell(bench, run, 0.2, False, time.perf_counter(),
                            log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", [TRAIN, PREFILL, DECODE])
def test_reference_matches_the_ports_cpu_path(bench, cell):
    """In float32 on the CPU the port and the reference differ by the
    order of their sums only."""
    res = _run(bench, cell)
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] <= (0 if "launch" in name or "mismatch" in name
                              else 1e-4), (name, c)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(bench, cell, fault):
    res = _run(bench, cell, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", [TRAIN, PREFILL, DECODE])
def test_the_control_is_not_correct(bench, cell):
    """The reference with fp8 products, in the program's place, fails one
    of the cell's limits at least (at the control size: at the smoke
    size two layers leave fp8's error too little depth to grow)."""
    from reference.plain import FP8, Float32
    run = smoke.smoke_run(bench, cell, SEED, size="control")
    loop = loop_for(run.traffic["kind"])(run)
    loop.setup()
    from control import program_outputs
    program_outputs(loop)
    prog = loop.kept()
    loop.release()
    ref = loop.reference(Float32, prog)
    numbers = loop.compare(loop.reference(FP8, prog), ref)
    limits = bench.cell(cell).limits
    assert any(v > limits[k] for k, v in numbers.items()), numbers
