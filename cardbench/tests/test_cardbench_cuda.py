"""On the card (``cuda`` marker; skips without one): each cell at the
smoke size through the port's kernels, against the reference, with the
kernel launches the path must take.  Run on a machine with the card:
``python -m pytest -q -m cuda cardbench/tests``."""
import time

import pytest

import smoke
from benchlib import harness

CELLS = ("granite-moe-3b.train-4x1024", "qwen2-7b.prefill-8k-32k",
         "qwen2-7b.decode-24x32k")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_at_smoke_size_on_the_card(bench, cuda, cell):
    run = smoke.smoke_run(bench, cell, 2 ** 31 + 7)
    run.device = cuda
    res = harness.run_cell(bench, run, 0.5, True, time.perf_counter(),
                           log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert any(k.endswith("_launch_gap") for k in res["checks"])
