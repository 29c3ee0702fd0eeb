"""The inputs are made from the seed: the same seed gives the same inputs,
and every seed the same amount of work."""
import numpy as np
import pytest
import torch

import smoke
from benchlib import weights
from benchlib.loops import loop_for
from benchlib.synthetic import SyntheticLM

CELLS = ("granite-moe-3b.train-4x1024", "qwen2-7b.prefill-8k-32k",
         "qwen2-7b.decode-24x32k")


def test_synthetic_copy_matches_the_port():
    from repro_torch.data.pipeline import SyntheticLM as Port
    for seed, step in ((0, 0), (12345678901, 7)):
        a = SyntheticLM(49155, 64, seed=seed).batch(step, 0, 3)
        b = Port(49155, 64, seed=seed).batch(step, 0, 3)
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_weights_follow_the_seed(bench):
    c = smoke.smoke_run(bench, CELLS[1], 1).config
    a, b = weights.make(c, 2 ** 31 + 5, "cpu"), weights.make(c, 2 ** 31 + 5,
                                                               "cpu")
    other = weights.make(c, 2 ** 31 + 6, "cpu")
    assert list(a) == [s.name for s in weights.leaf_specs(c)]
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["embed.embedding"], other["embed.embedding"])
    scale = a["groups.0.l0.norm1.scale"]
    assert 0.5 < float(scale.mean()) < 1.5 and float(scale.std()) > 0.01


def _inputs(bench, cell, seed):
    run = smoke.smoke_run(bench, cell, seed)
    loop = loop_for(run.traffic["kind"])(run)
    kind = run.traffic["kind"]
    if kind == "train":
        return [loop.batch(i)["inputs"] for i in range(3)], [1]
    if kind == "prefill":
        sizes = sorted(loop.lengths)
        return [loop.prompt(c, int(j)) for c in range(2)
                for j in loop.order(c)], sizes
    hist = loop.layers[0].mixer.history(run.config, seed, 0, loop.B,
                                        loop.cache_len, "cpu")["k"]
    return [loop._first(r) for r in range(3)] + [hist], [loop.B, loop.T]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_inputs(bench, cell):
    seed = 3 * 2 ** 31 + 17
    a, sizes_a = _inputs(bench, cell, seed)
    b, sizes_b = _inputs(bench, cell, seed)
    c, sizes_c = _inputs(bench, cell, seed + 1)
    assert sizes_a == sizes_b == sizes_c
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and torch.equal(x, y)
                   for x, y in zip(a, c))


def test_prefill_lengths_are_one_set_in_seeded_orders(bench):
    from benchlib.loops.prefill import lengths
    full = bench.cell(CELLS[1]).traffic["lengths"]
    ls = lengths(full)
    assert ls[0] == 8192 and ls[-1] == 32768 and len(set(ls)) == 12
    assert all(x % 64 == 0 for x in ls)
    orders = {tuple(loop_for("prefill")(smoke.smoke_run(bench, CELLS[1], s))
                    .order(0)) for s in range(5)}
    assert len(orders) > 1
