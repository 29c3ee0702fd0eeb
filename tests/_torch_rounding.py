"""How far float32 summation order alone moves a result: a bar for
comparing two float32 evaluations of one function that differ only in the
order of their sums (a layer split over ranks against the whole layer, a
mesh step against the mesh-free step).

Two such evaluations form the same products and add them in another
order: tensor parallelism sums a contraction as per-rank partial sums
plus a collective, and the CPU's GEMM blocks a contraction by the shapes
it is given (so does each MKL code path in its own way).  Each order
rounds its partial sums differently, so the two differ by a few float32
steps of the terms' size; the layers then carry that difference through
every later operation, and some amplify it (xLSTM's exponential gates
and normaliser: ROADMAP C14).  How far it gets depends on the function
and its inputs, so the bar is measured on them, by evaluating the same
function with its sums in other genuine orders:

- :class:`reordered` splits the contraction of every float32 matrix
  product, forward and backward alike (``aten.mm``, ``bmm``, ``addmm``,
  ``baddbmm``: the products of ``@``, ``einsum`` and ``linear``), at a
  random point k, and adds the two partial products: the order in which
  a row-parallel product adds its ranks' partial sums;
- :func:`spread` is, for each entry, the largest change over a few such
  evaluations, pooled (the maximum) along the last axis, so that one
  entry's bar does not rest on a few draws of its own;
- :func:`assert_within` holds each entry at its flat bar plus twice its
  pooled spread: the gap under test is one more draw of the same kind of
  rounding, and twice the maximum of ``draws`` x (row length) draws
  leaves room for its tail.

Where the function is well conditioned the spread is a few float32 steps
of the entries; a fault of indexing, or a missing or doubled term, moves
entries by their own size, which it does not cover.
"""
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten
# product -> (index of its left operand, the contraction dim of it)
_PRODUCTS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 2),
             aten.addmm.default: (1, 1), aten.baddbmm.default: (1, 2)}


class reordered(TorchDispatchMode):
    """Within the context every float32 matrix product with a contraction
    of n >= 2 terms is computed as the sum of the products over terms
    ``0 .. k-1`` and ``k .. n-1``, k drawn uniformly from 1 .. n-1 by a
    generator seeded with ``seed``."""

    def __init__(self, seed: int):
        super().__init__()
        self.gen = torch.Generator().manual_seed(seed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        spec = _PRODUCTS.get(func)
        if spec is None or args[spec[0]].dtype != torch.float32 \
                or args[spec[0]].shape[spec[1]] < 2:
            return func(*args, **kwargs)
        left, dim = spec
        a, b = args[left], args[left + 1]
        n = a.shape[dim]
        k = int(torch.randint(1, n, (), generator=self.gen))
        prod = aten.bmm.default if a.dim() == 3 else aten.mm.default
        out = (prod(a.narrow(dim, 0, k), b.narrow(dim - 1, 0, k))
               + prod(a.narrow(dim, k, n - k), b.narrow(dim - 1, k, n - k)))
        if left == 1:           # addmm / baddbmm: beta * bias + alpha * AB
            beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
            out = beta * args[0] + alpha * out if (beta, alpha) != (1, 1) \
                else args[0] + out
        return out


def spread(run, draws: int = 4) -> dict:
    """``run()`` -> {key: array}; returns {key: the largest |change| of
    each entry over ``draws`` evaluations under :class:`reordered`, pooled
    (the maximum) along the last axis}.  Runs on one CPU thread, as the
    tests' rank processes do (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        base = {k: np.asarray(v, dtype=np.float64)
                for k, v in run().items()}
        out = {k: np.zeros_like(v) for k, v in base.items()}
        for seed in range(1, draws + 1):
            with reordered(seed):
                moved = run()
            for k, v in moved.items():
                out[k] = np.maximum(out[k], np.abs(
                    np.asarray(v, np.float64) - base[k]))
    finally:
        torch.set_num_threads(threads)
    return {k: np.broadcast_to(v.max(axis=-1, keepdims=True), v.shape)
            if v.ndim else v for k, v in out.items()}


def within(got, want, rtol: float, atol, spread_):
    """Entry by entry: |got - want| <= atol + rtol |want| + 2 spread."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want) <= atol + rtol * np.abs(want) + 2 * spread_


def assert_within(got, want, rtol: float, atol, spread_, err_msg=""):
    ok = within(got, want, rtol, atol, spread_)
    if not ok.all():
        gap = np.abs(np.asarray(got, np.float64) - want)
        i = np.unravel_index(np.argmax(np.where(ok, 0, gap)), gap.shape)
        raise AssertionError(
            f"{err_msg}: {(~ok).sum()} of {ok.size} entries beyond "
            f"atol {atol} + rtol {rtol} + twice their spread; worst at "
            f"{i}: got {np.asarray(got)[i]}, want {np.asarray(want)[i]}, "
            f"spread {np.asarray(spread_)[i]}")
