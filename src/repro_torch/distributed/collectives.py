"""Differentiable collectives over one process group, for the mesh step.

The mesh train step (``train/steps.py``) is explicit SPMD: each rank runs
the model on plain tensors and these autograd functions move values and
gradients between ranks.  Two cases need their own gradients:

- Over ``model`` the ranks compute one and the same loss from replicated
  values, so the gradient of a replicated input to a rank's own share of
  the work is the sum of the ranks' parts, and that of a summed output is
  the cotangent itself: Megatron's f (:func:`copy_to`, :class:`_CopyTo`)
  and g (:func:`reduce_from`, :class:`_ReduceFrom`).  An all-gather's
  gradient is the rank's own columns (:func:`gather_cols`), and a
  reduce-scatter's the ranks' columns gathered (:func:`reduce_scatter_cols`:
  a row-parallel product whose output columns are split, as the mLSTM's
  q, k and v by heads).  The
  vocab-parallel cross-entropy (:func:`vocab_parallel_ce`) reduces its
  max, sum and gold logit over the group and needs no collective in its
  backward pass.
- Over the batch axes each rank's loss is its own rows', and the losses
  add: an all-gather of rows takes the gradient back as a reduce-scatter
  sum (:class:`_GatherRows`; ``torch.distributed._functional_collectives``'
  autograd all-gather does that, and on ``model`` would count the
  replicated cotangent m times), and a reduce-scatter of rows (each
  rank's part of every row summed, the rank keeping its own) takes it
  back as an all-gather (:class:`_ReduceScatterRows`); a mean of
  per-rank scalars passes its gradient as it is (:class:`_MeanOver`).

- Over ``model`` under sequence parallelism (``seq_shard``) the residual
  stream holds each rank's positions, dim 1 of (B, S, D): a sublayer that
  the ranks split gathers them (:func:`gather_seq`, an all-gather whose
  gradient is a reduce-scatter: Megatron's g of sequence parallelism) and
  its partial outputs are reduce-scattered back to each rank's positions
  (:func:`reduce_scatter_seq`, whose gradient is an all-gather: Megatron's
  g-bar).  A sublayer that every rank computes whole gathers them without
  a sum in its gradient (:func:`gather_whole`: every rank's gradient of
  the gathered input is already whole) and keeps the rank's positions of
  its output (:func:`scatter_to`, whose gradient gathers the ranks').

A group of ``None`` stands for one rank: the functions are then
identities that return their input, with no copy.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _reduced(g, group):
    g = g.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(g, group=group)
    return g


def gathered(x, group, dim: int = 0):
    """The ranks' blocks of ``x`` side by side along ``dim``, in rank order
    (not differentiable); ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)


class _CopyTo(torch.autograd.Function):
    """Identity; the gradient is summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherCols(torch.autograd.Function):
    """The ranks' blocks of the last dim side by side, in rank order; the
    gradient is this rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.lo, ctx.n = dist.get_rank(group) * x.shape[-1], x.shape[-1]
        return gathered(x, group, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n], None


class _ReduceScatterCols(torch.autograd.Function):
    """The sum over the group, of which this rank keeps its block of the
    last dim (block r of n equal blocks); the gradient is the ranks'
    blocks side by side."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        C = x.shape[-1]
        # (..., n, C/n) -> (n, rows, C/n): block r of every row together
        blocks = x.reshape(-1, n, C // n).transpose(0, 1).contiguous()
        out = torch.empty(blocks.shape[1:], dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, blocks.reshape(-1, C // n),
                                   group=group)
        return out.reshape(*x.shape[:-1], C // n)

    @staticmethod
    def backward(ctx, g):
        return gathered(g.contiguous(), ctx.group, g.dim() - 1), None


class _GatherRows(torch.autograd.Function):
    """The ranks' rows stacked in rank order; the gradient of this rank's
    rows is summed over the group (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return gathered(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        out = torch.empty((ctx.rows,) + tuple(g.shape[1:]), dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


class _ReduceScatterRows(torch.autograd.Function):
    """The sum over the group of ``x``, of which this rank keeps its block
    of rows (block r of n); the gradient is the ranks' blocks stacked in
    rank order (an all-gather): the transpose of :class:`_GatherRows`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return gathered(g.contiguous(), ctx.group, 0), None


class _GatherWhole(torch.autograd.Function):
    """The ranks' blocks of ``dim`` side by side, in rank order; the
    gradient is this rank's block (every rank's gradient of the gathered
    value is the same whole)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.lo = dist.get_rank(group) * ctx.n
        return gathered(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


class _MeanOver(torch.autograd.Function):
    """The mean over the groups' ranks of a scalar that each rank computes
    from its own rows; the gradient passes as it is (each rank's loss holds
    the mean once, and the step averages the ranks' gradients)."""

    @staticmethod
    def forward(ctx, x, groups):
        out = x.clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out / math.prod(dist.get_world_size(g) for g in groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    """The sum over the group of a value that each rank computes from its
    own chunk and then uses for its own chunk again (a norm's statistics
    over features split over the group): the gradient is summed too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ScatterTo(torch.autograd.Function):
    """This rank's chunk (chunk r of n along ``dim``) of a value that every
    rank holds whole; the gradient is the ranks' chunks gathered, whole
    on every rank (Megatron's scatter to the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n)

    @staticmethod
    def backward(ctx, g):
        return gathered(g.contiguous(), ctx.group, ctx.dim), None, None


def sum_over(x, group):
    """The sum of ``x`` over the group, its gradient summed as well."""
    return x if group is None else _SumOver.apply(x, group)


def scatter_to(x, group, dim: int = 0):
    """This rank's chunk of a whole ``x`` along ``dim``; the gradient of
    ``x`` is gathered whole on every rank."""
    return x if group is None else _ScatterTo.apply(x, group, dim)


def copy_to(x, group):
    """Megatron's f, before a column-parallel product."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Megatron's g, after a row-parallel product."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_cols(x, group):
    """The ranks' blocks of ``x``'s last dim side by side, the gradient
    this rank's block: where each rank computes its columns of a value
    that every rank then uses whole."""
    return x if group is None else _GatherCols.apply(x, group)


def reduce_scatter_cols(x, group):
    """This rank's block of the last dim of the sum of ``x`` over the
    group: a row-parallel product whose output columns are split."""
    return x if group is None else _ReduceScatterCols.apply(x, group)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over a vocabulary
    whose columns are split over the group (Megatron's vocab-parallel
    cross-entropy).  Each rank holds the float32 logits of its columns
    ``lo .. lo + V_l - 1``; the max, the sum of exponentials and the gold
    logit (from the rank that owns the label) are reduced over the group.
    The gradient is softmax minus one-hot on the rank's own columns, in
    the order autograd forms it for ``torch.logsumexp`` and
    ``torch.gather``, so with one rank (``group`` None, where the forward
    is ``torch.logsumexp``) loss and gradient are the plain path's bit for
    bit."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        ids = labels - lo
        mine = (ids >= 0) & (ids < logits.shape[-1])
        ids = torch.where(mine, ids, 0)
        if group is None:
            lse = torch.logsumexp(logits, dim=-1)
        else:
            top = logits.amax(dim=-1)
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
            total = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
            dist.all_reduce(total, group=group)
            lse = torch.log(total) + top
        gold = torch.where(
            mine, torch.gather(logits, -1, ids[..., None])[..., 0], 0.0)
        if group is not None:
            dist.all_reduce(gold, group=group)
        ctx.save_for_backward(logits, lse, ids, mine)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, ids, mine = ctx.saved_tensors
        d = g[..., None] * torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, ids[..., None],
                       torch.where(mine, -g, 0.0)[..., None])
        return d, None, None, None


def gather_seq(x, group):
    """The ranks' positions of ``x`` (B, S_l, D) side by side, (B, S, D);
    the gradient is summed over the group and each rank keeps its
    positions (a reduce-scatter): before a sublayer the ranks split."""
    if group is None:
        return x
    return _GatherRows.apply(x.transpose(0, 1), group).transpose(0, 1)


def reduce_scatter_seq(x, group):
    """This rank's positions (its block of dim 1) of the sum of ``x``
    (B, S, D) over the group; the gradient is the ranks' positions
    gathered: after a sublayer the ranks split."""
    if group is None:
        return x
    return _ReduceScatterRows.apply(x.transpose(0, 1),
                                    group).transpose(0, 1)


def gather_whole(x, group, dim: int = 1):
    """The ranks' blocks of ``dim`` side by side, the gradient this rank's
    block: before a sublayer that every rank computes whole."""
    return x if group is None else _GatherWhole.apply(x, group, dim)


def vocab_parallel_ce(logits, labels, lo: int, group):
    """(..., V_l) float32 logits of vocabulary columns ``lo ..``, (...)
    labels -> (...) cross-entropy per token, the same on every rank."""
    return _VocabParallelCE.apply(logits, labels, lo, group)
