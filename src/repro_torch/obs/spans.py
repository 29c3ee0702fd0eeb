"""Spans of the port's layers, on the clock of the device trace.

A span is a ``torch.profiler.record_function`` range.  Kineto stamps it
on the clock of the device activities it traces, so a profile lays each
span against the device timeline: the kernels an operator launched
inside a span are the span's.  Spans are on only while a torch profiler
records (``torch.autograd._profiler_enabled()``); off, ``span`` costs
one flag test and returns a shared object that opens no range, adds no
autograd node and launches nothing.  ``spanned(name)`` puts a whole
function's calls in a span.

``span(name, backward=True)`` also times its region's backward pass.
``s.input(t)`` and ``s.output(t)`` put an identity autograd function on
each of the region's differentiable inputs and outputs; the backward
opens ``<name>.backward`` when the first output's gradient arrives and
closes it once every input's gradient has left.  The kernels that
autograd launches for the region (from its own thread, for a CUDA
device) then fall inside that range on that thread.  A region's outputs
may not be written in place afterwards (autograd forbids it on the view
an identity function returns).

``NAMES`` lists every span of the port, and the metric each serves:

- ``train.step``: the train bundles' ``train_step`` (mesh-free and
  mesh), the parent of a step's spans;
- ``optim.adamw``: ``AdamW.update``;
- ``moe.route``: ``models.moe.route`` (forward and remat recompute);
- ``moe.dispatch``, ``moe.experts``, ``moe.combine`` and the backward of
  the first and last: ``models.moe._experts``'s scatter into the
  (experts, capacity, d_model) buffer, the experts' FFN on it, and the
  gather back with the k-way sum;
- ``attn.flash_bwd``: ``kernels.ops._fa_bwd``, the attention backward
  (autograd's thread);
- ``serve.decode_step``: the decode bundle's entry (mesh-free and
  mesh);
- ``layer.mixer``, ``layer.ffn``, ``model.embed``, ``model.logits``:
  ``layer_apply``'s two sublayers (norm to residual add), the embedding
  and the head (in the loss, the head and the cross-entropy).
"""
from __future__ import annotations

import functools

import torch
from torch.profiler import record_function

NAMES = (
    "train.step", "optim.adamw", "moe.route",
    "moe.dispatch", "moe.dispatch.backward", "moe.experts",
    "moe.combine", "moe.combine.backward", "attn.flash_bwd",
    "serve.decode_step",
    "layer.mixer", "layer.ffn", "model.embed", "model.logits",
)

on = torch.autograd._profiler_enabled


class _Off:
    """The span while no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def input(self, t):
        return t

    output = input


_OFF = _Off()


def span(name: str, backward: bool = False):
    """A context manager: the range ``name`` while a profiler records,
    else nothing.  With ``backward`` its ``input`` and ``output`` mark
    the region whose backward ``<name>.backward`` times."""
    if not on():
        return _OFF
    return _Span(name, backward)


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Span:
    __slots__ = ("_range", "_bwd")

    def __init__(self, name: str, backward: bool):
        self._range = record_function(name)
        self._bwd = _Backward(name + ".backward") if backward else None

    def __enter__(self):
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)

    def _marks(self, t) -> bool:
        return (self._bwd is not None and torch.is_grad_enabled()
                and t.requires_grad)

    def input(self, t):
        """``t``, whose gradient leaving the region ends its backward."""
        if not self._marks(t):
            return t
        self._bwd.inputs += 1
        return _Close.apply(t, self._bwd)

    def output(self, t):
        """``t``, whose gradient arriving starts the region's backward."""
        if not self._marks(t):
            return t
        return _Open.apply(t, self._bwd)


class _Backward:
    """The backward range of one region: opened by the first output's
    gradient, closed by the last input's."""
    __slots__ = ("name", "inputs", "range")

    def __init__(self, name: str):
        self.name = name
        self.inputs = 0
        self.range = None

    def open(self):
        if self.range is None and self.inputs and on():
            self.range = record_function(self.name)
            self.range.__enter__()

    def close(self):
        self.inputs -= 1
        if self.inputs == 0 and self.range is not None:
            self.range.__exit__(None, None, None)
            self.range = None


class _Open(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, state):
        ctx.state = state
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.state.open()
        return g, None


class _Close(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, state):
        ctx.state = state
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.state.close()
        return g, None
