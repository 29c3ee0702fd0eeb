"""Roofline analysis of the card's program, traced on fake tensors.

The port's counterpart of ``compiled.as_text()`` followed by
``analysis.roofline.analyze_hlo``: :func:`analyze_program` runs one call
of a step (a bundle's ``step_fn``) on fake tensors (``FakeTensorMode``:
shapes and dtypes, no memory, no launch) and fills the same
:class:`HLOAnalysis`, per device:

- FLOPs: the matmul family as ``torch.utils.flop_counter.FlopCounterMode``
  counts it (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions), the
  backward pass and any recompute included, as the reference counts its
  ``dot`` and ``convolution`` ops.  The attention kernels are operators
  with FLOP formulas of their own (``kernels/flash_attention.py``,
  ``kernels/ops.py``, ``kernels/flash_decode.py``) that count every
  (query, key) pair, the masked ones too, as the reference's plain
  attention does; the backward operator counts the forward it recomputes.
- HBM bytes: operand plus result bytes of every dispatched operator that
  is not a view, an allocation or metadata.  Eager torch runs each
  operator as its own kernels, so each one is a round trip to device
  memory.  This is not the reference's model, which counts only the
  buffers that XLA materializes after fusion (``roofline.py``,
  ``_BYTES_OPS``): an elementwise chain costs one round trip per
  operator here, one per fusion there.
- Collectives: each ``c10d`` or functional collective, where the port
  issues it (``distributed/collectives.py``, ``train/steps.py``, DTensor
  redistribution), seen by a ``TorchDispatchMode``: its group's global
  ranks from ``torch.distributed.get_process_group_ranks``, its moved
  bytes by the ring model of ``roofline._collective_record``, and ICI or
  DCN by whether the group's ranks differ in ``rank // chips_per_pod``.

The step runs eagerly, so loops are unrolled: every multiplier is 1.
A host without CUDA cannot run autograd on fake CUDA tensors (the CPU
build's engine asks the CUDA runtime for a stream), so there the trace
runs on fake meta tensors, sent down the card's path by
``kernels.ops.card_program`` (:func:`trace_device`); the operators are
the same, and so are their shapes.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.analysis.roofline import CollectiveRecord, HLOAnalysis

# operators that move no data: allocations, metadata, scalars, views that
# the schema does not mark as views (``prim`` ops, metadata too, are
# skipped by namespace)
_FREE = {
    "aten.empty.memory_format", "aten.empty_strided.default",
    "aten.empty_like.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.lift_fresh.default",
    "aten._local_scalar_dense.default", "aten.sym_size.int",
    "aten.sym_stride.int", "aten.sym_numel.default",
    "aten.is_same_size.default",
    "aten.set_.source_Tensor", "aten.resize_.default",
    "aten._unsafe_view.default", "_c10d_functional.wait_tensor.default",
}

# collective name -> the reference's HLO kind
_KINDS = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
          ("allgather", "all-gather"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
          ("broadcast", "collective-permute"), ("send", "collective-permute"),
          ("recv", "collective-permute"))


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


def _kind(name: str) -> Optional[str]:
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def _arguments(func, args, kwargs) -> dict:
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    return named


def _group_ranks(named: dict) -> list:
    """The global ranks of a collective's process group."""
    if "process_group" in named:
        pg = named["process_group"]
        if isinstance(pg, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(pg)
        return dist.get_process_group_ranks(pg)
    if "group_name" in named:
        from torch.distributed.distributed_c10d import (
            _resolve_process_group,
        )
        return dist.get_process_group_ranks(
            _resolve_process_group(named["group_name"]))
    raise ValueError(f"no process group among {sorted(named)}")


def ring_moved_bytes(kind: str, operand_bytes: int, result_bytes: int,
                     n: int) -> float:
    """Per-device bytes a collective moves, by the ring model of
    ``roofline._collective_record``."""
    if kind == "all-reduce":
        return 2.0 * operand_bytes * (n - 1) / max(n, 1)
    if kind == "all-gather":
        return result_bytes * (n - 1) / max(n, 1)
    if kind in ("reduce-scatter", "all-to-all"):
        return operand_bytes * (n - 1) / max(n, 1)
    return float(operand_bytes)     # collective-permute


def _operands(named: dict):
    """A collective's input and output tensors (none named as outputs:
    in place, or the operator's result)."""
    ins = [named[k] for k in ("tensors", "input_tensors", "input_tensor",
                              "input", "inputs") if k in named]
    outs = [named[k] for k in ("output_tensors", "output_tensor", "output")
            if k in named]
    return ins, outs


class _Recorder(TorchDispatchMode):
    """Bytes, per-operator FLOPs and collectives of every operator that
    runs under it (the local ops of the program; DTensor-level calls are
    not compute and are passed through)."""

    def __init__(self, chips_per_pod: int, keep_ops: bool):
        super().__init__()
        self.chips_per_pod = chips_per_pod
        self.hbm_bytes = 0.0
        self.collectives: list[CollectiveRecord] = []
        self.dots: list[tuple[float, str]] = []
        self.ops: Optional[list[str]] = [] if keep_ops else None
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # DTensor runs its local ops under us
        out = func(*args, **kwargs)
        name = str(func)
        self.n_ops += 1
        if self.ops is not None:
            self.ops.append(f"{name} {_shapes(out)} <- {_shapes(args)}")
        kind = _kind(name) if func.namespace in (
            "c10d", "_c10d_functional") else None
        if kind is not None:
            self._collective(func, args, kwargs, out, kind, name)
            return out
        if func.namespace in ("c10d", "prim") or func.is_view \
                or name in _FREE:
            return out
        self.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            flops = count(*args, **kwargs, out_val=out)
            if flops:
                self.dots.append((float(flops), f"{name}#{self.n_ops}"))
        return out

    def _collective(self, func, args, kwargs, out, kind, name):
        named = _arguments(func, args, kwargs)
        ins, outs = _operands(named)
        operand = _nbytes(ins)
        result = _nbytes(outs) if outs else (
            _nbytes(ins) if func.namespace == "c10d" else _nbytes(out))
        ranks = _group_ranks(named)
        n = len(ranks)
        pods = {r // self.chips_per_pod for r in ranks}
        self.collectives.append(CollectiveRecord(
            kind, operand, ring_moved_bytes(kind, operand, result, n), n,
            len(pods) > 1, 1.0, f"{name}#{self.n_ops}"))
        self.hbm_bytes += operand + result


def _shapes(x) -> str:
    return str([tuple(t.shape) for t in tree_flatten(x)[0]
                if isinstance(t, torch.Tensor)])


# ---------------------------------------------------------------------------
# The analysis
# ---------------------------------------------------------------------------


def trace_device() -> str:
    """The device of a trace's fake tensors: ``cuda`` on a host with
    CUDA, else ``meta`` (to be traced inside ``card_program("meta")``)."""
    return "cuda" if torch.cuda.is_available() else "meta"


def card_trace(device: str):
    """The context of a trace on fake tensors of ``device``: the card's
    path for meta tensors, nothing for CUDA ones."""
    from repro_torch.kernels import ops
    return (ops.card_program(device) if device != "cuda"
            else contextlib.nullcontext())


def trace_program(step_fn: Callable, *inputs, chips_per_pod: int = 256,
                  keep_top: int = 40, keep_ops: bool = False):
    """Run ``step_fn(*inputs)`` once under the counters; returns (the
    analysis, the step's outputs, the recorder: every collective in
    ``collectives``, every counted product in ``dots``, and with
    ``keep_ops`` the operator list in ``ops``).  Fake inputs give a trace
    without launches (call it inside the ``FakeTensorMode`` that made
    them); real ones run the step."""
    rec = _Recorder(chips_per_pod, keep_ops)
    with FlopCounterMode(display=False) as flops, rec:
        out = step_fn(*inputs)
    a = HLOAnalysis()
    a.flops = float(flops.get_total_flops())
    a.hbm_bytes = rec.hbm_bytes
    for c in rec.collectives:
        a.collective_operand_bytes += c.operand_bytes * c.mult
        if c.crosses_pod:
            a.dcn_bytes += c.moved_bytes
        else:
            a.ici_bytes += c.moved_bytes
    a.dots = sorted(rec.dots, reverse=True)[:keep_top]
    a.collectives = sorted(rec.collectives,
                           key=lambda c: -c.moved_bytes)[:keep_top]
    return a, out, rec


def analyze_program(step_fn: Callable, *inputs, chips_per_pod: int = 256,
                    keep_top: int = 40) -> HLOAnalysis:
    """The per-device analysis of one call of ``step_fn`` on ``inputs``
    (fake tensors of :func:`trace_device`, DTensors of them, and plain
    Python values), inside ``FakeTensorMode`` and :func:`card_trace`."""
    return trace_program(step_fn, *inputs, chips_per_pod=chips_per_pod,
                         keep_top=keep_top)[0]
