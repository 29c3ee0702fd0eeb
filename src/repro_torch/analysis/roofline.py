"""Roofline analysis from post-SPMD HLO text (DESIGN.md §7).

``jax``'s ``compiled.cost_analysis()`` counts ``while`` bodies **once**
(verified empirically), so scanned-layer programs would be understated by
``n_groups × microbatches``.  This module parses the compiled HLO text
instead:

- builds the computation table with per-computation symbol tables
  (op name → shape), so operand shapes of referenced values are known;
- extracts ``while`` trip counts from the ``known_trip_count``
  backend_config and propagates execution multipliers through the call
  graph (while bodies, calls, conditionals);
- FLOPs: 2·batch·M·N·K per ``dot`` (from contracting/batch dims);
- HBM traffic: Σ (operand + result bytes) over data-moving top-level ops
  (fusion boundaries = HBM round-trips; get-tuple-element/bitcast/tuple
  are free);
- collective bytes: ring-model per-device moved bytes per op, classified
  ICI vs DCN by whether the replica group crosses the pod boundary
  (device ids differing in ``id // chips_per_pod``), including iota-form
  ``replica_groups=[G,N]<=[dims]T(perm)``.

All shapes in post-SPMD HLO are per-device shards, so every total here is
*per chip*; the roofline terms divide by per-chip peaks directly.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.netem import (
    DCN_BW, HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
)

CHIPS_PER_HOST = 8          # one DGX H100 host: DCN bandwidth is per host

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "token": 0,
    "f4e2m1fn": 1, "f8e8m0fnu": 1, "f8e3m4": 1, "f8e4m3": 1,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

# ops that move no data / are metadata-only
_FREE_OPS = {
    "get-tuple-element", "tuple", "bitcast", "parameter", "constant",
    "after-all", "partition-id", "replica-id", "domain", "opt-barrier",
    "get-dimension-size",
}

# HBM-traffic model (DESIGN.md §7): ops that materialize buffers on the
# accelerator.  CPU HLO leaves long elementwise chains unfused; on the
# accelerator those fuse into their consumers, so plain elementwise/
# convert/broadcast/slice ops are *not* counted — their bytes surface as
# the consumers' operand reads.
_BYTES_OPS = {
    "fusion", "dot", "convolution", "copy", "dynamic-slice",
    "dynamic-update-slice", "gather", "scatter", "reduce", "reduce-window",
    "sort", "concatenate", "pad", "rng", "rng-bit-generator",
    "transpose", "reverse", "select-and-scatter", "custom-call",
    "cholesky", "triangular-solve", "fft", "while", "conditional", "call",
}
# while/conditional/call: only their operand/result tuples are "moved"
# once per entry (loop-carried state stays resident); counted with mult of
# the *caller*, which is what the loop below does naturally.

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def _shape_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) HLO type string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str) -> Optional[tuple[str, list[int]]]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return None
    dt, dims = m.groups()
    return dt, [int(d) for d in dims.split(",") if d]


@dataclass
class Op:
    name: str
    kind: str
    type_str: str
    operands: list[str]
    attrs: str
    line: str


@dataclass
class Computation:
    name: str
    ops: dict[str, Op] = field(default_factory=dict)
    order: list[str] = field(default_factory=list)
    params: dict[str, str] = field(default_factory=dict)   # name -> type
    root: Optional[str] = None


_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*((?:\([^=]*?\)|[a-z0-9]+\[[0-9,]*\](?:{[^}]*})?))\s*"
    r"([\w\-]+)\((.*)$")
_OPERAND_RE = re.compile(r"%([\w\.\-]+)")


def _split_top_commas(s: str) -> list[str]:
    out, depth, start = [], 0, 0
    for i, ch in enumerate(s):
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(s[start:i])
            start = i + 1
    out.append(s[start:])
    return out


def _try_header(line: str) -> Optional[tuple[str, dict[str, str]]]:
    """Parse a computation header line (handles tuple-typed params)."""
    s = line.strip()
    if not s.endswith("{") or " -> " not in s or " = " in s:
        return None
    if s.startswith("ENTRY "):
        s = s[len("ENTRY "):]
    m = re.match(r"%?([\w\.\-]+)\s*\(", s)
    if not m:
        return None
    name = m.group(1)
    try:
        inner = s[s.index("(") + 1:s.rindex(") ->")]
    except ValueError:
        return name, {}
    params: dict[str, str] = {}
    for piece in _split_top_commas(inner):
        if ":" in piece:
            pname, ptype = piece.split(":", 1)
            ptype = re.sub(r"/\*[^*]*\*/", "", ptype)
            params[pname.strip().lstrip("%")] = ptype.strip()
    return name, params


_COMMENT_RE = re.compile(r"/\*.*?\*/")


def parse_hlo(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        line = _COMMENT_RE.sub("", line)
        if cur is None:
            hdr = _try_header(line)
            if hdr:
                cur = Computation(hdr[0])
                cur.params = hdr[1]
                comps[cur.name] = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _OP_RE.match(line)
        if not m:
            continue
        name, type_str, kind, rest = m.groups()
        # operands = %refs before the first "), attr" boundary
        depth = 1
        end = 0
        for i, ch in enumerate(rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        operand_str = rest[:end]
        attrs = rest[end + 1:]
        operands = _OPERAND_RE.findall(operand_str)
        op = Op(name, kind, type_str, operands, attrs, line)
        cur.ops[name] = op
        cur.order.append(name)
        if line.lstrip().startswith("ROOT"):
            cur.root = name
    return comps


# ---------------------------------------------------------------------------
# Execution multipliers (while trip counts through the call graph)
# ---------------------------------------------------------------------------

_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_CALLED_SINGLE = re.compile(
    r"(?:condition|body|calls|to_apply|true_computation|"
    r"false_computation)=%?([\w\.\-]+)")
_CALLED_BRACE = re.compile(r"(?:calls|branch_computations)=\{([^}]*)\}")


def _called_computations(attrs: str) -> list[str]:
    out = [m.group(1) for m in _CALLED_SINGLE.finditer(attrs)]
    for m in _CALLED_BRACE.finditer(attrs):
        out.extend(x.strip().lstrip("%") for x in m.group(1).split(","))
    return out


def computation_multipliers(comps: dict[str, Computation],
                            entry: str) -> dict[str, float]:
    """Execution count per computation, propagated in topological order.

    While bodies multiply by ``known_trip_count``; calls/fusions/branches
    inherit the caller's count (branches are counted as taken — an upper
    bound for conditionals, which the step programs here don't use).
    """
    if entry not in comps:
        cands = [c for c in comps if c.startswith("main")]
        entry = cands[0] if cands else next(iter(comps))
    edges: dict[str, list[tuple[str, float]]] = {}
    for cname, comp in comps.items():
        lst: list[tuple[str, float]] = []
        for op in comp.ops.values():
            called = _called_computations(op.attrs)
            if not called:
                continue
            factor = 1.0
            if op.kind == "while":
                tm = _TRIP_RE.search(op.attrs)
                factor = float(tm.group(1)) if tm else 1.0
            for c in called:
                if c in comps:
                    lst.append((c, factor))
        edges[cname] = lst
    # iterative DFS postorder from entry → topological order (HLO is a DAG)
    order: list[str] = []
    seen: set[str] = set()
    stack: list[tuple[str, bool]] = [(entry, False)]
    while stack:
        node, processed = stack.pop()
        if processed:
            order.append(node)
            continue
        if node in seen:
            continue
        seen.add(node)
        stack.append((node, True))
        for n, _ in edges.get(node, ()):
            if n not in seen:
                stack.append((n, False))
    mult: dict[str, float] = {c: 0.0 for c in comps}
    mult[entry] = 1.0
    for c in reversed(order):       # callers before callees
        for n, f in edges.get(c, ()):
            mult[n] += mult[c] * f
    return mult


# ---------------------------------------------------------------------------
# Per-op costs
# ---------------------------------------------------------------------------


def _dot_flops(op: Op, comp: Computation) -> float:
    """2*B*M*N*K for a dot given operand shapes + dim numbers."""
    def operand_type(i: int) -> Optional[str]:
        if i >= len(op.operands):
            return None
        ref = op.operands[i]
        if ref in comp.ops:
            return comp.ops[ref].type_str
        return comp.params.get(ref)

    lhs_t, rhs_t = operand_type(0), operand_type(1)
    if lhs_t is None or rhs_t is None:
        # fall back: 2 * result elements * guessed K is unsafe; use result*2
        return 2.0 * _shape_bytes(op.type_str)
    lhs = _shape_dims(lhs_t)
    rhs = _shape_dims(rhs_t)
    if lhs is None or rhs is None:
        return 0.0
    _, ldims = lhs
    _, rdims = rhs

    def dims_of(attr: str) -> list[int]:
        m = re.search(attr + r"=\{([0-9,]*)\}", op.attrs)
        if not m or not m.group(1):
            return []
        return [int(x) for x in m.group(1).split(",")]

    lc = dims_of("lhs_contracting_dims")
    lb = dims_of("lhs_batch_dims")
    K = math.prod(ldims[i] for i in lc) if lc else 1
    Bk = math.prod(ldims[i] for i in lb) if lb else 1
    M = math.prod(d for i, d in enumerate(ldims) if i not in lc + lb)
    rc = dims_of("rhs_contracting_dims")
    rb = dims_of("rhs_batch_dims")
    N = math.prod(d for i, d in enumerate(rdims) if i not in rc + rb)
    return 2.0 * Bk * M * N * K


def _operand_type(comp: Computation, ref: str) -> Optional[str]:
    if ref in comp.ops:
        return comp.ops[ref].type_str
    return comp.params.get(ref)


def _op_bytes(op: Op, comp: Computation) -> int:
    """HBM traffic model: operands read + results written.

    In-place ops are special-cased: a dynamic-update-slice only writes
    the update region; a dynamic-slice only reads the slice.
    """
    if op.kind == "dynamic-slice":
        return 2 * _shape_bytes(op.type_str)
    if op.kind == "dynamic-update-slice":
        upd = _operand_type(comp, op.operands[1]) \
            if len(op.operands) > 1 else None
        return 2 * _shape_bytes(upd or op.type_str)
    total = _shape_bytes(op.type_str)
    for ref in op.operands:
        t = _operand_type(comp, ref)
        if t:
            total += _shape_bytes(t)
    return total


_PARAM_IDX_RE = re.compile(r"parameter\((\d+)\)")


def _fusion_bytes(op: Op, comp: Computation,
                  comps: dict[str, Computation]) -> int:
    """Traffic of a fusion: slice-aware reads, in-place-DUS-aware writes.

    A fused-computation parameter consumed only through dynamic-slice ops
    contributes its sliced bytes (scan bodies read xs[t], not all of xs);
    a fusion rooted in dynamic-update-slice writes only the update region
    and does not read its aliased target buffer.
    """
    called = _called_computations(op.attrs)
    fc = comps.get(called[0]) if called else None
    if fc is None or fc.root is None:
        return _op_bytes(op, comp)
    consumers: dict[str, list[Op]] = {}
    for o in fc.ops.values():
        for r in o.operands:
            consumers.setdefault(r, []).append(o)
    root = fc.ops[fc.root]
    total = 0
    if root.kind == "dynamic-update-slice" and len(root.operands) > 1:
        upd_t = _operand_type(fc, root.operands[1])
        total += _shape_bytes(upd_t or root.type_str)
    else:
        total += _shape_bytes(op.type_str)
    for o in fc.ops.values():
        if o.kind != "parameter":
            continue
        uses = consumers.get(o.name, [])
        if uses and all(u.kind == "dynamic-slice" for u in uses):
            total += sum(_shape_bytes(u.type_str) for u in uses)
        elif (root.kind == "dynamic-update-slice" and len(uses) == 1
              and uses[0] is root and root.operands
              and root.operands[0] == o.name):
            pass      # aliased in-place target: not read
        else:
            total += _shape_bytes(o.type_str)
    return total


# --- replica groups ---------------------------------------------------------

_GROUPS_BRACE = re.compile(r"replica_groups=\{\{([^}]*(?:\},\{[^}]*)*)\}\}")
_GROUPS_IOTA = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([0-9,]+)\](?:T\(([0-9,]+)\))?")


def _parse_groups(attrs: str) -> Optional[np.ndarray]:
    m = _GROUPS_IOTA.search(attrs)
    if m:
        g, n, dims, perm = m.groups()
        dims = [int(x) for x in dims.split(",")]
        ids = np.arange(math.prod(dims)).reshape(dims)
        if perm:
            ids = ids.transpose([int(x) for x in perm.split(",")])
        return ids.reshape(int(g), int(n))
    m = _GROUPS_BRACE.search(attrs)
    if m:
        rows = m.group(1).split("},{")
        out = [[int(x) for x in row.split(",") if x] for row in rows]
        width = max(len(r) for r in out)
        if any(len(r) != width for r in out):
            return None
        return np.asarray(out)
    return None


@dataclass
class CollectiveRecord:
    kind: str
    operand_bytes: int
    moved_bytes: float        # ring-model per-device bytes
    group_size: int
    crosses_pod: bool
    mult: float
    name: str


def _collective_record(op: Op, comp: Computation, mult: float,
                       chips_per_pod: int) -> CollectiveRecord:
    operand_bytes = sum(
        _shape_bytes(comp.ops[r].type_str if r in comp.ops
                     else comp.params.get(r, ""))
        for r in op.operands)
    result_bytes = _shape_bytes(op.type_str)
    groups = _parse_groups(op.attrs)
    n = int(groups.shape[1]) if groups is not None else 1
    crosses = False
    if groups is not None and groups.size:
        crosses = bool(np.any(groups // chips_per_pod
                              != groups[:, :1] // chips_per_pod))
    kind = op.kind
    if kind.startswith("all-reduce"):
        moved = 2.0 * operand_bytes * (n - 1) / max(n, 1)
    elif kind.startswith("all-gather"):
        moved = result_bytes * (n - 1) / max(n, 1)
    elif kind.startswith("reduce-scatter"):
        moved = operand_bytes * (n - 1) / max(n, 1)
    elif kind.startswith("all-to-all"):
        moved = operand_bytes * (n - 1) / max(n, 1)
    else:   # collective-permute
        moved = operand_bytes
    return CollectiveRecord(kind, operand_bytes, moved * mult, n, crosses,
                            mult, op.name)


# ---------------------------------------------------------------------------
# Whole-module analysis
# ---------------------------------------------------------------------------


@dataclass
class HLOAnalysis:
    flops: float = 0.0                       # per device
    hbm_bytes: float = 0.0                   # per device
    ici_bytes: float = 0.0                   # per device, ring-moved
    dcn_bytes: float = 0.0
    collective_operand_bytes: float = 0.0
    collectives: list = field(default_factory=list)
    dots: list = field(default_factory=list)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["collectives"] = [dataclasses.asdict(c) if not isinstance(c, dict)
                            else c for c in self.collectives]
        return d


def analyze_hlo(text: str, *, chips_per_pod: int = 256,
                entry: Optional[str] = None,
                keep_top: int = 40) -> HLOAnalysis:
    comps = parse_hlo(text)
    entry_name = entry
    if entry_name is None:
        m = re.search(r"^ENTRY\s+%?([\w\.\-]+)", text, re.M)
        entry_name = m.group(1) if m else "main"
    mult = computation_multipliers(comps, entry_name)
    out = HLOAnalysis()
    dot_costs = []
    for cname, comp in comps.items():
        f = mult.get(cname, 0.0)
        if f <= 0:
            continue
        for op in comp.ops.values():
            if op.kind in _FREE_OPS:
                continue
            if op.kind.startswith(_COLLECTIVES):
                rec = _collective_record(op, comp, f, chips_per_pod)
                out.collectives.append(rec)
                out.collective_operand_bytes += rec.operand_bytes * f
                if rec.crosses_pod:
                    out.dcn_bytes += rec.moved_bytes
                else:
                    out.ici_bytes += rec.moved_bytes
                out.hbm_bytes += _op_bytes(op, comp) * f
                continue
            if op.kind in ("dot", "convolution"):
                fl = _dot_flops(op, comp) * f
                out.flops += fl
                dot_costs.append((fl, f"{cname}/{op.name}"))
            if op.kind in _BYTES_OPS:
                if op.kind == "fusion":
                    out.hbm_bytes += _fusion_bytes(op, comp, comps) * f
                else:
                    out.hbm_bytes += _op_bytes(op, comp) * f
    dot_costs.sort(reverse=True)
    out.dots = dot_costs[:keep_top]
    out.collectives.sort(key=lambda c: -c.moved_bytes)
    out.collectives = out.collectives[:keep_top]
    return out


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


@dataclass
class RooflineReport:
    t_compute: float
    t_memory: float
    t_ici: float
    t_dcn: float
    bottleneck: str
    model_flops_per_device: float
    useful_ratio: float          # MODEL_FLOPS / HLO_FLOPs
    roofline_fraction: float     # T_bound / max(all terms)

    @property
    def t_collective(self) -> float:
        return self.t_ici + self.t_dcn

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["t_collective"] = self.t_collective
        return d


def roofline_terms(analysis: HLOAnalysis, *, model_flops_total: float,
                   n_chips: int) -> RooflineReport:
    t_c = analysis.flops / PEAK_FLOPS_BF16
    t_m = analysis.hbm_bytes / HBM_BW
    t_i = analysis.ici_bytes / ICI_BW
    t_d = analysis.dcn_bytes / (DCN_BW / CHIPS_PER_HOST)
    terms = {"compute": t_c, "memory": t_m, "ici": t_i, "dcn": t_d}
    bottleneck = max(terms, key=terms.get)
    model_per_dev = model_flops_total / n_chips
    useful = model_per_dev / analysis.flops if analysis.flops else 0.0
    # fraction of roofline: time the compute-bound ideal would take over
    # the actual bound term (1.0 = perfectly compute-bound at peak)
    ideal = model_per_dev / PEAK_FLOPS_BF16
    frac = ideal / max(max(terms.values()), 1e-30)
    return RooflineReport(t_c, t_m, t_i, t_d, bottleneck, model_per_dev,
                          useful, frac)
