"""Columnar sweep-result aggregation: tables, stats, fingerprints.

Each sweep row is ``{scenario_id, params, metrics, cached}`` with
``metrics`` produced by :meth:`repro_torch.core.engine.Engine.metrics`.  Every
metric except those in :data:`TIMING_KEYS` is deterministic for a fixed
scenario, so two runs of the same grid — interrupted, resumed, cached,
parallel or serial — must agree on :meth:`SweepResults.fingerprint`;
the resume tests and the CI sweep gate assert exactly that.

Aggregation is columnar (numpy arrays via :meth:`to_columns`) and the
human surface is :meth:`table`: group by the varying grid axes, report
summary stats (mean over the group; p50/p99 latency metrics are already
per-scenario percentiles, so their group mean is a mean-of-percentiles —
documented, not hidden).
"""
from __future__ import annotations

import hashlib
import json
from typing import Optional, Sequence

import numpy as np

# nondeterministic metrics: excluded from fingerprints and CI gates
# (profile_wall is the profiler's wall-clock phase accounting — its
# sibling profile_counts *is* deterministic and stays fingerprinted)
TIMING_KEYS = ("wall_s", "profile_wall")

DEFAULT_METRICS = ("records_produced", "records_delivered",
                   "lost_or_partial", "latency_p50", "latency_p99",
                   "engine_events")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


class SweepResults:
    """Ordered sweep rows + columnar views and summaries."""

    def __init__(self, rows: Sequence[dict], name: str = "") -> None:
        self.rows = list(rows)
        self.name = name

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    @property
    def n_cached(self) -> int:
        return sum(1 for r in self.rows if r.get("cached"))

    # -- columnar access ------------------------------------------------

    def column(self, key: str) -> np.ndarray:
        """One column across rows; params take precedence over metrics."""
        vals = [r["params"].get(key, r["metrics"].get(key))
                for r in self.rows]
        return np.asarray(vals)

    def to_columns(self, keys: Sequence[str]) -> dict[str, np.ndarray]:
        return {k: self.column(k) for k in keys}

    def total(self, key: str):
        """Sum of one numeric metric/param over all rows."""
        return self.column(key).sum().item()

    def varying_params(self) -> list[str]:
        """Param keys that actually vary across rows (grid axes)."""
        if not self.rows:
            return []
        keys: list[str] = []
        for r in self.rows:
            for k in r["params"]:
                if k not in keys:
                    keys.append(k)
        return [k for k in keys
                if len({repr(r["params"].get(k)) for r in self.rows}) > 1]

    # -- aggregation -----------------------------------------------------

    def aggregate(self, group_by: Sequence[str],
                  metrics: Optional[Sequence[str]] = None) -> list[dict]:
        """Group rows by param values; mean of each metric per group."""

        def hashable(v):
            # dict/list-valued params (e.g. generator kwargs) group by
            # their repr; displayed values stay the originals
            try:
                hash(v)
                return v
            except TypeError:
                return repr(v)

        metrics = list(metrics or DEFAULT_METRICS)
        group_by = list(group_by)
        groups: dict[tuple, list[dict]] = {}
        order: list[tuple] = []
        for r in self.rows:
            key = tuple(hashable(r["params"].get(k)) for k in group_by)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(r)
        out = []
        for key in order:
            rows = groups[key]
            rec = {k: rows[0]["params"].get(k) for k in group_by}
            rec["n"] = len(rows)
            for m in metrics:
                # direct indexing: a typo'd metric name must raise, not
                # silently aggregate to 0.0
                vals = np.asarray(
                    [row["metrics"][m] for row in rows], float)
                rec[f"{m}_mean"] = float(vals.mean())
            out.append(rec)
        return out

    def table(self, group_by: Optional[Sequence[str]] = None,
              metrics: Optional[Sequence[str]] = None) -> str:
        """Aligned text table of :meth:`aggregate` (grid axes by default)."""
        if group_by is None:
            group_by = self.varying_params()
        agg = self.aggregate(group_by, metrics)
        if not agg:
            return "(no results)"
        cols = list(agg[0])
        cells = [[_fmt(rec[c]) for c in cols] for rec in agg]
        widths = [max(len(c), max(len(row[i]) for row in cells))
                  for i, c in enumerate(cols)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths)),
                 "  ".join("-" * w for w in widths)]
        for row in cells:
            lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        return "\n".join(lines)

    # -- determinism contract --------------------------------------------

    def deterministic_rows(self) -> list[dict]:
        """Rows stripped of nondeterministic metrics, id-sorted."""
        out = []
        for r in sorted(self.rows, key=lambda r: r["scenario_id"]):
            out.append({
                "scenario_id": r["scenario_id"],
                "params": r["params"],
                "metrics": {k: v for k, v in r["metrics"].items()
                            if k not in TIMING_KEYS},
            })
        return out

    def fingerprint(self) -> str:
        """Hash over deterministic rows: resume/CI equality gate."""
        blob = json.dumps(self.deterministic_rows(), sort_keys=True,
                          default=repr)
        return hashlib.sha256(blob.encode()).hexdigest()

    # -- persistence ------------------------------------------------------

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"name": self.name, "rows": self.rows}, f, indent=2)

    @classmethod
    def load_json(cls, path: str) -> "SweepResults":
        with open(path) as f:
            blob = json.load(f)
        return cls(blob["rows"], name=blob.get("name", ""))
