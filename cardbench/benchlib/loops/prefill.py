"""Prefill: a closed loop of one client, each request one prompt through
the prefill bundle and its first token's id on the host.

The prompt lengths are a fixed set (``lengths``: ``count`` values spaced
evenly in log between ``min`` and ``max``, multiples of ``multiple``),
the same for every seed; each cycle sends all of them once, in an order
drawn from the seed, with ids drawn uniformly over the vocabulary.  The
window runs whole cycles, so every run does the same mix of work.
Set-up warms the longest and the shortest length.  The check samples
``SAMPLE_REQUESTS`` requests of the first cycle: the longest, and the
rest drawn from the seed among the shorter half of the lengths, so that
the float32 reference over them takes less time than the window.  It
keeps each one's last-position logits and the K and V the prefill wrote
at ``SAMPLE_POSITIONS`` positions (the first and the last among them;
every position of a shorter prompt).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import compare, port, weights, work

SAMPLE_REQUESTS = 2
SAMPLE_POSITIONS = 64


def lengths(t: dict) -> list[int]:
    lo, hi, n, mult = t["min"], t["max"], t["count"], t["multiple"]
    return [int(round(lo * (hi / lo) ** (i / (n - 1)) / mult)) * mult
            for i in range(n)]


class Loop:
    unit = "request"

    def __init__(self, run):
        self.run = run
        c, t = run.config, run.traffic
        self.V = c["vocab_size"]
        self.lengths = lengths(t["lengths"])
        longest = int(np.argmax(self.lengths))
        shorter = sorted(range(len(self.lengths)),
                         key=self.lengths.__getitem__)[:len(self.lengths) // 2]
        draw = weights.rng(run.seed, 7).choice(
            shorter, SAMPLE_REQUESTS - 1, replace=False)
        self.sample = [longest, *sorted(int(j) for j in draw)]
        self.positions = {j: self._positions(j) for j in self.sample}
        self.attempted = self.failed = self.units = 0
        self.window_s = 0.0
        self.cycles = 0
        self.works = []             # (FLOPs, bytes) of each request
        self.per_unit = {"flash_attention": c["num_hidden_layers"]}
        self.outputs = {}

    def _positions(self, j: int) -> list[int]:
        S = self.lengths[j]
        draw = weights.rng(self.run.seed, 8, j).choice(
            S, min(SAMPLE_POSITIONS, S) - 2, replace=False)
        return sorted({0, S - 1, *(int(p) for p in draw)})

    def order(self, cycle: int):
        return weights.rng(self.run.seed, 5, cycle).permutation(
            len(self.lengths))

    def prompt(self, cycle: int, j: int) -> torch.Tensor:
        ids = weights.rng(self.run.seed, 4, cycle, j).integers(
            0, self.V, self.lengths[j], dtype=np.int32)
        return torch.from_numpy(ids).to(self.run.device)

    def setup(self):
        run, c = self.run, self.run.config
        views = weights.make(c, run.seed, run.device)
        self.model = port.bind_model(run.arch, c, views)
        self.bundle = port.step_bundle(run.arch, run.cell.name,
                                       max(self.lengths), 1, "prefill")
        for S in (max(self.lengths), min(self.lengths)):
            ids = weights.rng(run.seed, 6, S).integers(0, self.V, S,
                                                       dtype=np.int32)
            self.request(torch.from_numpy(ids).to(run.device))

    def request(self, ids, keep=None) -> bool:
        """One prompt; ``keep`` (the request's index in the length set) keeps
        its outputs for the check.  Returns whether its logits are
        finite."""
        logits, cache = self.bundle.step_fn(self.model, ids[None])
        last = logits[0, -1]
        host = torch.stack([last.argmax(),
                            torch.isfinite(last).all().long()]).tolist()
        served = host[0]
        if self.run.fault == "altered":
            served = (served + 1) % self.V
        if keep is not None:
            P = torch.tensor(self.positions[keep], device=ids.device)
            k = torch.stack([g["l0"]["mixer"]["k"][0][:, :, P]
                             .permute(2, 0, 1) for g in cache])
            v = torch.stack([g["l0"]["mixer"]["v"][0][:, P]
                             .permute(1, 0, 2) for g in cache])
            if self.run.fault == "unchanged":
                k, v = torch.zeros_like(k), torch.zeros_like(v)
            self.outputs[keep] = {"served": served, "logits": last.clone(),
                                  "k": k, "v": v}
        return bool(host[1])

    def window(self, seconds: float):
        c = self.run.config
        t0 = time.perf_counter()
        cycle = self.cycles
        self.tokens = 0
        while True:
            for j in self.order(cycle):
                j = int(j)
                keep = j if cycle == 0 and j in self.sample else None
                ok = self.request(self.prompt(cycle, j), keep)
                self.units += 1
                self.failed += not ok
                self.tokens += self.lengths[j]
                self.works.append(work.prefill(c, self.lengths[j]))
            cycle += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.cycles = cycle
        self.window_s = time.perf_counter() - t0
        self.attempted = self.units

    def e2e(self) -> dict:
        return {"prefill_tokens_per_s": self.tokens / self.window_s}

    def least_s(self, pk) -> float:
        return sum(work.least_s(f, b, pk) for f, b in self.works)

    def kept(self) -> dict:
        return {j: {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                    for k, v in o.items()} for j, o in self.outputs.items()}

    def release(self):
        del self.model, self.bundle
        self.outputs = {}
        port.release()

    # --- the reference ------------------------------------------------------

    def reference(self, lp, prog: dict) -> dict:
        run, c = self.run, self.run.config
        from reference import plain
        w = weights.make(c, run.seed, run.device)
        out = {}
        with plain.float32_products():
            for j in self.sample:
                P = torch.tensor(self.positions[j], device=run.device)
                logits, k, v = run.reference.prefill(
                    w, c, self.prompt(0, j), P, lp)
                out[j] = {"served": int(logits.argmax()),
                          "logits": logits.cpu(), "k": k.cpu(),
                          "v": v.cpu()}
        del w
        port.release()
        return out

    def compare(self, prog: dict, ref: dict) -> dict:
        """logit_err: the last position's logits, max |prog - ref| over
        the reference's root mean square; kv_err: the same of K and V of
        each layer at the sampled positions; token_mismatch: requests
        whose first token is not their logits' largest (exact)."""
        return {
            "logit_err": max(compare.max_rel(prog[j]["logits"],
                                             ref[j]["logits"])
                             for j in self.sample),
            "kv_err": max(compare.max_rel(prog[j][kind][g], ref[j][kind][g])
                          for j in self.sample for kind in ("k", "v")
                          for g in range(len(ref[j]["k"]))),
            "token_mismatch": sum(
                prog[j]["served"] != int(prog[j]["logits"].argmax())
                for j in self.sample),
        }
