"""Decode: sessions of ``batch`` rows that keep generating against a long
history, through the decode bundle's ``serve_step``.

The history is a cache of ``cache_len`` positions per row (the port's
layouts, in ``cache_dtype``) drawn from the seed in set-up: a decode
step's work does not depend on its values.  A request is the batch's
rows decoding ``new_tokens`` greedy tokens at positions ``history`` ..
``history + new_tokens - 1``, from first tokens drawn from the seed;
each step is timed until its tokens are on the host.  The next request
reuses the history: its steps write the same positions again before they
read them, so each is a new session with the same length.  Set-up warms
``WARMUP_STEPS`` steps.  The check samples ``SAMPLE_ROWS`` (request,
row) pairs, one row from each of as many equal parts of the batch: the
first half from the last finished request, whose K and V at the new
positions are still in the cache and are kept, the rest from requests
drawn from the seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import compare, port, weights, work

WARMUP_STEPS = 4
SAMPLE_ROWS = 4


class Loop:
    unit = "step"

    def __init__(self, run):
        self.run = run
        c, t = run.config, run.traffic
        self.V, self.L = c["vocab_size"], c["num_hidden_layers"]
        self.B, self.hist = t["batch"], t["history"]
        self.cache_len, self.T = t["cache_len"], t["new_tokens"]
        if self.hist + self.T > self.cache_len:
            raise ValueError(f"{run.traffic['name']}: history {self.hist} and "
                             f"{self.T} new tokens exceed the cache's "
                             f"{self.cache_len} positions")
        self.attempted = self.failed = self.units = 0
        self.window_s = 0.0
        self.itl, self.host_s, self.works = [], [], []
        self.per_unit = {"flash_decode": self.L}
        self.requests = []          # (first tokens (B,), served (T, B))

    def setup(self):
        run, c = self.run, self.run.config
        views = weights.make(c, run.seed, run.device)
        self.model = port.bind_model(run.arch, c, views)
        self.bundle = port.step_bundle(run.arch, run.cell.name,
                                       self.cache_len, self.B, "decode")
        self.cache = port.cache_from(run.arch, [
            (weights.history_layer(c, run.seed, g, "k", self.B,
                                   self.cache_len, run.device),
             weights.history_layer(c, run.seed, g, "v", self.B,
                                   self.cache_len, run.device))
            for g in range(self.L)])
        tok = self._first(-1)
        for i in range(WARMUP_STEPS):
            tok, _, _ = self.step(tok, self.hist + i)

    def _first(self, r: int) -> torch.Tensor:
        ids = weights.rng(self.run.seed, 9, r + 1).integers(
            0, self.V, self.B)
        return torch.from_numpy(ids).to(self.run.device)[:, None]

    def step(self, tok, pos: int, alter: bool = False):
        """One decode step of every row: (next tokens (B, 1) on the device,
        the same on the host, whether the logits are finite)."""
        fault, B = self.run.fault, self.B
        cache = self.cache
        if fault == "unchanged":
            cache = [{"l0": {"mixer": {k: t.clone() for k, t in
                                       g["l0"]["mixer"].items()}}}
                     for g in cache]
        t0 = time.perf_counter()
        if fault == "half_batch":
            half = [{"l0": {"mixer": {k: t[:B // 2] for k, t in
                                      g["l0"]["mixer"].items()}}}
                    for g in cache]
            logits, _ = self.bundle.step_fn(self.model, half, tok[:B // 2],
                                            pos)
        else:
            logits, _ = self.bundle.step_fn(self.model, cache, tok, pos)
        self.call_s = time.perf_counter() - t0
        nxt = logits[:, -1].argmax(-1)
        if fault == "half_batch":
            nxt = torch.cat([nxt, tok[B // 2:, 0]])
        if alter:
            nxt = (nxt + 1) % self.V
        host = torch.cat([nxt, torch.isfinite(logits).all().long()[None]])
        host = host.cpu().numpy()
        return nxt[:, None], host[:B], bool(host[B])

    def request(self, r: int) -> bool:
        first = self._first(r)
        tok, ok = first, True
        served = np.empty((self.T, self.B), dtype=np.int64)
        c = self.run.config
        for i in range(self.T):
            pos = self.hist + i
            t0 = time.perf_counter()
            tok, served[i], fin = self.step(
                tok, pos, alter=self.run.fault == "altered" and i == 1)
            self.itl.append(time.perf_counter() - t0)
            self.host_s.append(self.call_s)
            self.works.append(work.decode_step(c, self.B, pos))
            ok &= fin
        self.units += self.T
        self.requests.append((first[:, 0].cpu().numpy(), served))
        return ok

    def window(self, seconds: float):
        t0 = time.perf_counter()
        while True:
            self.failed += not self.request(len(self.requests))
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.attempted = len(self.requests)

    def e2e(self) -> dict:
        return {"decode_tokens_per_s": self.units * self.B / self.window_s,
                "itl_p95_ms": float(np.percentile(self.itl, 95)) * 1e3}

    def least_s(self, pk) -> float:
        return sum(work.least_s(f, b, pk) for f, b in self.works)

    # --- the check ----------------------------------------------------------

    def sample(self) -> list:
        """(request, row, whether its K/V are kept) pairs."""
        R, n = SAMPLE_ROWS, len(self.requests)
        g = weights.rng(self.run.seed, 10)
        part = self.B // R
        out = []
        for i in range(R):
            row = i * part + int(g.integers(part))
            last = i < R // 2
            out.append((n - 1 if last else int(g.integers(n)), row, last))
        return out

    def kept(self) -> dict:
        pairs = self.sample()
        rows = [row for _, row, kv in pairs if kv]
        sl = slice(self.hist, self.hist + self.T)
        k = torch.stack([g["l0"]["mixer"]["k"][rows][..., sl]
                         .permute(0, 3, 1, 2) for g in self.cache])
        v = torch.stack([g["l0"]["mixer"]["v"][rows][:, :, sl]
                         .permute(0, 2, 1, 3) for g in self.cache])
        return {"pairs": pairs,
                "served": torch.tensor(np.stack(
                    [self.requests[r][1][:, row] for r, row, _ in pairs])),
                "first": torch.tensor(
                    [int(self.requests[r][0][row]) for r, row, _ in pairs]),
                "k": k.cpu(), "v": v.cpu()}

    def release(self):
        del self.model, self.bundle, self.cache
        port.release()

    def reference(self, lp, prog: dict) -> dict:
        """The reference over each sampled row's first token and served
        tokens, after its history (drawn again from the seed)."""
        run, c = self.run, self.run.config
        from reference import plain
        pairs, dev = prog["pairs"], run.device
        rows = torch.tensor([row for _, row, _ in pairs], device=dev)
        tokens = torch.cat([prog["first"][:, None],
                            prog["served"][:, :-1]], 1).to(dev)

        def history(g):
            out = []
            for kind, perm in (("k", (0, 3, 1, 2)), ("v", (0, 2, 1, 3))):
                t = weights.history_layer(c, run.seed, g, kind, self.B,
                                          self.cache_len, dev)
                t = t[rows].permute(*perm)[:, :self.hist].float()
                out.append(t)
            return tuple(out)

        w = weights.make(c, run.seed, dev)
        with plain.float32_products():
            logits, k, v = run.reference.extend(w, c, tokens, self.hist,
                                                history, lp)
        keep = [i for i, (_, _, kv) in enumerate(pairs) if kv]
        out = {"logits": logits.cpu(), "served": logits.argmax(-1).cpu(),
               "k": k[:, keep].cpu(), "v": v[:, keep].cpu()}
        del w, logits, k, v
        port.release()
        return out

    def compare(self, prog: dict, ref: dict) -> dict:
        """gap: the widest gap by which a served token's reference logit
        lies below the reference's best at its position; kv_err: K and V
        of each layer at the new positions of the rows still in the cache,
        max |prog - ref| over the reference's root mean square."""
        L = ref["k"].shape[0]
        return {
            "gap": compare.logit_gap(ref["logits"], prog["served"]),
            "kv_err": max(compare.max_rel(prog[kind][g], ref[kind][g])
                          for kind in ("k", "v") for g in range(L)),
        }
