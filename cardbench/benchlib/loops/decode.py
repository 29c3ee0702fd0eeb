"""Decode: sessions of ``batch`` rows that keep generating against a long
history, through the decode bundle's ``serve_step``.

The history is each mixer's decode state (``layers/<kind>.py``
``history``: attention's a cache of ``cache_len`` positions per row), in
the port's layouts, drawn from the seed in set-up: a decode step's work
does not depend on its values.  A request is the batch's rows decoding
``new_tokens`` greedy tokens at positions ``history`` .. ``history +
new_tokens - 1``, from first tokens drawn from the seed; each step is
timed until its tokens are on the host.  The next request reuses the
history: attention's steps write the same positions again before they
read them, and state that a step overwrites in place (a kind's
``CARRIED``) is put back before each request, so each is a new session
with the same length.  Set-up warms ``WARMUP_STEPS`` steps.  The check
samples ``SAMPLE_ROWS`` (request, row) pairs, one row from each of as
many equal parts of the batch: the first half from the last finished
request, whose state at the new positions (attention's K and V) is still
in the cache and is kept, the rest from requests drawn from the seed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchlib import compare, kinds, port, weights, work

WARMUP_STEPS = 4
SAMPLE_ROWS = 4


class Loop:
    unit = "step"

    def __init__(self, run):
        self.run = run
        c, t = run.config, run.traffic
        self.V = c["vocab_size"]
        self.B, self.hist = t["batch"], t["history"]
        self.cache_len, self.T = t["cache_len"], t["new_tokens"]
        if self.hist + self.T > self.cache_len:
            raise ValueError(f"{run.traffic['name']}: history {self.hist} and "
                             f"{self.T} new tokens exceed the cache's "
                             f"{self.cache_len} positions")
        self.attempted = self.failed = self.units = 0
        self.window_s = 0.0
        self.itl, self.host_s, self.steps = [], [], []   # steps: positions
        self.layers = kinds.layers(c)
        self.per_unit = kinds.launches(c, "decode")
        self.requests = []          # (first tokens (B,), served (T, B))

    def setup(self):
        run, c = self.run, self.run.config
        views = weights.make(c, run.seed, run.device)
        self.model = port.bind_model(run.arch, c, views)
        self.bundle = port.step_bundle(run.arch, run.cell.name,
                                       self.cache_len, self.B, "decode")
        states = [layer.mixer.history(c, run.seed, layer.index, self.B,
                                      self.cache_len, run.device)
                  for layer in self.layers]
        self.cache = port.cache_from(run.arch, c, states, self.cache_len)
        self.carried = [(t, t.clone()) for layer, st in
                        zip(self.layers, states) for k, t in st.items()
                        if k in layer.mixer.CARRIED]
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
            cache = port.map_cache(cache, torch.clone)
        t0 = time.perf_counter()
        if fault == "half_batch":
            half = port.map_cache(cache, lambda t: t[:B // 2])
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
        for t, history in self.carried:
            t.copy_(history)
        for i in range(self.T):
            pos = self.hist + i
            t0 = time.perf_counter()
            tok, served[i], fin = self.step(
                tok, pos, alter=self.run.fault == "altered" and i == 1)
            self.itl.append(time.perf_counter() - t0)
            self.host_s.append(self.call_s)
            self.steps.append(pos)
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
        c = self.run.config
        each = {pos: work.least_s(*work.decode_step(c, self.B, pos), pk)
                for pos in set(self.steps)}
        return sum(each[pos] for pos in self.steps)

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
        new = slice(self.hist, self.hist + self.T)
        state = {}
        for layer in self.layers:
            got = layer.mixer.port_decode(port.layer_state(self.cache, layer),
                                          rows, new)
            state[layer.index] = {k: t.cpu() for k, t in got.items()}
        return {"pairs": pairs,
                "served": torch.tensor(np.stack(
                    [self.requests[r][1][:, row] for r, row, _ in pairs])),
                "first": torch.tensor(
                    [int(self.requests[r][0][row]) for r, row, _ in pairs]),
                "state": state}

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

        def history(i):
            mixer = self.layers[i].mixer
            return mixer.ref_history(mixer.history(
                c, run.seed, i, self.B, self.cache_len, dev), rows, self.hist)

        w = weights.make(c, run.seed, dev)
        with plain.float32_products():
            logits, state = run.reference.extend(w, c, tokens, self.hist,
                                                 history, lp)
        keep = [i for i, (_, _, kv) in enumerate(pairs) if kv]
        out = {"logits": logits.cpu(), "served": logits.argmax(-1).cpu(),
               "state": {i: {k: t[keep].cpu() for k, t in s.items()}
                         for i, s in state.items()}}
        del w, logits, state
        port.release()
        return out

    def compare(self, prog: dict, ref: dict) -> dict:
        """gap: the widest gap by which a served token's reference logit
        lies below the reference's best at its position; the mixers'
        checks of the rows still in the cache (kv_err: K and V of each
        attention layer at the new positions), max |prog - ref| over the
        reference's root mean square."""
        return {
            "gap": compare.logit_gap(ref["logits"], prog["served"]),
            **compare.state_errs(self.layers,
                                 [(prog["state"], ref["state"])]),
        }
