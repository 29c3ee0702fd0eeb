"""Training: the train bundle's ``step_fn`` back to back on one state.

Set-up binds the benchmark's weights as the model's parameters, builds
the state as the bundle's ``init_fn`` does (zero AdamW moments) with its
step count at the end of the schedule's warm-up, so that every step runs
at the peak learning rate, and runs the first ``CHECK_STEPS`` steps
through the same call and feed as the window, on batches 0, 1, 2 of the
Zipf token stream: they warm every shape and give the check its readings
(each step's loss, the first gradient's norm per leaf from the first
moment after step 1, and after the last of them each leaf's change and
the norms of both moments).  The window goes on from the next batch;
each step ends with its loss on the host.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from benchlib import compare, port, weights, work
from benchlib.synthetic import SyntheticLM

# the share of the median leaf's first gradient under which a leaf moves
# by rounding alone and its change and moments are not compared
STILL = 1e-3
# the steps of set-up whose outputs the check compares
CHECK_STEPS = 3


class Loop:
    unit = "step"

    def __init__(self, run):
        self.run = run
        c, t = run.config, run.traffic
        self.B, self.S = t["batch"], t["seq"]
        self.start = c["optimizer"]["warmup_steps"]
        self.data = SyntheticLM(c["vocab_size"], self.S,
                                seed=weights.seed_of(run.seed, 3),
                                zipf_a=t["zipf_a"])
        self.attempted = self.failed = self.units = 0
        self.window_s = 0.0
        remat = run.arch.remat != "none"
        self.per_unit = {"flash_attention":
                         c["num_hidden_layers"] * (2 if remat else 1)}

    def batch(self, i: int) -> dict:
        b = self.data.batch(i, 0, self.B)
        return {k: torch.from_numpy(v).to(self.run.device)
                for k, v in b.items()}

    def setup(self):
        run, c = self.run, self.run.config
        port.check_optimizer(run.arch, c["optimizer"])
        views = weights.make(c, run.seed, run.device)
        self.model = port.bind_model(run.arch, c, views, trainable=True)
        self.state = {"params": self.model,
                      "opt": port.make_opt_state(run.arch, self.model)}
        self.state["opt"]["step"].fill_(self.start)
        self.bundle = port.step_bundle(run.arch, run.cell.name, self.S,
                                       self.B, "train")
        self.names = list(views)
        del views
        self.losses = []
        with run.faults():
            for i in range(CHECK_STEPS):
                self.losses.append(self.step(i))
                if i == 0:
                    m = self.state["opt"]["m"]
                    self.grad = self._norms(
                        (m[k] for k in self.names),
                        1.0 / (1.0 - c["optimizer"]["b1"]))
        params = dict(self.model.named_parameters())
        start = weights.make(c, run.seed, run.device)
        self.change = self._norms(
            (params[k].detach().float() - start[k].float()
             for k in self.names), 1.0)
        del start
        opt = self.state["opt"]
        self.moments = {k: self._norms((opt[k][n] for n in self.names), 1.0)
                        for k in ("m", "v")}
        self.next = CHECK_STEPS

    def _norms(self, tensors, scale) -> dict:
        """{leaf: norm * scale} of ``tensors`` (an iterable in leaf order,
        each dropped once its norm is taken)."""
        norms = torch.stack([torch.linalg.vector_norm(t.float())
                             for t in tensors]) * scale
        return dict(zip(self.names, norms.tolist()))

    def step(self, i: int) -> float:
        batch = self.batch(i)
        if self.run.fault == "half_batch":
            batch = {k: v[:self.B // 2] for k, v in batch.items()}
        _, out = self.bundle.step_fn(self.state, batch)
        return out["loss"].item()

    def window(self, seconds: float):
        t0 = time.perf_counter()
        with self.run.faults():
            while True:
                loss = self.step(self.next)
                self.next += 1
                self.units += 1
                self.failed += not math.isfinite(loss)
                if time.perf_counter() - t0 >= seconds:
                    break
        self.window_s = time.perf_counter() - t0
        self.attempted = self.units

    def e2e(self) -> dict:
        return {"train_tokens_per_s":
                self.units * self.B * self.S / self.window_s}

    def least_s(self, pk) -> float:
        return self.units * work.least_s(*work.train_step(
            self.run.config, self.B, self.S), pk)

    def kept(self) -> dict:
        return {"losses": self.losses, "grad": self.grad,
                "change": self.change, **self.moments}

    def release(self):
        del self.state, self.model, self.bundle
        port.release()

    # --- the reference ------------------------------------------------------

    def reference(self, lp, prog: dict) -> dict:
        """The configuration's plain reference follows the same first
        steps from the same weights, batches and step count, its
        parameters kept in ``param_dtype`` as the configuration keeps
        them."""
        run, c = self.run, self.run.config
        from reference import plain
        start = weights.make(c, run.seed, run.device)
        p = {k: t.to(torch.float32, copy=True).requires_grad_()
             for k, t in start.items()}
        m = {k: torch.zeros_like(t) for k, t in p.items()}
        v = {k: torch.zeros_like(t) for k, t in p.items()}
        losses = []
        with plain.float32_products():
            for i in range(CHECK_STEPS):
                b = self.batch(i)
                loss, _ = run.reference.train_loss(p, c, b["inputs"],
                                                   b["labels"], lp)
                g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
                losses.append(loss.item())
                scale = plain.adamw_step(p, g, m, v, self.start + i + 1,
                                         c["optimizer"],
                                         weights.DTYPES[c["param_dtype"]])
                if i == 0:
                    grad = self._norms((g[k] * scale for k in self.names),
                                       1.0)
                del g, loss
        change = self._norms((p[k].detach() - start[k].float()
                              for k in self.names), 1.0)
        moments = {"m": self._norms((m[k] for k in self.names), 1.0),
                   "v": self._norms((v[k] for k in self.names), 1.0)}
        del p, m, v, start
        port.release()
        return {"losses": losses, "grad": grad, "change": change, **moments}

    def compare(self, prog: dict, ref: dict) -> dict:
        med = statistics.median(ref["grad"].values())
        moving = [k for k in self.names if ref["grad"][k] >= STILL * med]
        return {
            "loss_gap": max(compare.rel(a, b) for a, b in
                            zip(prog["losses"], ref["losses"])),
            # the median leaf: the worst one is a router's, whose gradient
            # moves with the few top-k choices that bf16 flips
            "grad_gap": compare.median_leaf(prog["grad"], ref["grad"],
                                            self.names),
            "change_gap": compare.worst_leaf(prog["change"], ref["change"],
                                             moving),
            "m_gap": compare.worst_leaf(prog["m"], ref["m"], moving),
            "v_gap": compare.worst_leaf(prog["v"], ref["v"], moving),
        }
