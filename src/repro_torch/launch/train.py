"""Training launcher: checkpointed, fault-tolerant, optionally in the gym.

Counterpart of ``repro/launch/train.py`` with the same flags and modes,
plus ``--device`` (default ``cuda``) and, for the gym, ``--full``:

- direct (default): data pipeline → ElasticTrainer loop on the device.
  The arch runs at full width unless ``--smoke`` shrinks it.
- ``--gym``: the same training step inside a stream2gym pipeline — a
  TOKENS producer streams batches through a broker topic into an SPE
  node running ``lm_train``, and metrics flow to a consumer topic.  The
  query trains the smoke reduction unless ``--full``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --smoke --device cpu --steps 100 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --steps 6 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --steps 50 --gym --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeCfg
from repro_torch.data.pipeline import make_source
from repro_torch.models.params import resolve_device
from repro_torch.runtime import ElasticTrainer
from repro_torch.train import make_step_bundle


def build(arch: str, *, smoke: bool, batch: int, seq: int, seed: int = 0,
          microbatches: int = 1, device=None):
    """(cfg, bundle, batches): ``batches(step)`` is the step's batch of the
    seeded synthetic source, as tensors on ``device``."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, microbatches=microbatches)
    shape = ShapeCfg("local", seq, batch, "train")
    bundle = make_step_bundle(cfg, shape)
    src = make_source(cfg, seq, seed=seed)

    def batches(step: int) -> dict:
        b = src.batch(step, 0, batch)
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    return cfg, bundle, batches


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="xlstm-125m")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--gym", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cuda or cpu)")
    p.add_argument("--full", action="store_true",
                   help="--gym only: train the arch at full width (default: "
                        "the reference's smoke reduction)")
    return p.parse_args(argv)


def run(args):
    """Direct mode: returns (cfg, trainer, final state)."""
    cfg, bundle, batches = build(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        seed=args.seed, microbatches=args.microbatches, device=args.device)
    print(f"[train] {cfg.name}: {cfg.n_params()/1e6:.1f}M params, "
          f"batch {args.batch}x{args.seq}", flush=True)
    trainer = ElasticTrainer(bundle, batches, ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every)
    state = bundle.init_fn(
        torch.Generator(device=resolve_device(args.device)).manual_seed(
            args.seed))
    state = trainer.run(state, steps=args.steps)
    return cfg, trainer, state


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.gym:
        run_gym(args)
        return
    t0 = time.time()
    _, trainer, _ = run(args)
    dt = time.time() - t0
    r = trainer.report
    print(f"[train] done: {r.steps_run} steps in {dt:.1f}s "
          f"({r.steps_run and dt / r.steps_run:.3f} s/step), "
          f"loss {r.losses[0]:.4f} -> {r.losses[-1]:.4f}, "
          f"restarts={r.restarts}")


def build_gym_spec(args):
    """The reference's gym training spec; returns (spec, sink)."""
    from repro_torch.core import PipelineSpec

    spec = PipelineSpec()
    spec.add_switch("s1")
    for h in ["data", "broker", "trainer", "sink"]:
        spec.add_host(h)
        spec.add_link(h, "s1", lat=0.5, bw=10_000.0)
    spec.add_broker("broker")
    spec.add_topic("batches", leader="broker")
    spec.add_topic("metrics", leader="broker")
    spec.add_producer("data", "TOKENS", topic="batches", batch=args.batch,
                      seqLen=args.seq, totalMessages=args.steps,
                      interval=0.2, seed=args.seed)
    spec.add_spe("trainer", query="lm_train", inTopic="batches",
                 outTopic="metrics", arch=args.arch, seed=args.seed,
                 device=args.device, smoke=not args.full)
    cons = spec.add_consumer("sink", "METRICS", topic="metrics",
                             pollInterval=0.1)
    return spec, cons


def run_gym(args):
    """Train through the stream2gym pipeline (paper architecture); returns
    (engine, sink runtime, losses)."""
    from repro_torch.core import Engine

    spec, cons = build_gym_spec(args)
    eng = Engine(spec, seed=args.seed)
    mon = eng.run(until=args.steps * 0.2 + 30.0)
    sink = [rt for rt in eng.runtimes if rt.name == cons.name][0]
    losses = [p["data"]["loss"] if isinstance(p, dict) and "data" in p
              else p["loss"] for p in sink.payloads]
    print(f"[gym-train] {len(losses)} metric messages; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"[gym-train] e2e batch latency (s): "
          f"{np.mean(mon.e2e_latency()):.3f} mean")
    return eng, sink, losses


if __name__ == "__main__":
    main()
