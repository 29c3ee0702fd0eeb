"""Serving launcher: batched LM inference through the stream2gym pipeline.

Counterpart of ``repro/launch/serve.py`` with the same spec and flags,
plus ``--device`` and ``--full``.  Request producers stream token batches
into a broker topic; an SPE node runs prefill + greedy decode on the
model (attention layers on the card through the hand-written CUDA
kernels); generated tokens flow to a response topic consumed by the
client sink.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \\
      --requests 4 --batch 4 --seq 64 --gen 8 --full
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import Engine, PipelineSpec


def build_spec(args) -> tuple[PipelineSpec, object]:
    spec = PipelineSpec(mode=args.mode)
    spec.add_switch("s1")
    for h in ["client", "broker", "server", "sink"]:
        spec.add_host(h)
        spec.add_link(h, "s1", lat=args.lat, bw=args.bw)
    spec.add_broker("broker")
    spec.add_topic("requests", leader="broker")
    spec.add_topic("responses", leader="broker")
    spec.add_producer("client", "TOKENS", topic="requests",
                      batch=args.batch, seqLen=args.seq,
                      totalMessages=args.requests, interval=args.interval,
                      seed=args.seed)
    spec.add_spe("server", query="lm_generate", inTopic="requests",
                 outTopic="responses", arch=args.arch, genTokens=args.gen,
                 maxLen=args.seq + args.gen + 8, device=args.device,
                 smoke=not args.full)
    sink = spec.add_consumer("sink", "METRICS", topic="responses",
                             pollInterval=0.05)
    return spec, sink


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="xlstm-125m")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--gen", type=int, default=8)
    p.add_argument("--interval", type=float, default=0.5)
    p.add_argument("--lat", type=float, default=1.0)
    p.add_argument("--bw", type=float, default=1000.0)
    p.add_argument("--mode", default="kraft", choices=["zk", "kraft"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cuda or cpu)")
    p.add_argument("--full", action="store_true",
                   help="run the arch at full width (default: the "
                        "reference's smoke reduction)")
    return p.parse_args(argv)


def run(args):
    """Build and run the pipeline; returns (engine, sink runtime)."""
    spec, sink = build_spec(args)
    eng = Engine(spec, seed=args.seed)
    eng.run(until=args.requests * args.interval + 30.0)
    sink_rt = [rt for rt in eng.runtimes if rt.name == sink.name][0]
    return eng, sink_rt


def main(argv=None) -> None:
    args = parse_args(argv)
    eng, sink_rt = run(args)
    mon = eng.monitor
    lat = mon.e2e_latency()
    print(f"[serve] {args.arch}: {sink_rt.n_received}/{args.requests} "
          f"responses")
    if lat:
        print(f"[serve] request e2e latency: mean {np.mean(lat):.3f}s  "
              f"p95 {np.percentile(lat, 95):.3f}s")
    if sink_rt.payloads:
        gen = sink_rt.payloads[0]
        gen = gen["data"] if "data" in gen else gen
        print(f"[serve] sample generation: {gen['generated'][0][:8]}")
    thr = mon.throughput_series("broker")
    if thr:
        peak = max(v for _, v in thr)
        print(f"[serve] broker peak egress: {peak/1e3:.1f} KB/s")


if __name__ == "__main__":
    main()
