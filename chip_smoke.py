#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

  build  compile the CUDA kernels in ``src/repro_torch/csrc`` (one nvcc per
         source, all at once), print the build time, and check in the
         SASS of flash_attention that its bf16 kernels run on the tensor
         cores (HGMMA or HMMA);
  (a)    hold each kernel against its plain torch version on the card: the
         kernel test cases, the main-path shapes, one gemma2 shape;
  (b)    time each kernel, its plain version, a library call that computes
         the same function (a yardstick only; the port never calls it) and
         the card's bound, at the main-path shapes, the long shapes (decode
         split over the cache) and the gemma2 hd=256 prefill; each timed
         output is also held against the plain version;
  (c)    qwen2-7b at full width and 2 layers: prefill + 8 decode steps with
         the kernels vs the plain versions inside the model;
  (d)    the main path: ``repro_torch.launch.serve`` with ``--arch qwen2-7b
         --full`` (28 layers, bf16, random weights from a seed) serving 4
         requests through the port's gym ``Engine``, with launch counts,
         and one profiled request whose attention kernels must be the
         redesigned ones, by name and call count.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, when no GPU is present or the port is missing.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside the tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BPS = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SPIN_CYCLES = 50_000_000  # ~30 ms of spinning: longer than any enqueue

# the kernel test cases of tests/test_kernels.py
FWD_CASES = [
    # B, S, NH, KV, hd, window, softcap
    (2, 64, 4, 4, 32, 0, 0.0),
    (2, 128, 8, 2, 64, 0, 0.0),
    (1, 256, 8, 1, 64, 0, 0.0),
    (1, 128, 4, 2, 32, 32, 0.0),
    (1, 128, 4, 2, 32, 0, 50.0),
    (1, 96, 2, 2, 16, 24, 30.0),
]
DECODE_CASES = [
    # B, S, NH, KV, hd, pos, window, softcap
    (2, 128, 4, 4, 32, 64, 0, 0.0),
    (2, 256, 8, 2, 64, 255, 0, 0.0),
    (1, 512, 8, 1, 64, 0, 0, 0.0),
    (1, 256, 4, 2, 32, 200, 64, 0.0),
    (1, 128, 4, 4, 32, 100, 0, 50.0),
]

# main path (qwen2-7b, 4 requests of batch 4, seq 64, gen 8): prefill at
# S=64; decode against the float32 max_len=80 cache, last step at pos 70
MAIN_B, MAIN_S, MAIN_GEN = 4, 64, 8
MAIN_MAXLEN = MAIN_S + MAIN_GEN + 8
QWEN = dict(NH=28, KV=4, hd=128)
N_LAYERS = 28
N_REQUESTS = 4
# kernel names (csrc/*.cu) that the profiler rows are matched against
ATTN_KERNELS = ("fa_fwd_bf16_mma", "fa_fwd_f32_simt", "fd_split_kernel",
                "fd_combine_kernel")

# the logits of (c) are bf16 values of magnitude up to ~5 (ulp 2**-5):
# a few ulps of difference where one attention output rounds differently
LOGIT_ATOL, LOGIT_RTOL = 0.125, 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# work counts and timing
# ---------------------------------------------------------------------------


def attn_pairs(Sq, Sk, window, causal=True) -> int:
    """(query, key) pairs that attend: the work this data needs."""
    n = 0
    for q in range(Sq):
        hi = min(Sk, q + 1) if causal else Sk
        lo = max(0, q - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BPS
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def time_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call: the median over ``reps`` runs of ``calls``
    back-to-back calls between two CUDA events.  A spin kernel queued
    first keeps the card busy while the host enqueues the calls, so the
    events time the device's work, not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] nvcc sm_90a, {len(_build.SOURCES)} libraries in parallel: "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        text = _build.lib_path(name).with_suffix(".log").read_text()
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in text.splitlines() if "Used " in line})
        spills = [line for line in text.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")]
        log(f"[build] {name}: registers per thread {regs}; "
            f"{'no spills' if not spills else spills}")
    log("[build] flash_attention bf16 kernels: " + tensor_core_check(_build))


def tensor_core_check(_build) -> str:
    """The SASS of every bf16 flash_attention kernel holds tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync); raise otherwise."""
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", str(_build.lib_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    found = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split(None, 1)[0]
        if "fa_fwd_bf16" not in name:
            continue
        ops = [op for op in ("HGMMA", "HMMA") if op in func]
        if not ops:
            raise AssertionError(f"[build] {name}: no HGMMA or HMMA in its "
                                 "SASS: the bf16 kernel is not on the "
                                 "tensor cores")
        hd = int(re.search(r"ILi(\d+)E", name).group(1))
        found[hd] = (ops[0], func.count(ops[0]))
    if sorted(found) != [16, 32, 64, 128, 256]:
        raise AssertionError(f"[build] bf16 flash_attention kernels for "
                             f"head_dims {sorted(found)} in the SASS, "
                             "expected 16, 32, 64, 128, 256")
    return "; ".join(f"hd={hd}: {op} x{c}" for hd, (op, c) in
                     sorted(found.items()))


class Inputs:
    def __init__(self, seed: int):
        import torch
        self.g = torch.Generator(device="cuda").manual_seed(seed)

    def __call__(self, shape, dtype):
        import torch
        return torch.randn(shape, generator=self.g, device="cuda").to(dtype)


def check_close(name, out, want, tol) -> float:
    import torch
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{name}: kernel vs plain max |err| {err} "
                             f"(atol=rtol={tol})")
    return err


def fwd_case(rnd, B, S, NH, KV, hd, window, cap, dtype):
    from repro_torch.kernels import flash_attention as fa, ref
    q, k, v = (rnd((B, S, NH, hd), dtype), rnd((B, S, KV, hd), dtype),
               rnd((B, S, KV, hd), dtype))
    kw = dict(scale=hd ** -0.5, causal=True, window=window, softcap=cap)
    out = fa.flash_attention_fwd(q, k, v, **kw)
    want = ref.attention(q, k, v, **kw)
    return check_close(f"flash_attention {(B, S, NH, KV, hd, window, cap)} "
                       f"{dtype}", out, want, TOL[str(dtype).split(".")[1]])


def decode_inputs(rnd, B, S, NH, KV, hd, q_dtype, kv_dtype,
                  model_layout=True):
    """q and the model's cache layouts, K (B,KV,hd,S) and V (B,KV,S,hd),
    as the strided (B,S,KV,hd) views the model hands the kernel (or,
    with ``model_layout=False``, contiguous (B,S,KV,hd) caches)."""
    q = rnd((B, NH, hd), q_dtype)
    if not model_layout:
        return q, rnd((B, S, KV, hd), kv_dtype), rnd((B, S, KV, hd),
                                                     kv_dtype)
    kc = rnd((B, KV, hd, S), kv_dtype).permute(0, 3, 1, 2)
    vc = rnd((B, KV, S, hd), kv_dtype).permute(0, 2, 1, 3)
    return q, kc, vc


def decode_case(q, kc, vc, pos, window, cap, tol, label):
    from repro_torch.kernels import flash_decode as fd, ref
    kw = dict(scale=q.shape[-1] ** -0.5, window=window, softcap=cap)
    out = fd.flash_decode(q, kc, vc, pos, **kw)
    want = ref.decode(q, kc, vc, pos, **kw)
    return check_close(f"flash_decode {label}", out, want, tol)


def phase_a(rnd) -> dict:
    import torch
    errs = {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in FWD_CASES:
            fwd_case(rnd, *case, dtype)
            n += 1
        for (B, S, NH, KV, hd, pos, w, cap) in DECODE_CASES:
            q = rnd((B, NH, hd), dtype)
            kc, vc = rnd((B, S, KV, hd), dtype), rnd((B, S, KV, hd), dtype)
            decode_case(q, kc, vc, pos, w, cap,
                        TOL[str(dtype).split(".")[1]],
                        f"{(B, S, NH, KV, hd, pos, w, cap)} {dtype}")
            n += 1
    # main-path shapes
    errs["flash_attention"] = fwd_case(
        rnd, MAIN_B, MAIN_S, QWEN["NH"], QWEN["KV"], QWEN["hd"], 0, 0.0,
        torch.bfloat16)
    q, kc, vc = decode_inputs(rnd, MAIN_B, MAIN_MAXLEN, QWEN["NH"],
                              QWEN["KV"], QWEN["hd"], torch.bfloat16,
                              torch.float32)
    errs["flash_decode"] = decode_case(
        q, kc, vc, MAIN_S + MAIN_GEN - 2, 0, 0.0, TOL["bfloat16"],
        "main path bf16 q, float32 strided cache")
    # gemma2-2b: hd=256, softcap 50, window 4096, S=4608
    fwd_case(rnd, 1, 4608, 8, 4, 256, 4096, 50.0, torch.bfloat16)
    q, kc, vc = decode_inputs(rnd, 1, 4608, 8, 4, 256, torch.bfloat16,
                              torch.bfloat16)
    decode_case(q, kc, vc, 4607, 4096, 50.0, TOL["bfloat16"],
                "gemma2 hd=256 window 4096 softcap 50")
    n += 4
    log(f"[a] {n} kernel-vs-plain cases agree; main-path max |err|: "
        f"flash_attention {errs['flash_attention']}, "
        f"flash_decode {errs['flash_decode']}")
    return errs


def time_prefill(rnd, label, B, S, NH, KV, hd, window=0, cap=0.0):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    dt = torch.bfloat16
    q, k, v = rnd((B, S, NH, hd), dt), rnd((B, S, KV, hd), dt), \
        rnd((B, S, KV, hd), dt)
    kw = dict(scale=hd ** -0.5, window=window, softcap=cap)
    calls = 20 if S <= 1024 else 3
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), calls)
    plain = time_ms(lambda: ref.attention(q, k, v, **kw), calls)
    lib = None  # SDPA has no softcap and no window: no library call
    if not window and not cap:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=kw["scale"], enable_gqa=True),
            calls)
    err = check_close(f"flash_attention {label}",
                      fa.flash_attention_fwd(q, k, v, **kw),
                      ref.attention(q, k, v, **kw), TOL["bfloat16"])
    pairs = attn_pairs(S, S, window)
    flops = 4.0 * hd * pairs * B * NH
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    log(f"[b] flash_attention {label} q{(B, S, NH, hd)} kv{(B, S, KV, hd)} "
        f"bf16 window {window} softcap {cap}: kernel {ms} ms, plain {plain} "
        f"ms, sdpa {lib} ms, bound {b_ms} ms by {b_by} (share "
        f"{b_ms / ms:.4f}; flops {flops:.4g}, bytes {nbytes:.4g}); max "
        f"|err| vs plain {err}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def time_decode(rnd, label, B, S, NH, KV, hd, pos, kv_dtype,
                model_layout=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd, ref
    q, kc, vc = decode_inputs(rnd, B, S, NH, KV, hd, torch.bfloat16,
                              kv_dtype, model_layout)
    scale = hd ** -0.5
    n_split = fd.plan(q, kc, pos)
    ms = time_ms(lambda: fd.flash_decode(q, kc, vc, pos, scale=scale))
    plain = time_ms(lambda: ref.decode(q, kc, vc, pos, scale=scale))
    # library yardstick: one SDPA call over the valid keys, q in the
    # cache's dtype (SDPA takes one dtype), prepared outside the timing
    ql = q.to(kv_dtype)[:, :, None]
    kl = kc[:, :pos + 1].transpose(1, 2)
    vl = vc[:, :pos + 1].transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, scale=scale, enable_gqa=True))
    err = check_close(f"flash_decode {label}",
                      fd.flash_decode(q, kc, vc, pos, scale=scale),
                      ref.decode(q, kc, vc, pos, scale=scale),
                      TOL["bfloat16"])
    n = min(S, pos + 1)
    kv_name = str(kv_dtype).split(".")[1]
    elt = 2 if kv_name == "bfloat16" else 4
    flops = 4.0 * hd * n * B * NH
    nbytes = 2 * 2 * B * NH * hd + 2 * B * KV * n * hd * elt
    b_ms, b_by = bound(flops, nbytes, kv_name)
    log(f"[b] flash_decode {label} q{(B, NH, hd)} bf16, cache{(B, S, KV, hd)}"
        f" {kv_name} pos {pos}: n_split {n_split} ({n_split * KV * B} "
        f"blocks{', combine kernel' if n_split > 1 else ''}); kernel {ms} "
        f"ms, plain {plain} ms, sdpa {lib} ms, bound {b_ms} ms by {b_by} "
        f"(share {b_ms / ms:.4f}; flops {flops:.4g}, bytes {nbytes:.4g}); "
        f"max |err| vs plain {err}")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, n_split=n_split)


def phase_b(rnd) -> dict:
    import torch
    main = {
        "flash_attention": time_prefill(rnd, "main", MAIN_B, MAIN_S,
                                        **QWEN),
        "flash_decode": time_decode(rnd, "main", MAIN_B, MAIN_MAXLEN,
                                    **QWEN, pos=MAIN_S + MAIN_GEN - 2,
                                    kv_dtype=torch.float32),
    }
    time_prefill(rnd, "long", 1, 8192, **QWEN)
    # gemma2: hd=256 (dynamic shared memory, 128 accumulators per thread)
    time_prefill(rnd, "gemma2", 1, 4608, 8, 4, 256, window=4096, cap=50.0)
    long = time_decode(rnd, "long", 8, 32768, **QWEN, pos=32767,
                       kv_dtype=torch.bfloat16)
    # the same work on contiguous (B,S,KV,hd) caches: what the model's
    # (B,KV,hd,S) K layout costs this kernel's loads
    time_decode(rnd, "long, contiguous (B,S,KV,hd) caches", 8, 32768,
                **QWEN, pos=32767, kv_dtype=torch.bfloat16,
                model_layout=False)
    if long["n_split"] < 2:
        raise AssertionError("[b] the long decode was not split")
    if main["flash_decode"].pop("n_split") != 1:
        raise AssertionError("[b] the main-path decode was split")
    torch.cuda.empty_cache()
    return main


class plain_attention:
    """Swap the kernels' public wrappers for their plain versions (the
    model calls them through ``repro_torch.kernels.ops``)."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.saved = (ops.flash_attention, ops.flash_decode)
        ops.flash_attention = (
            lambda q, k, v, scale, causal=True, window=0, softcap=0.0:
            ref.attention(q, k, v, scale=scale, causal=causal,
                          window=window, softcap=softcap))
        ops.flash_decode = (
            lambda q, kc, vc, pos, *, scale, window=0, softcap=0.0:
            ref.decode(q, kc, vc, pos, scale=scale, window=window,
                       softcap=softcap))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention, ops.flash_decode = self.saved


def phase_c() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.spe import _merge_prefill_cache
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=2)
    model = Model(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (MAIN_B, MAIN_S), generator=g,
                         device="cuda")
    steps = 8

    def run(feed=None):
        lg, pc = model.prefill(toks)
        cache = _merge_prefill_cache(
            model.init_cache(MAIN_B, MAIN_S + steps + 1, torch.float32), pc,
            MAIN_S)
        logits, fed = [lg[:, -1].float()], []
        for i in range(steps):
            tok = (feed[i] if feed is not None
                   else torch.argmax(logits[-1], -1))
            fed.append(tok)
            lg, cache = model.decode_step(cache, tok[:, None], MAIN_S + i)
            logits.append(lg[:, -1].float())
        return logits, fed

    with plain_attention():
        plain, fed = run()
    kern, _ = run(feed=fed)       # same input tokens: compare step by step
    worst, agree = 0.0, 0
    for i, (a, b) in enumerate(zip(kern, plain)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"[c] step {i}: non-finite kernel logits")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL):
            raise AssertionError(
                f"[c] step {i}: kernel vs plain logits max |err| {err} "
                f"(atol {LOGIT_ATOL}, rtol {LOGIT_RTOL})")
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    total = len(kern) * MAIN_B
    log(f"[c] qwen2-7b full width, 2 layers, bf16: prefill + {steps} decode "
        f"steps, kernels vs plain: logits max |err| {worst} (atol "
        f"{LOGIT_ATOL}, rtol {LOGIT_RTOL}); greedy tokens agree {agree}/"
        f"{total}")
    del model
    torch.cuda.empty_cache()


def phase_d() -> dict:
    import numpy as np
    import torch
    from repro_torch.core.spe import LMGenerateQuery
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    from repro_torch.launch import serve
    from repro_torch.models import Model

    # observe (do not alter) the main path: wall time of the model build
    # and of each request, and finiteness of every logit tensor
    walls, build_s, finite = [], [], []
    orig_build, orig_gen = LMGenerateQuery._build, LMGenerateQuery.generate
    orig_pre, orig_dec = Model.prefill, Model.decode_step

    def timed_build(self):
        t0 = time.perf_counter()
        orig_build(self)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)

    def timed_gen(self, tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_gen(self, tokens)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    def pre(self, inputs):
        lg, c = orig_pre(self, inputs)
        finite.append(torch.isfinite(lg).all())
        return lg, c

    def dec(self, cache, inputs, pos):
        lg, c = orig_dec(self, cache, inputs, pos)
        finite.append(torch.isfinite(lg).all())
        return lg, c

    args = serve.parse_args([
        "--arch", "qwen2-7b", "--full", "--device", "cuda",
        "--requests", str(N_REQUESTS), "--batch", str(MAIN_B),
        "--seq", str(MAIN_S), "--gen", str(MAIN_GEN)])
    LMGenerateQuery._build, LMGenerateQuery.generate = timed_build, timed_gen
    Model.prefill, Model.decode_step = pre, dec
    torch.cuda.reset_peak_memory_stats()
    try:
        fa.launches = 0
        fd.launches = 0
        t0 = time.perf_counter()
        eng, sink_rt = serve.run(args)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches,
                    "flash_decode": fd.launches}
    finally:
        LMGenerateQuery._build, LMGenerateQuery.generate = (orig_build,
                                                            orig_gen)
        Model.prefill, Model.decode_step = orig_pre, orig_dec

    vocab = 152064
    if sink_rt.n_received != N_REQUESTS:
        raise AssertionError(f"[d] {sink_rt.n_received}/{N_REQUESTS} "
                             "responses reached the sink")
    for p in sink_rt.payloads:
        gen = np.asarray((p["data"] if "data" in p else p)["generated"])
        if gen.shape != (MAIN_B, MAIN_GEN) or gen.min() < 0 \
                or gen.max() >= vocab:
            raise AssertionError(f"[d] bad generation {gen.shape} "
                                 f"[{gen.min()}, {gen.max()}]")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("[d] non-finite logits")
    want = {"flash_attention": N_LAYERS * N_REQUESTS,
            "flash_decode": N_LAYERS * (MAIN_GEN - 1) * N_REQUESTS}
    if launches != want:
        raise AssertionError(f"[d] launches {launches}, expected {want}")
    splits = decode_splits()
    profile_request(eng, walls)
    m = eng.metrics()
    e2e = eng.monitor.e2e_latency()
    log(f"[d] qwen2-7b full width (28 layers, d=3584, vocab {vocab}, bf16 "
        f"params): {sink_rt.n_received}/{N_REQUESTS} responses, launches "
        f"{launches}")
    log(f"[d] model build {build_s[0]:.3f} s; wall per request (batch "
        f"{MAIN_B}, seq {MAIN_S}, gen {MAIN_GEN}) {walls} s; engine run "
        f"{wall:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[d] flash_decode split count by decode position {splits}: "
        f"{MAIN_B * QWEN['KV']} blocks per step, no combine kernel")
    log(f"[d] sim e2e latency per request (s): {e2e}")
    log("[d] metrics " + json.dumps(
        {k: v for k, v in m.items() if not isinstance(v, (dict, list))},
        sort_keys=True, default=str))
    return launches


def decode_splits() -> dict:
    """The split count of each decode step of the main path (bf16 q, the
    model's float32 (B,KV,hd,S) K cache); all must be 1."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    q = torch.empty((MAIN_B, QWEN["NH"], QWEN["hd"]), dtype=torch.bfloat16,
                    device="cuda")
    kc = torch.empty((MAIN_B, QWEN["KV"], QWEN["hd"], MAIN_MAXLEN),
                     device="cuda").permute(0, 3, 1, 2)
    splits = {pos: fd.plan(q, kc, pos)
              for pos in range(MAIN_S, MAIN_S + MAIN_GEN - 1)}
    if set(splits.values()) != {1}:
        raise AssertionError(f"[d] main-path decode splits {splits}")
    return splits


def profile_request(eng, walls) -> None:
    """One more request through the served query under torch.profiler:
    the device's busy time by kernel against the request's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.spe import LMGenerateQuery
    query = next(rt.query for rt in eng.runtimes
                 if isinstance(getattr(rt, "query", None), LMGenerateQuery))
    g = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, 512, (MAIN_B, MAIN_S), generator=g,
                         device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query.generate(toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[0] for r in rows)
    steady = statistics.median(walls[1:]) * 1e3
    log(f"[d] profiled request: wall {wall_ms:.3f} ms (unprofiled median "
        f"{steady:.3f} ms), {sum(r[1] for r in rows)} kernels, device busy "
        f"{busy_ms:.3f} ms: idle share {1 - busy_ms / steady:.4f} of the "
        f"unprofiled wall")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f"[d]   {ms:.3f} ms device, {n} calls: {key[:90]}")
    # the request's attention ran through the redesigned kernels: the
    # tensor-core prefill once per layer, the split decode once per layer
    # and step, no combine (one split) and no float32 body
    got = {name: [sum(r[1] for r in rows if name in r[2]),
                  sum(r[0] for r in rows if name in r[2])]
           for name in ATTN_KERNELS}
    want = {name: 0 for name in ATTN_KERNELS}
    want.update(fa_fwd_bf16_mma=N_LAYERS,
                fd_split_kernel=N_LAYERS * (MAIN_GEN - 1))
    if {name: n for name, (n, _) in got.items()} != want:
        raise AssertionError(f"[d] attention kernel calls in the profiled "
                             f"request {got}, expected {want}")
    log("[d] attention kernels of the profiled request: " + ", ".join(
        f"{name} {n} calls {ms:.3f} ms" for name, (n, ms) in got.items()))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(gpu_line())
    t_start = time.perf_counter()
    phase_build()
    rnd = Inputs(0)
    errs = phase_a(rnd)
    times = phase_b(rnd)
    phase_c()
    launches = phase_d()
    kernels = []
    for name, src, replaces, design in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:81",
             "mma.sync+cp.async"),
            ("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode.py:68", "split-k+cp.async")):
        t = times[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **t,
                        "bound_share": t["bound_ms"] / t["ms"],
                        "design": design})
    log(f"[done] torch {torch.__version__} (cuda {torch.version.cuda}); "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
