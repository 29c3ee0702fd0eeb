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
         redesigned ones, by name and call count;
  (e)    xlstm-125m at full width (12 layers, d=768, float32 params drawn
         on the CPU from a seed and copied to the card, bf16 compute):
         ``repro_torch.launch.serve --arch xlstm-125m --full`` serving 4
         requests through the gym (no attention kernel on this path), one
         profiled request with the sLSTM per-step loop's share of its
         kernels, and one prefill of 1024 tokens plus 8 decode steps on the
         card held against the CPU with the same weights;
  (f)    the paper's applications (sentiment, ride selection, fraud SVM,
         traffic metrics) through the gym with their tensor compute on the
         card, held against the same pipelines on the CPU (ROADMAP C3),
         then the Ocampo scenario of Fig. 7b at 20-100 users on the card,
         printing the mean measured SPE wall per window;
  (g)    training on the card: (g1) flash_attention as an autograd
         function (one kernel launch per forward, grads equal to autograd
         through ref.attention) at the kernel cases and gemma2-2b's
         training shapes; (g2) loss and gradients of a 2-layer full-width
         gemma2-2b, kernel vs plain; (g3) the slice's main path,
         ``repro_torch.launch.train --arch gemma2-2b --steps 6 --batch 4
         --seq 1024`` (26 layers, bf16, float32 AdamW, remat full) with
         flash_attention launches per step, wall per step, tokens/s, peak
         memory, model FLOPs share and one profiled step; (g4) an injected
         failure and a checkpoint restore on the card (smoke xlstm-125m,
         qwen2-7b) against an unbroken run; (g5) gym training of
         xlstm-125m at full width (``--gym --full``).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, when no GPU is present or the port is missing.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
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
DEV = "cuda"  # the device of the served paths (d), (e), (f)

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


def greedy_steps(model, toks, steps, feed=None):
    """Prefill ``toks``, then ``steps`` decode steps; each step feeds the
    argmax of the last logits, or ``feed[i]`` where given.  Returns the
    float32 last-position logits of every step (prefill first) and the
    tokens fed."""
    import torch
    from repro_torch.core.spe import _merge_prefill_cache
    B, S = toks.shape
    lg, pc = model.prefill(toks)
    cache = _merge_prefill_cache(
        model.init_cache(B, S + steps + 1, torch.float32), pc, S)
    logits, fed = [lg[:, -1].float()], []
    for i in range(steps):
        tok = (feed[i].to(toks.device) if feed is not None
               else torch.argmax(logits[-1], -1))
        fed.append(tok)
        lg, cache = model.decode_step(cache, tok[:, None], S + i)
        logits.append(lg[:, -1].float())
    return logits, fed


def compare_logits(tag, what, got, want, atol=LOGIT_ATOL,
                   rtol=LOGIT_RTOL) -> tuple[float, int, int]:
    """Hold each step's logits against the reference's (on the reference's
    device) within atol + rtol * |x|; returns (max |err|, greedy tokens
    that agree, tokens)."""
    import torch
    worst, agree, total = 0.0, 0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.to(b.device)
        if not torch.isfinite(a).all():
            raise AssertionError(f"{tag} step {i}: non-finite {what} logits")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, b, atol=atol, rtol=rtol):
            raise AssertionError(
                f"{tag} step {i}: {what} logits max |err| {err} "
                f"(atol {atol}, rtol {rtol})")
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        total += a.shape[0]
    return worst, agree, total


def phase_c() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=2)
    model = Model(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (MAIN_B, MAIN_S), generator=g,
                         device="cuda")
    steps = 8
    with plain_attention():
        plain, fed = greedy_steps(model, toks, steps)
    # same input tokens: compare step by step
    kern, _ = greedy_steps(model, toks, steps, feed=fed)
    worst, agree, total = compare_logits("[c]", "kernel vs plain", kern,
                                         plain)
    log(f"[c] qwen2-7b full width, 2 layers, bf16: prefill + {steps} decode "
        f"steps, kernels vs plain: logits max |err| {worst} (atol "
        f"{LOGIT_ATOL}, rtol {LOGIT_RTOL}); greedy tokens agree {agree}/"
        f"{total}")
    del model
    torch.cuda.empty_cache()


class observe_serve:
    """Observe (do not alter) a serve run: wall time of the model build
    and of each request, and finiteness of every logit tensor.  With
    ``params`` (a state_dict) the served model loads those values in
    place of its own seeded draw."""

    def __init__(self, params=None):
        self.params = params
        self.walls, self.build_s, self.finite = [], [], []

    def __enter__(self):
        import torch
        from repro_torch.core.spe import LMGenerateQuery as Q
        from repro_torch.models import Model
        self.saved = (Q._build, Q.generate, Q._init_params, Model.prefill,
                      Model.decode_step)
        build, gen, _, pre, dec = self.saved
        obs = self

        def timed_build(q):
            t0 = time.perf_counter()
            build(q)
            torch.cuda.synchronize()
            obs.build_s.append(time.perf_counter() - t0)

        def timed_gen(q, tokens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gen(q, tokens)
            torch.cuda.synchronize()
            obs.walls.append(time.perf_counter() - t0)
            return out

        def checked_pre(m, inputs):
            lg, c = pre(m, inputs)
            obs.finite.append(torch.isfinite(lg).all())
            return lg, c

        def checked_dec(m, cache, inputs, pos):
            lg, c = dec(m, cache, inputs, pos)
            obs.finite.append(torch.isfinite(lg).all())
            return lg, c

        Q._build, Q.generate = timed_build, timed_gen
        Model.prefill, Model.decode_step = checked_pre, checked_dec
        if self.params is not None:
            Q._init_params = lambda q, model: model.load_state_dict(
                obs.params)
        return self

    def __exit__(self, *exc):
        from repro_torch.core.spe import LMGenerateQuery as Q
        from repro_torch.models import Model
        (Q._build, Q.generate, Q._init_params, Model.prefill,
         Model.decode_step) = self.saved


def serve_full(arch: str, params=None):
    """``repro_torch.launch.serve --arch <arch> --full --device cuda``:
    N_REQUESTS requests of batch MAIN_B, seq MAIN_S, gen MAIN_GEN through
    the port's gym, the kernels' launch counts set to 0 just before and
    read just after.  Returns (engine, sink runtime, observer, engine
    wall s, launches)."""
    import torch
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    from repro_torch.launch import serve
    args = serve.parse_args([
        "--arch", arch, "--full", "--device", DEV,
        "--requests", str(N_REQUESTS), "--batch", str(MAIN_B),
        "--seq", str(MAIN_S), "--gen", str(MAIN_GEN)])
    torch.cuda.reset_peak_memory_stats()
    with observe_serve(params) as obs:
        fa.launches = 0
        fd.launches = 0
        t0 = time.perf_counter()
        eng, sink_rt = serve.run(args)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches,
                    "flash_decode": fd.launches}
    return eng, sink_rt, obs, wall, launches


def check_responses(tag, sink_rt, vocab, finite) -> None:
    import numpy as np
    import torch
    if sink_rt.n_received != N_REQUESTS:
        raise AssertionError(f"{tag} {sink_rt.n_received}/{N_REQUESTS} "
                             "responses reached the sink")
    for p in sink_rt.payloads:
        gen = np.asarray((p["data"] if "data" in p else p)["generated"])
        if gen.shape != (MAIN_B, MAIN_GEN) or gen.min() < 0 \
                or gen.max() >= vocab:
            raise AssertionError(f"{tag} bad generation {gen.shape} "
                                 f"[{gen.min()}, {gen.max()}]")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{tag} non-finite logits")


def served_query(eng):
    from repro_torch.core.spe import LMGenerateQuery
    return next(rt.query for rt in eng.runtimes
                if isinstance(getattr(rt, "query", None), LMGenerateQuery))


def phase_d() -> dict:
    import torch
    eng, sink_rt, obs, wall, launches = serve_full("qwen2-7b")
    vocab = 152064
    check_responses("[d]", sink_rt, vocab, obs.finite)
    want = {"flash_attention": N_LAYERS * N_REQUESTS,
            "flash_decode": N_LAYERS * (MAIN_GEN - 1) * N_REQUESTS}
    if launches != want:
        raise AssertionError(f"[d] launches {launches}, expected {want}")
    splits = decode_splits()
    rows = profile_request("[d]", eng, obs.walls)
    attention_kernel_check(rows)
    m = eng.metrics()
    e2e = eng.monitor.e2e_latency()
    log(f"[d] qwen2-7b full width (28 layers, d=3584, vocab {vocab}, bf16 "
        f"params): {sink_rt.n_received}/{N_REQUESTS} responses, launches "
        f"{launches}")
    log(f"[d] model build {obs.build_s[0]:.3f} s; wall per request (batch "
        f"{MAIN_B}, seq {MAIN_S}, gen {MAIN_GEN}) {obs.walls} s; engine run "
        f"{wall:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[d] flash_decode split count by decode position {splits}: "
        f"{MAIN_B * QWEN['KV']} blocks per step, no combine kernel")
    log(f"[d] sim e2e latency per request (s): {e2e}")
    log("[d] metrics " + json.dumps(
        {k: v for k, v in m.items() if not isinstance(v, (dict, list))},
        sort_keys=True, default=str))
    del eng, sink_rt, obs
    gc.collect()           # the engine's closures form cycles
    torch.cuda.empty_cache()
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


def device_rows(prof) -> list:
    """(device ms, calls, name) of each kernel in a profile: kernel rows
    only, since an operator's row repeats its kernels' time."""
    import torch
    return [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_request(tag, eng, walls) -> list:
    """One more request through the served query under torch.profiler:
    the device's busy time by kernel against the request's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    query = served_query(eng)
    g = torch.Generator(device=DEV).manual_seed(2)
    toks = torch.randint(0, 512, (MAIN_B, MAIN_S), generator=g, device=DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query.generate(toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    steady = statistics.median(walls[1:]) * 1e3
    log(f"{tag} profiled request: wall {wall_ms:.3f} ms (unprofiled median "
        f"{steady:.3f} ms), {sum(r[1] for r in rows)} kernels, device busy "
        f"{busy_ms:.3f} ms: idle share {1 - busy_ms / steady:.4f} of the "
        f"unprofiled wall")
    for ms, n, key in sorted(rows, reverse=True)[:8]:
        log(f"{tag}   {ms:.3f} ms device, {n} calls: {key[:90]}")
    return rows


def attention_kernel_check(rows) -> None:
    """The profiled request's attention ran through the redesigned
    kernels: the tensor-core prefill once per layer, the split decode
    once per layer and step, no combine (one split) and no float32
    body."""
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


# ---------------------------------------------------------------------------
# (e) xlstm-125m at full width
# ---------------------------------------------------------------------------

XLSTM = "xlstm-125m"
LONG_S, LONG_STEPS = 1024, 8    # 8 mLSTM chunks of 128, then 8 decodes
# float32 logits of the long sequence, card vs CPU (measured 8.7e-5 at
# S=1024 on an H100; the CPU tests hold whole models at 2e-4)
F32_TOL = 1e-3


def phase_e() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(XLSTM)
    # weights drawn once on the CPU from a seed; the card's served model
    # and the CPU model below hold the same values
    t0 = time.perf_counter()
    cpu_model = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    draw_s = time.perf_counter() - t0
    eng, sink_rt, obs, wall, launches = serve_full(
        XLSTM, cpu_model.state_dict())
    check_responses("[e]", sink_rt, cfg.vocab_size, obs.finite)
    if any(launches.values()):
        raise AssertionError(f"[e] attention kernels launched on the "
                             f"xLSTM path: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in cpu_model.parameters())
    log(f"[e] {XLSTM} full width ({cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, {n_params} float32 "
        f"params drawn on the CPU in {draw_s:.3f} s, bf16 compute): "
        f"{sink_rt.n_received}/{N_REQUESTS} responses; attention kernel "
        f"launches {launches} (none on this path)")
    log(f"[e] model build {obs.build_s[0]:.3f} s; wall per request (batch "
        f"{MAIN_B}, seq {MAIN_S}, gen {MAIN_GEN}) {obs.walls} s, median of "
        f"requests 2-{N_REQUESTS} {statistics.median(obs.walls[1:])} s; "
        f"engine run {wall:.3f} s; peak device memory {peak:.3f} GiB")
    query = served_query(eng)
    rows = profile_request("[e]", eng, obs.walls)
    slstm_launch_share(query.model, sum(r[1] for r in rows))
    del eng, sink_rt, obs, query
    gc.collect()
    torch.cuda.empty_cache()
    long_sequence_check(cpu_model)


def slstm_launch_share(model, request_kernels: int) -> None:
    """Kernels per sLSTM time step (the per-step Python loop), from
    profiles of one sLSTM block at S=MAIN_S and S=1, and the loop's share
    of the profiled request's kernels (3 sLSTM layers x (MAIN_S prefill
    steps + MAIN_GEN - 1 decode steps))."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import xlstm
    cfg = model.cfg
    layer = next(i for i, lay in enumerate(cfg.pattern)
                 if lay.mixer == "slstm")
    p = model.groups[0][f"l{layer}"]["mixer"]
    counts = {}
    for S in (MAIN_S, 1):
        x = torch.zeros((MAIN_B, S, cfg.d_model), dtype=torch.bfloat16,
                        device=DEV)
        xlstm.slstm_apply(p, x, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
            xlstm.slstm_apply(p, x, cfg)
            torch.cuda.synchronize()
        counts[S] = sum(r[1] for r in device_rows(prof))
    per_step = (counts[MAIN_S] - counts[1]) / (MAIN_S - 1)
    n_slstm = sum(layer.mixer == "slstm" for layer in cfg.pattern) \
        * cfg.n_groups
    loop = n_slstm * (MAIN_S + MAIN_GEN - 1) * per_step
    log(f"[e] sLSTM block kernels: {counts[MAIN_S]} at S={MAIN_S}, "
        f"{counts[1]} at S=1: {per_step} per time step; the per-step loop "
        f"is {loop:.0f} of the request's {request_kernels} kernels "
        f"(share {loop / request_kernels:.4f})")


def long_sequence_check(cpu_model) -> None:
    """One prefill of LONG_S tokens (batch 1) plus LONG_STEPS decode
    steps, with the same weights and the same input tokens (the float32
    CPU run's greedy tokens) on the card and on the CPU.

    In float32 compute the card's logits are held against the CPU's at
    each step within F32_TOL: that compares the two devices' code paths
    without bf16 rounding.  In bf16 compute (the served configuration)
    both devices are printed against the float32 CPU logits; their
    roundings differ by more than LOGIT_ATOL, so there only finite logits
    are required."""
    import torch
    from repro_torch.models import Model
    params = cpu_model.state_dict()
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cpu_model.cfg.vocab_size, (1, LONG_S),
                         generator=g)
    runs, walls, fed = {}, {}, None
    for compute, dev in (("float32", "cpu"), ("float32", DEV),
                         ("bfloat16", "cpu"), ("bfloat16", DEV)):
        model = Model(dataclasses.replace(cpu_model.cfg,
                                          compute_dtype=compute), device=dev)
        model.load_state_dict(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, fed_here = greedy_steps(model, toks.to(dev), LONG_STEPS,
                                        feed=fed)
        torch.cuda.synchronize()
        walls[compute, dev] = time.perf_counter() - t0
        runs[compute, dev] = [x.cpu() for x in logits]
        fed = fed or fed_here
        del model
    ref = runs["float32", "cpu"]
    worst, agree, total = compare_logits(
        "[e]", "float32 card vs CPU", runs["float32", DEV], ref,
        atol=F32_TOL, rtol=F32_TOL)
    log(f"[e] long sequence, batch 1, prefill S={LONG_S} ({LONG_S // 128} "
        f"mLSTM chunks of 128) + {LONG_STEPS} decode steps, same weights "
        f"and tokens: float32 compute, card vs CPU: logits max |err| "
        f"{worst} (atol = rtol = {F32_TOL}); greedy tokens agree {agree}/"
        f"{total}; wall card {walls['float32', DEV]:.3f} s, CPU "
        f"{walls['float32', 'cpu']:.3f} s")
    for dev in (DEV, "cpu"):
        got = runs["bfloat16", dev]
        if not all(bool(torch.isfinite(x).all()) for x in got):
            raise AssertionError(f"[e] non-finite bf16 logits on {dev}")
        err = max((a - b).abs().max().item() for a, b in zip(got, ref))
        agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                    for a, b in zip(got, ref))
        log(f"[e]   bf16 compute on {dev} vs float32 on the CPU: logits max "
            f"|err| {err}; greedy tokens agree {agree}/{total}; wall "
            f"{walls['bfloat16', dev]:.3f} s")
    err = max((a - b).abs().max().item() for a, b in
              zip(runs["bfloat16", DEV], runs["bfloat16", "cpu"]))
    log(f"[e]   bf16 compute, card vs CPU: logits max |err| {err} (no "
        f"gate: the two roundings differ by more than {LOGIT_ATOL})")


# ---------------------------------------------------------------------------
# (f) the paper's applications on the card
# ---------------------------------------------------------------------------

APP_RTOL = {"sentiment": 1e-6, "ride_select": 1e-6, "fraud_svm": 1e-5,
            "traffic_metrics": 1e-6}
OCAMPO_USERS = (20, 40, 60, 80, 100)
OCAMPO_HORIZON = 30.0   # the benchmark's own horizon (s of sim time)


def app_spec(query, device, **cfg):
    """The topology of tests/test_engine_apps.py: a broker, one SPE
    running ``query`` on ``device``, a METRICS sink on its output."""
    from repro_torch.core import PipelineSpec
    spec = PipelineSpec(mode="zk")
    spec.add_switch("s1")
    for h in ("b", "w", "c"):
        spec.add_host(h).add_link(h, "s1", lat=1.0, bw=1000.0)
    spec.add_broker("b")
    spec.add_topic(cfg["inTopic"], leader="b")
    spec.add_topic(cfg["outTopic"], leader="b")
    spec.add_spe("w", query=query, device=device, **cfg)
    sink = spec.add_consumer("c", "METRICS", topic=cfg["outTopic"],
                             pollInterval=0.05)
    return spec, sink


def run_app(name, device):
    """One application pipeline; returns (engine, sink payloads)."""
    import numpy as np
    from repro_torch.core import Engine
    from repro_torch.core import store
    store.reset_registry()
    rows, horizon = [], 10.0
    if name == "sentiment":
        spec, sink = app_spec("sentiment", device, inTopic="tweets",
                              outTopic="scores")
        spec.add_host("p").add_link("p", "s1", lat=1.0, bw=1000.0)
        spec.add_producer("p", "DIRECTORY", topic="tweets",
                          docs=["good great love", "terrible awful bad"],
                          totalMessages=2, interval=0.2)
    elif name == "ride_select":
        spec, sink = app_spec("ride_select", device, inTopic="rides",
                              outTopic="best", window=1.0)
        rows = [{"area": "A", "tip": 1.0}, {"area": "B", "tip": 5.0},
                {"area": "B", "tip": 7.0}, {"area": "A", "tip": 2.0}]
        horizon = 8.0
    elif name == "fraud_svm":
        spec, sink = app_spec("fraud_svm", device, inTopic="txn",
                              outTopic="fraud", window=1.0, dim=8)
        rng = np.random.default_rng(1)
        rows = ([{"x": rng.normal(0, 1, 8).tolist()} for _ in range(10)]
                + [{"x": rng.normal(2.5, 1, 8).tolist()} for _ in range(5)])
    else:
        spec, sink = app_spec("traffic_metrics", device, inTopic="pkts",
                              outTopic="stats", window=1.0,
                              pollInterval=0.2)
        for i in range(6):
            spec.add_host(f"u{i}").add_link(f"u{i}", "s1", lat=0.5,
                                            bw=100.0)
            spec.add_producer(f"u{i}", "PACKET", topic="pkts",
                              ratePps=20.0, pktBytes=256)
        horizon = 6.0
    eng = Engine(spec, seed=0)
    if rows:   # injected straight through the broker, as the tests do
        in_topic = {"ride_select": "rides", "fraud_svm": "txn"}[name]
        eng.schedule(0.1, lambda: [
            eng.cluster.produce("b", "t", in_topic, r, 64) for r in rows])
    eng.run(until=horizon)
    rt = [rt for rt in eng.runtimes if rt.name == sink.name][0]
    return eng, [p.get("data", p) for p in rt.payloads]


def check_c3(path, got, want, rtol) -> None:
    """ROADMAP C3: same structure; ints, strings and bools exact; floats
    allclose at rtol with atol = rtol (the summed terms are of order 1)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            raise AssertionError(f"[f] {path}: keys differ")
        for k in want:
            check_c3(f"{path}.{k}", got[k], want[k], rtol)
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"[f] {path}: lengths differ")
        for i, (a, b) in enumerate(zip(got, want)):
            check_c3(f"{path}[{i}]", a, b, rtol)
    elif isinstance(want, float):
        if not (isinstance(got, float)
                and abs(got - want) <= rtol + rtol * abs(want)):
            raise AssertionError(f"[f] {path}: card {got} vs CPU {want} "
                                 f"(rtol = atol = {rtol})")
    elif type(got) is not type(want) or got != want:
        raise AssertionError(f"[f] {path}: card {got} vs CPU {want}")


def wall_free(m: dict) -> dict:
    return {k: v for k, v in m.items()
            if k not in ("wall_s", "profile_wall")}


def ocampo(n_users: int, horizon: float, device: str):
    """The Ocampo scenario of benchmarks/fig7_reproductions.py (spec
    copied): a broker, a one-node SPE running traffic_metrics over 1 s
    windows, n_users packet generators at 20 packets/s.  Returns the
    measured ``spe_exec`` walls and the records of each window."""
    from repro_torch.core import Engine, PipelineSpec
    spec = PipelineSpec()
    spec.add_switch("s1")
    spec.add_host("b").add_link("b", "s1", lat=0.5, bw=1000.0)
    spec.add_broker("b")
    spec.add_topic("pkts", leader="b")
    spec.add_host("spark").add_link("spark", "s1", lat=0.5, bw=1000.0)
    spec.add_spe("spark", query="traffic_metrics", inTopic="pkts",
                 window=1.0, pollInterval=0.2, device=device)
    for i in range(n_users):
        h = f"u{i}"
        spec.add_host(h).add_link(h, "s1", lat=0.5, bw=100.0)
        spec.add_producer(h, "PACKET", topic="pkts", ratePps=20.0,
                          pktBytes=256)
    eng = Engine(spec, seed=n_users)
    mon = eng.run(until=horizon)
    ex = mon.events_of("spe_exec")
    return [e["wall"] for e in ex], [e["records"] for e in ex]


def phase_f() -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    t_start = time.perf_counter()
    for name in APP_RTOL:
        fa.launches = 0
        fd.launches = 0
        card_eng, card = run_app(name, DEV)
        if fa.launches or fd.launches:
            raise AssertionError(f"[f] {name}: attention kernels launched")
        cpu_eng, cpu = run_app(name, "cpu")
        if not cpu:
            raise AssertionError(f"[f] {name}: no output on the CPU")
        check_c3(name, card, cpu, APP_RTOL[name])
        if wall_free(card_eng.metrics()) != wall_free(cpu_eng.metrics()):
            raise AssertionError(f"[f] {name}: engine metrics differ "
                                 "between the card and the CPU")
        log(f"[f] {name}: {len(card)} sink payloads on the card agree with "
            f"the CPU's (rtol = atol = {APP_RTOL[name]}); attention kernel "
            f"launches 0 (none on this path); first: "
            f"{json.dumps(card[0], default=str)[:160]}")
    # the device path really ran: kernels of one traffic pipeline
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_app("traffic_metrics", DEV)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        raise AssertionError("[f] no kernel ran on the card")
    log(f"[f] traffic_metrics pipeline (6 users, 6 s): "
        f"{sum(r[1] for r in rows)} kernels, device busy "
        f"{sum(r[0] for r in rows):.3f} ms")
    base = None
    for n in OCAMPO_USERS:
        walls, records = ocampo(n, OCAMPO_HORIZON, DEV)
        if not walls:
            raise AssertionError(f"[f] ocampo {n} users: no window ran")
        # fig7_reproductions.ocampo: the mean after the first two windows
        mean = float(np.mean(walls[2:]) if len(walls) > 4
                     else np.mean(walls))
        base = base or mean
        log(f"[f] fig7b ocampo users={n}: {len(walls)} windows, mean "
            f"spe_exec wall {mean} s ({mean / base:.3f} x 20 users), "
            f"records per window {int(np.mean(records))}")
    log(f"[f] horizon {OCAMPO_HORIZON} s of sim time (not cut); phase "
        f"wall {time.perf_counter() - t_start:.1f} s")


# ---------------------------------------------------------------------------
# (g) training on the card
# ---------------------------------------------------------------------------

GEMMA = "gemma2-2b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 6
# gemma2-2b training attention: q (4,1024,8,256), k/v 4 heads, softcap 50;
# window 4096 on the local layers, none on the global ones
GEMMA_TRAIN = dict(B=TRAIN_B, S=TRAIN_S, NH=8, KV=4, hd=256, cap=50.0)
GEMMA_WINDOWS = (4096, 0)
# (g2): loss and gradients of a 2-layer full-width gemma2-2b, the kernel's
# forward against the plain version's, as (loss rtol, gradient relative L2
# error per leaf).  bf16 (the trained configuration): the two forwards
# round each attention output to bf16 at other places (1 ulp, 2**-8
# relative); that difference passes through ~10 bf16-rounded operations
# per layer and the tied embedding's two gradient paths, so each leaf's
# gradient may move by a few per cent.  float32 params and compute (the
# kernel's float32 body): the kernel agrees with the plain version to
# ~1e-6 relative, and so do the gradients, up to ~1e-5.  A fault (a cut
# graph, a wrong scale or mask) moves a gradient by O(1).
G2_TOL = {"bfloat16": (1e-3, 5e-2), "float32": (1e-5, 1e-4)}
# (g4): losses after the restart against an unbroken run, float32 smoke
# configs: the restored state is exact and the replay runs the same
# kernels on the same inputs
G4_RTOL = 1e-5
H100_BF16 = PEAK_FLOPS["bfloat16"]


def phase_g1(rnd) -> float:
    """flash_attention as an autograd function on the card: one kernel
    launch per forward, the forward within TOL of ref.attention, and the
    grads of q, k, v equal (exactly) to autograd through ref.attention
    given the same upstream grad."""
    import torch
    from repro_torch.kernels import flash_attention as fa, ops, ref
    cases = FWD_CASES + [(GEMMA_TRAIN["B"], GEMMA_TRAIN["S"],
                          GEMMA_TRAIN["NH"], GEMMA_TRAIN["KV"],
                          GEMMA_TRAIN["hd"], w, GEMMA_TRAIN["cap"])
                         for w in GEMMA_WINDOWS]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for (B, S, NH, KV, hd, window, cap) in cases:
            q, k, v = (rnd(shape, dtype).requires_grad_() for shape in
                       ((B, S, NH, hd), (B, S, KV, hd), (B, S, KV, hd)))
            g = rnd((B, S, NH, hd), dtype)
            scale = hd ** -0.5
            before = fa.launches
            out = ops.flash_attention(q, k, v, scale, True, window, cap)
            plain = ref.attention(q, k, v, scale=scale, window=window,
                                  softcap=cap)
            label = f"[g1] {(B, S, NH, KV, hd, window, cap)} {dtype}"
            err = check_close(label, out.detach(), plain.detach(),
                              TOL[str(dtype).split(".")[1]])
            got = torch.autograd.grad(out, (q, k, v), g)
            want = torch.autograd.grad(plain, (q, k, v), g)
            if fa.launches != before + 1:
                raise AssertionError(f"{label}: {fa.launches - before} "
                                     "kernel launches for one forward")
            for name, a, b in zip("qkv", got, want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{label}: d{name} differs from autograd through "
                        f"ref.attention by {(a - b).abs().max().item()}")
            if S == GEMMA_TRAIN["S"] and dtype == torch.bfloat16:
                worst = max(worst, err)
    log(f"[g1] {2 * len(cases)} cases (the kernel cases and gemma2-2b's "
        f"training shapes, float32 and bf16): one launch per forward, "
        f"forward within TOL of ref.attention (gemma2 training shape bf16 "
        f"max |err| {worst}), grads of q, k, v equal to autograd through "
        f"ref.attention bit for bit")
    torch.cuda.empty_cache()
    return worst


def loss_and_grads(model, batch):
    import torch
    params = dict(model.named_parameters())
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def train_batch(cfg, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1),
                         generator=g, device="cuda")
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def phase_g2() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(GEMMA), n_layers=2)
    weights = Model(cfg, device="cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0)).state_dict()
    batch = train_batch(cfg, 1)
    for dtype, (loss_rtol, grad_rel) in G2_TOL.items():
        model = Model(dataclasses.replace(cfg, param_dtype=dtype,
                                          compute_dtype=dtype), device="cuda")
        model.load_state_dict(weights)
        model.requires_grad_(True)
        with plain_attention():
            loss_p, grads_p = loss_and_grads(model, batch)
        before = fa.launches
        loss_k, grads_k = loss_and_grads(model, batch)
        n = fa.launches - before
        tag = f"[g2] {dtype}:"
        if n != 2 * cfg.n_layers:   # remat full: forward and recompute
            raise AssertionError(f"{tag} {n} kernel launches, expected "
                                 f"{2 * cfg.n_layers}")
        if not (torch.isfinite(loss_k) and torch.isfinite(loss_p)):
            raise AssertionError(f"{tag} non-finite loss {loss_k} / "
                                 f"{loss_p}")
        d_loss = abs(loss_k.item() - loss_p.item())
        if d_loss > loss_rtol * abs(loss_p.item()):
            raise AssertionError(f"{tag} loss {loss_k.item()} vs plain "
                                 f"{loss_p.item()} (rtol {loss_rtol})")
        rel = {}
        for key, gp in grads_p.items():
            gk = grads_k[key].float()
            gp = gp.float()
            if not torch.isfinite(gk).all():
                raise AssertionError(f"{tag} non-finite gradient of {key}")
            rel[key] = ((gk - gp).norm() / gp.norm().clamp(min=1e-30)).item()
        bad = {k: r for k, r in rel.items() if r > grad_rel}
        if bad:
            raise AssertionError(f"{tag} gradients off by more than "
                                 f"{grad_rel} relative L2: {bad}")
        for key in ("wq", "wk", "wv"):
            if grads_k[f"groups.0.l0.mixer.{key}"].abs().max() == 0:
                raise AssertionError(f"{tag} no gradient reaches {key}")
        worst = max(rel, key=rel.get)
        log(f"[g2] {GEMMA} full width, 2 layers (local, global), {dtype} "
            f"params and compute, batch {TRAIN_B} x {TRAIN_S}, remat full: "
            f"loss + backward, kernel vs plain: loss {loss_k.item()} vs "
            f"{loss_p.item()} (|diff| {d_loss}, rtol {loss_rtol}); gradient "
            f"relative L2 error, worst {rel[worst]} ({worst}), median "
            f"{statistics.median(rel.values())} over {len(rel)} leaves "
            f"(gate {grad_rel}); {n} kernel launches")
        del model, grads_p, grads_k
        gc.collect()
        torch.cuda.empty_cache()


class observe_train:
    """Observe (do not alter) an ElasticTrainer run: the wall of each step
    (synchronized), the flash_attention launches of each step, the loss
    of each step, and a host copy of the parameters before the first."""

    def __init__(self):
        self.walls, self.launches, self.losses = [], [], []
        self.before = None

    def __enter__(self):
        import torch
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.runtime import ElasticTrainer
        self.saved = ElasticTrainer._compile
        obs = self

        def compile_observed(trainer):
            obs.saved(trainer)
            step = trainer._step_fn

            def observed(state, batch):
                if obs.before is None:
                    obs.before = {k: p.detach().cpu() for k, p in
                                  state["params"].state_dict().items()}
                torch.cuda.synchronize()
                n0 = fa.launches
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                obs.losses.append(float(metrics["loss"]))
                torch.cuda.synchronize()
                obs.walls.append(time.perf_counter() - t0)
                obs.launches.append(fa.launches - n0)
                return state, metrics

            trainer._step_fn = observed

        ElasticTrainer._compile = compile_observed
        return self

    def __exit__(self, *exc):
        from repro_torch.runtime import ElasticTrainer
        ElasticTrainer._compile = self.saved


def phase_g3() -> dict:
    """The slice's main path: ``python -m repro_torch.launch.train --arch
    gemma2-2b --steps 6 --batch 4 --seq 1024`` (full width and depth, on
    the card) in-process, then one profiled step."""
    import torch
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    args = train.parse_args(["--arch", GEMMA, "--steps", str(TRAIN_STEPS),
                             "--batch", str(TRAIN_B), "--seq",
                             str(TRAIN_S)])
    torch.cuda.reset_peak_memory_stats()
    with observe_train() as obs:
        fa.launches = 0
        fd.launches = 0
        t0 = time.perf_counter()
        cfg, trainer, state = train.run(args)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches,
                    "flash_decode": fd.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # remat full: each attention layer's kernel runs in the forward pass
    # and again when its group is recomputed in the backward pass; the
    # backward of the autograd function recomputes through ref.attention
    # (no kernel)
    per_step = 2 * cfg.n_layers
    if obs.launches != [per_step] * TRAIN_STEPS:
        raise AssertionError(f"[g3] flash_attention launches per step "
                             f"{obs.launches}, expected {per_step}")
    if launches != {"flash_attention": per_step * TRAIN_STEPS,
                    "flash_decode": 0}:
        raise AssertionError(f"[g3] launches {launches}")
    losses = trainer.report.losses
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[g3] losses {losses}")
    changed = total = 0
    for key, p in state["params"].state_dict().items():
        ne = int((p.detach().cpu() != obs.before[key]).sum())
        changed, total = changed + ne, total + p.numel()
    m_nonzero = sum(int((m != 0).sum()) for m in state["opt"]["m"].values())
    if changed == 0 or m_nonzero == 0:
        raise AssertionError(f"[g3] the state did not move: {changed} "
                             f"parameter entries changed, {m_nonzero} "
                             "nonzero first moments")
    n_params = sum(p.numel() for p in state["params"].parameters())
    tokens = TRAIN_B * TRAIN_S
    step_s = statistics.median(obs.walls[1:])
    # 6 N T for the forward and backward passes, + 2 N T for the remat
    # forward (the trunk's groups and the loss head's chunks)
    flops = 8.0 * n_params * tokens
    log(f"[g3] {GEMMA} full width and depth ({cfg.n_layers} layers, d="
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params} bf16 params, "
        f"float32 AdamW state, remat {cfg.remat}), batch {TRAIN_B} x "
        f"{TRAIN_S}: losses {losses}; flash_attention launches per step "
        f"{obs.launches} ({cfg.n_layers} forward + {cfg.n_layers} remat "
        f"recompute); parameter entries changed {changed}/{total} (lr "
        f"{3e-4 / 2000:.3g}..{3e-4 * TRAIN_STEPS / 2000:.3g} in the warmup "
        f"moves only bf16 values near 0); engine wall {wall:.3f} s")
    log(f"[g3] {gpu_line()}: wall per step {obs.walls} s; median of "
        f"steps 2-{TRAIN_STEPS} {step_s} s; {tokens / step_s} tokens/s; peak "
        f"device memory {peak:.3f} GiB; model FLOPs per step {flops:.4g} "
        f"(8 N T), {flops / step_s / 1e12:.2f} TFLOP/s = "
        f"{flops / step_s / H100_BF16:.4f} of {H100_BF16:.3g}")
    profile_train_step(trainer, state, step_s)
    out = dict(launches=launches["flash_attention"], step_s=step_s,
               tokens_per_s=tokens / step_s, peak_gib=peak)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_train_step(trainer, state, step_s) -> None:
    """One more step under torch.profiler: device time by kernel, the
    autograd function's backward (ref.attention recomputed and
    differentiated) and the AdamW update by their ranges, and the idle
    share against the unprofiled step wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamW
    saved = (ops._fa_bwd, AdamW.update)

    def ranged(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    ops._fa_bwd = ranged("g3.fa_bwd", saved[0])
    AdamW.update = ranged("g3.adamw", saved[1])
    batch = trainer.batches(TRAIN_STEPS)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.bundle.step_fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ops._fa_bwd, AdamW.update = saved
    # the ranges' own device rows (their spans) are not kernels
    rows = [r for r in device_rows(prof) if not r[2].startswith("g3.")]
    busy = sum(r[0] for r in rows)
    ranges = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("g3."):
            ranges[e.name] = ranges.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    fa_ms = sum(r[0] for r in rows if "fa_fwd" in r[2])
    gemm = [r for r in rows if any(s in r[2].lower() for s in (
        "gemm", "nvjet", "xmma", "cutlass"))]
    gemm_ms = sum(r[0] for r in gemm)
    log(f"[g3] profiled step: wall {wall_ms:.3f} ms (unprofiled median "
        f"{step_s * 1e3:.3f} ms), {sum(r[1] for r in rows)} kernels, device "
        f"busy {busy:.3f} ms: idle share {1 - busy / (step_s * 1e3):.4f} "
        f"of the unprofiled wall")
    log(f"[g3]   flash_attention kernel {fa_ms:.3f} ms "
        f"({sum(r[1] for r in rows if 'fa_fwd' in r[2])} calls); "
        f"attention backward (ref.attention recomputed and differentiated, "
        f"float32) {ranges.get('g3.fa_bwd', 0.0):.3f} ms; AdamW update "
        f"{ranges.get('g3.adamw', 0.0):.3f} ms; GEMM kernels (all, the "
        f"attention backward's included) {gemm_ms:.3f} ms in "
        f"{sum(r[1] for r in gemm)} calls; other "
        f"{busy - fa_ms - gemm_ms:.3f} ms")
    if ranges.get("g3.fa_bwd", 0.0) <= 0 or ranges.get("g3.adamw", 0.0) <= 0:
        log("[g3]   (a range shows no device time: the profiler did not "
            "attribute kernels to it)")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        log(f"[g3]   {ms:.3f} ms device, {n} calls: {key[:90]}")


def phase_g4() -> None:
    """Checkpoint round trip on the card: an injected failure at step 3,
    a restore from the step-2 checkpoint, the replay; the losses are those
    of an unbroken run."""
    import tempfile
    import torch
    from repro_torch.launch import train
    from repro_torch.runtime import ElasticTrainer
    for arch in ("xlstm-125m", "qwen2-7b"):
        cfg, bundle, batches = train.build(arch, smoke=True, batch=2,
                                           seq=64, device=DEV)
        runs = {}
        for broken in (True, False):
            with tempfile.TemporaryDirectory() as tmp:
                trainer = ElasticTrainer(bundle, batches, ckpt_dir=tmp,
                                         ckpt_every=2, log_fn=lambda s: None)
                if broken:
                    trainer.inject_failure(at_step=3)
                trainer.run(bundle.init_fn(
                    torch.Generator(device=DEV).manual_seed(0)), steps=6)
                runs[broken] = trainer.report
        r, clean = runs[True], runs[False]
        if r.restarts != 1 or r.steps_run != 7 or clean.restarts != 0:
            raise AssertionError(f"[g4] {arch}: restarts {r.restarts}, "
                                 f"steps run {r.steps_run}")
        # steps 0-2, then step 2 again from the checkpoint, then 3-5
        replay = r.losses[:3] + r.losses[4:]
        err = max(abs(a - b) / abs(b) for a, b in zip(replay, clean.losses))
        if len(replay) != 6 or err > G4_RTOL or \
                abs(r.losses[3] - r.losses[2]) > G4_RTOL * abs(r.losses[2]):
            raise AssertionError(f"[g4] {arch}: losses {r.losses} vs "
                                 f"unbroken {clean.losses}")
        log(f"[g4] {arch} smoke on {DEV}: failure at step 3, restored from "
            f"the step-2 checkpoint, 1 restart; losses after the replay vs "
            f"an unbroken run: max relative |diff| {err} (rtol {G4_RTOL})")


def phase_g5() -> None:
    """``repro_torch.launch.train --gym --arch xlstm-125m --full --steps 4
    --batch 8 --seq 128`` on the card: 4 metric messages, no attention
    kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    args = train.parse_args(["--gym", "--arch", "xlstm-125m", "--full",
                             "--steps", "4", "--batch", "8", "--seq", "128",
                             "--device", DEV])
    fa.launches = 0
    t0 = time.perf_counter()
    eng, sink, losses = train.run_gym(args)
    wall = time.perf_counter() - t0
    if fa.launches:
        raise AssertionError(f"[g5] {fa.launches} attention launches")
    if len(losses) != 4 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[g5] metric messages {losses}")
    log(f"[g5] gym training, xlstm-125m full width on {DEV}, batch 8 x 128:"
        f" {len(losses)} metric messages, losses {losses}; attention kernel "
        f"launches 0; engine wall {wall:.3f} s")
    del eng, sink
    gc.collect()
    torch.cuda.empty_cache()


def phase_g(rnd) -> dict:
    t0 = time.perf_counter()
    err = phase_g1(rnd)
    phase_g2()
    main = phase_g3()
    phase_g4()
    phase_g5()
    timed = {f"window {w}": time_prefill(
        rnd, f"gemma2 training shape, window {w}", GEMMA_TRAIN["B"],
        GEMMA_TRAIN["S"], GEMMA_TRAIN["NH"], GEMMA_TRAIN["KV"],
        GEMMA_TRAIN["hd"], window=w, cap=GEMMA_TRAIN["cap"])
        for w in GEMMA_WINDOWS}
    log(f"[g] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(main, max_abs_err=err, timed=timed)


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
    phase_e()
    phase_f()
    train = phase_g(rnd)
    kernels = []
    for name, src, replaces, design in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:81",
             "mma.sync+cp.async"),
            ("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode.py:68", "split-k+cp.async")):
        t = times[name]
        # training (g3): launches over its 6 steps, and the kernel timed at
        # gemma2-2b's training shape (local layers: window 4096)
        tr = {"launches": 0}
        if name == "flash_attention":
            tr = {"launches": train["launches"],
                  "max_abs_err": train["max_abs_err"],
                  **train["timed"]["window 4096"]}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **t,
                        "bound_share": t["bound_ms"] / t["ms"],
                        "design": design, "train": tr})
    log(f"[done] torch {torch.__version__} (cuda {torch.version.cuda}); "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
