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
         xlstm-125m at full width (``--gym --full``);
  (h)    granite-moe-3b-a800m at full width and depth (32 layers, 40
         experts top-8, hd=64 with 3 query heads per KV head, bf16):
         ``repro_torch.launch.serve --arch granite-moe-3b-a800m --full``
         serving 4 requests through the gym, with exact launch counts, wall
         per request, kernels per request, idle share and peak memory; both
         kernels held against their plain versions and timed at its
         shapes; the gate: 2 full-width layers in float32 compute, kernels
         vs plain, logits within F32_TOL and the routing decisions that
         differ counted;
  (i)    jamba-v0.1-52b at full width, one period of its pattern (8 of 32
         layers: 7 mamba, 1 attention, 4 MLP, 4 MoE; hd=128 with 4 query
         heads per KV head; bf16): ``serve --arch jamba-v0.1-52b --full``
         with the config cut to that depth (``cut_depth``), serving 2
         requests with exact launch counts, a profiled request (idle
         share, the attention kernels that ran) and peak memory, then one
         prefill of 256 tokens (the chunked scan) with finite logits and
         states; both kernels held against their plain versions and
         timed at its shapes;
  (j)    training through the mesh step, on a process group of one NCCL
         rank (a FileStore in a temporary directory): (j1)
         granite-moe-3b-a800m at full width and depth with ``ep_shard``,
         6 steps at 4 x 1024 through ``ElasticTrainer`` with the bundle of
         ``make_step_bundle(cfg, shape, mesh)`` on the (1, 1) ("data",
         "model") mesh, every leaf a DTensor, through the tensor-parallel
         code of the attention, embedding and loss (the plan printed and
         its kinds asserted; on one rank its collectives are identities):
         64 flash_attention launches per step and the expert-parallel
         route in every MoE call asserted, wall per step, tokens/s, peak
         memory, model FLOPs share (active parameters) and one profiled
         step; (j2) 2 full-width
         layers in float32, one step of the mesh + EP route against the
         mesh-free dense step (loss, every first moment, every routing
         decision) and kernel against plain; (j3) a (1, 1, 1) ("pod",
         "data", "model") mesh with int8 compression: the step's mean and
         error feedback against the plain quantizer; (j4) restore_tree
         onto the mesh's placements, the next loss equal to an unbroken
         run's; the kernel held and timed at granite's training shape;
         (j5) flash_attention at the local heads that tensor parallelism
         hands it (qwen2-7b on 4 ranks, gemma2-2b on 2), forward and
         backward through the autograd function against ref.attention,
         and the kernel timed with its bound and SDPA.
  (k)    serving through the prefill and decode step bundles on the (1, 1)
         ("data", "model") mesh of one NCCL rank: qwen2-7b at full width
         and depth (28 layers, bf16, random weights from a seed): one
         prefill at prefill_32k's seq 32768 (batch cut 32 -> 1; 28
         flash_attention launches asserted), then 8 decode steps at
         decode_32k's seq 32768, positions 32760-32767 (batch cut 128 ->
         8; 28 flash_decode launches a step asserted) on a bf16 cache
         drawn from a seed; logits and caches held bit for bit against
         ``Model.prefill`` / ``Model.decode_step`` on the same parameters
         (the decode on a copy of the cache); walls, peak memory, idle
         shares.  Both kernels checked and timed at those shapes, and
         flash-decode's partials mode on 4 sequence chunks of one layer's
         cache, combined, held against whole flash_decode and
         ``ref.decode_split(..., partials=True)`` (a window, chunks with
         no valid key) and timed with the bound of the same decode; the
         host cost of flash_decode's ``torch.library`` operator per call
         and per decode step.
  (l)    the dry run (``repro_torch.launch.dryrun``): qwen2-7b at
         prefill_32k and decode_32k on the fake 16x16 mesh (rank 0 of 256
         fake ranks, in a process of its own), each roofline line
         printed; (k)'s two one-card cells traced on fake CUDA tensors and
         on fake meta tensors (a host without CUDA's trace), their FLOPs
         equal to the FLOPs counted on real CUDA tensors in (k) and no
         kernel launched; t_compute, t_memory and their max beside (k)'s
         measured device times.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, when no GPU is present or the port is missing.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib
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


def check_rows(name, out, want, tol) -> float:
    """``check_close`` with the tolerance scaled to what is compared: an
    attention output row (the last dim) is held at atol = ``tol`` times
    its largest |want| where that is below 1, and rtol = ``tol``.  Over
    tens of thousands of keys the outputs are ~1e-2, below ``tol``
    itself, so an unscaled atol would pass a kernel that drops keys."""
    import torch
    torch.cuda.synchronize()
    o, w = out.float(), want.float()
    scale = w.abs().amax(dim=-1, keepdim=True).clamp(max=1.0)
    err = (o - w).abs()
    excess = (err - tol * (scale + w.abs())).max().item()
    if excess > 0:
        raise AssertionError(f"{name}: kernel vs plain max |err| "
                             f"{err.max().item()}, {excess} over atol = "
                             f"{tol} x the row's max |want|, rtol = {tol}")
    return err.max().item()


def expect_rejected(name, out, want, tol) -> None:
    """The negative control of ``check_rows``: ``out``, a plain result
    with keys left out, must fail it."""
    try:
        check_rows(name, out, want, tol)
    except AssertionError:
        log(f"[k] negative control rejected: {name} (max change "
            f"{(out.float() - want.float()).abs().max().item()})")
        return
    raise AssertionError(f"{name}: a result without some of its keys "
                         f"passes check_rows at {tol}: the gate cannot "
                         "see a dropped split or tile")


def fwd_case(rnd, B, S, NH, KV, hd, window, cap, dtype):
    from repro_torch.kernels import ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
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
    from repro_torch.kernels import ref
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    kw = dict(scale=q.shape[-1] ** -0.5, window=window, softcap=cap)
    out = fd.flash_decode(q, kc, vc, pos, **kw)
    want = ref.decode(q, kc, vc, pos, **kw)
    return check_rows(f"flash_decode {label}", out, want, tol)


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
    from repro_torch.kernels import ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
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
    from repro_torch.kernels import ref
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
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
    err = check_rows(f"flash_decode {label}",
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


class cut_depth:
    """Serve ``arch`` cut to its first ``n_layers`` layers (a multiple of
    its pattern's period; ``None`` cuts nothing): the query's build looks
    its config up in ``repro_torch.configs``, which returns the cut
    config for ``arch`` with every width as published."""

    def __init__(self, arch: str, n_layers=None):
        self.arch, self.n_layers = arch, n_layers

    def __enter__(self):
        import repro_torch.configs as configs
        self.saved = get = configs.get_config
        if self.n_layers:
            configs.get_config = lambda name: (
                dataclasses.replace(get(name), n_layers=self.n_layers)
                if name == self.arch else get(name))
        return self

    def __exit__(self, *exc):
        import repro_torch.configs as configs
        configs.get_config = self.saved


def serve_full(arch: str, params=None, requests: int = N_REQUESTS,
               n_layers=None):
    """``repro_torch.launch.serve --arch <arch> --full --device cuda``
    (with ``n_layers``, the arch cut to that depth): ``requests``
    requests of batch MAIN_B, seq MAIN_S, gen MAIN_GEN through the port's
    gym, the kernels' launch counts set to 0 just before and read just
    after.  Returns (engine, sink runtime, observer, engine wall s,
    launches)."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    from repro_torch.launch import serve
    args = serve.parse_args([
        "--arch", arch, "--full", "--device", DEV,
        "--requests", str(requests), "--batch", str(MAIN_B),
        "--seq", str(MAIN_S), "--gen", str(MAIN_GEN)])
    torch.cuda.reset_peak_memory_stats()
    with observe_serve(params) as obs, cut_depth(arch, n_layers):
        fa.launches = 0
        fd.launches = 0
        t0 = time.perf_counter()
        eng, sink_rt = serve.run(args)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches,
                    "flash_decode": fd.launches}
    return eng, sink_rt, obs, wall, launches


def check_responses(tag, sink_rt, vocab, finite,
                    requests: int = N_REQUESTS) -> None:
    import numpy as np
    import torch
    if sink_rt.n_received != requests:
        raise AssertionError(f"{tag} {sink_rt.n_received}/{requests} "
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
    splits = decode_splits("[d]", **QWEN)
    rows = profile_request("[d]", eng, obs.walls)["rows"]
    attention_kernel_check("[d]", rows, N_LAYERS)
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


def decode_splits(tag, NH, KV, hd) -> dict:
    """The split count of each decode step of a served path (bf16 q, the
    model's float32 (B,KV,hd,S) K cache); all must be 1."""
    import torch
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    q = torch.empty((MAIN_B, NH, hd), dtype=torch.bfloat16, device="cuda")
    kc = torch.empty((MAIN_B, KV, hd, MAIN_MAXLEN),
                     device="cuda").permute(0, 3, 1, 2)
    splits = {pos: fd.plan(q, kc, pos)
              for pos in range(MAIN_S, MAIN_S + MAIN_GEN - 1)}
    if set(splits.values()) != {1}:
        raise AssertionError(f"{tag} decode splits {splits}")
    return splits


def device_rows(prof) -> list:
    """(device ms, calls, name) of each kernel in a profile: kernel rows
    only, since an operator's row repeats its kernels' time."""
    import torch
    return [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_request(tag, eng, walls, vocab: int = 512) -> dict:
    """One more request through the served query under torch.profiler:
    the device's busy time by kernel against the request's wall time.
    Returns the kernel rows, the kernel count, the busy ms, the median
    unprofiled wall ms of requests 2.. and the idle share of that wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    query = served_query(eng)
    g = torch.Generator(device=DEV).manual_seed(2)
    toks = torch.randint(0, vocab, (MAIN_B, MAIN_S), generator=g,
                         device=DEV)
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
    return dict(rows=rows, kernels=sum(r[1] for r in rows), busy_ms=busy_ms,
                steady_ms=steady, idle_share=1 - busy_ms / steady)


def attention_kernel_check(tag, rows, n_attn: int) -> None:
    """The profiled request's attention ran through the redesigned
    kernels: the tensor-core prefill once per attention layer, the split
    decode once per attention layer and step, no combine (one split) and
    no float32 body."""
    got = {name: [sum(r[1] for r in rows if name in r[2]),
                  sum(r[0] for r in rows if name in r[2])]
           for name in ATTN_KERNELS}
    want = {name: 0 for name in ATTN_KERNELS}
    want.update(fa_fwd_bf16_mma=n_attn,
                fd_split_kernel=n_attn * (MAIN_GEN - 1))
    if {name: n for name, (n, _) in got.items()} != want:
        raise AssertionError(f"{tag} attention kernel calls in the profiled "
                             f"request {got}, expected {want}")
    log(f"{tag} attention kernels of the profiled request: " + ", ".join(
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
    rows = profile_request("[e]", eng, obs.walls)["rows"]
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
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
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


def autograd_case(rnd, B, S, NH, KV, hd, window, cap, dtype) -> float:
    """flash_attention as an autograd function on the card at one shape:
    one kernel launch per forward, the forward within TOL of
    ref.attention, and the grads of q, k, v equal (exactly) to autograd
    through ref.attention given the same upstream grad.  Returns the
    forward's max |err|."""
    import torch
    from repro_torch.kernels import ops, ref
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q, k, v = (rnd(shape, dtype).requires_grad_() for shape in
               ((B, S, NH, hd), (B, S, KV, hd), (B, S, KV, hd)))
    g = rnd((B, S, NH, hd), dtype)
    scale = hd ** -0.5
    before = fa.launches
    out = ops.flash_attention(q, k, v, scale, True, window, cap)
    plain = ref.attention(q, k, v, scale=scale, window=window, softcap=cap)
    label = f"{(B, S, NH, KV, hd, window, cap)} {dtype}"
    err = check_close(label, out.detach(), plain.detach(),
                      TOL[str(dtype).split(".")[1]])
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(plain, (q, k, v), g)
    if fa.launches != before + 1:
        raise AssertionError(f"{label}: {fa.launches - before} kernel "
                             "launches for one forward")
    for name, a, b in zip("qkv", got, want):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{label}: d{name} differs from autograd through "
                f"ref.attention by {(a - b).abs().max().item()}")
    return err


def phase_g1(rnd) -> float:
    """flash_attention as an autograd function on the card
    (``autograd_case``) at the kernel cases and gemma2-2b's training
    shapes, float32 and bf16."""
    import torch
    cases = FWD_CASES + [(GEMMA_TRAIN["B"], GEMMA_TRAIN["S"],
                          GEMMA_TRAIN["NH"], GEMMA_TRAIN["KV"],
                          GEMMA_TRAIN["hd"], w, GEMMA_TRAIN["cap"])
                         for w in GEMMA_WINDOWS]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            err = autograd_case(rnd, *case, dtype)
            if case[1] == GEMMA_TRAIN["S"] and dtype == torch.bfloat16:
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
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
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
        from repro_torch.distributed.sharding import view_as
        fa = importlib.import_module("repro_torch.kernels.flash_attention")
        from repro_torch.runtime import ElasticTrainer
        self.saved = ElasticTrainer._compile
        obs = self

        def compile_observed(trainer):
            obs.saved(trainer)
            step = trainer._step_fn

            def observed(state, batch):
                if obs.before is None:
                    # a mesh state's leaf is a DTensor: its local tensor
                    obs.before = {k: view_as(p).detach().to(
                        "cpu", copy=True) for k, p in
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
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
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
    profile_train_step("g3", trainer, state, step_s)
    out = dict(launches=launches["flash_attention"], step_s=step_s,
               tokens_per_s=tokens / step_s, peak_gib=peak)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_train_step(tag, trainer, state, step_s) -> dict:
    """One more step under torch.profiler: device time by kernel, the
    autograd function's backward (ref.attention recomputed and
    differentiated) and the AdamW update by their ranges, and the idle
    share against the unprofiled step wall.  ``tag`` names the phase."""
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

    ops._fa_bwd = ranged(f"{tag}.fa_bwd", saved[0])
    AdamW.update = ranged(f"{tag}.adamw", saved[1])
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
    rows = [r for r in device_rows(prof)
            if not r[2].startswith(f"{tag}.")]
    busy = sum(r[0] for r in rows)
    ranges = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and \
                e.name.startswith(f"{tag}."):
            ranges[e.name] = ranges.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    fa_ms = sum(r[0] for r in rows if "fa_fwd" in r[2])
    gemm = [r for r in rows if any(s in r[2].lower() for s in (
        "gemm", "nvjet", "xmma", "cutlass"))]
    gemm_ms = sum(r[0] for r in gemm)
    log(f"[{tag}] profiled step: wall {wall_ms:.3f} ms (unprofiled median "
        f"{step_s * 1e3:.3f} ms), {sum(r[1] for r in rows)} kernels, device "
        f"busy {busy:.3f} ms: idle share {1 - busy / (step_s * 1e3):.4f} "
        f"of the unprofiled wall")
    log(f"[{tag}]   flash_attention kernel {fa_ms:.3f} ms "
        f"({sum(r[1] for r in rows if 'fa_fwd' in r[2])} calls); "
        f"attention backward (ref.attention recomputed and differentiated, "
        f"float32) {ranges.get(f'{tag}.fa_bwd', 0.0):.3f} ms; AdamW update "
        f"{ranges.get(f'{tag}.adamw', 0.0):.3f} ms; GEMM kernels (all, the "
        f"attention backward's included) {gemm_ms:.3f} ms in "
        f"{sum(r[1] for r in gemm)} calls; other "
        f"{busy - fa_ms - gemm_ms:.3f} ms")
    if min(ranges.get(f"{tag}.fa_bwd", 0.0),
           ranges.get(f"{tag}.adamw", 0.0)) <= 0:
        log(f"[{tag}]   (a range shows no device time: the profiler did not "
            "attribute kernels to it)")
    for ms, n, key in sorted(rows, reverse=True)[:10]:
        log(f"[{tag}]   {ms:.3f} ms device, {n} calls: {key[:90]}")
    return dict(busy_ms=busy, idle_share=1 - busy / (step_s * 1e3),
                adamw_ms=ranges.get(f"{tag}.adamw", 0.0), kernels=rows)


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
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
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


# ---------------------------------------------------------------------------
# (h) granite-moe-3b-a800m at full width and depth
# ---------------------------------------------------------------------------

GRANITE = "granite-moe-3b-a800m"
GRANITE_DIMS = dict(NH=24, KV=8, hd=64)    # G = 3
GATE_STEPS = 8


class record_routing:
    """Record the expert ids and keep mask of every MoE layer call (the
    model calls ``repro_torch.models.moe.route`` by module name)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.saved, self.calls = moe.route, []

        def recorded(router, xf, cfg, *group):
            out = self.saved(router, xf, cfg, *group)
            self.calls.append((out[2], out[4]))
            return out

        moe.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.saved


def moe_gate() -> None:
    """2 full-width granite-moe layers (bf16 params drawn from a seed),
    float32 compute: prefill + GATE_STEPS decode steps with the kernels
    against the plain attention, the same tokens fed to both.  Logits
    agree within F32_TOL; the routing decisions that differ are counted
    (a near tie may flip by a last-bit difference in the attention)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(GRANITE), n_layers=2,
                              compute_dtype="float32")
    model = Model(cfg, device=DEV).init_params(
        torch.Generator(device=DEV).manual_seed(0))
    g = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (MAIN_B, MAIN_S), generator=g,
                         device=DEV)
    with plain_attention(), record_routing() as rp:
        plain, fed = greedy_steps(model, toks, GATE_STEPS)
    with record_routing() as rk:
        kern, _ = greedy_steps(model, toks, GATE_STEPS, feed=fed)
    worst, agree, total = compare_logits("[h]", "float32 kernel vs plain",
                                         kern, plain, atol=F32_TOL,
                                         rtol=F32_TOL)
    if len(rp.calls) != len(rk.calls) or not rp.calls:
        raise AssertionError(f"[h] MoE calls {len(rk.calls)} vs "
                             f"{len(rp.calls)}")
    ids_diff = sum(int((a[0] != b[0]).sum()) for a, b in zip(rk.calls,
                                                             rp.calls))
    keep_diff = sum(int((a[1] != b[1]).sum()) for a, b in zip(rk.calls,
                                                              rp.calls))
    pairs = sum(ids.numel() for ids, _ in rk.calls)
    log(f"[h] gate: {GRANITE} full width, 2 layers, float32 compute, "
        f"prefill + {GATE_STEPS} decode steps, kernels vs plain: logits max "
        f"|err| {worst} (atol = rtol = {F32_TOL}); greedy tokens agree "
        f"{agree}/{total}; routing decisions that differ: expert ids "
        f"{ids_diff}/{pairs} (token, choice) pairs, keep {keep_diff}/"
        f"{pairs}, over {len(rk.calls)} MoE calls")
    del model
    torch.cuda.empty_cache()


def host_dispatch_us(n: int = 20000) -> float:
    """Host time to issue one small op (an in-place add on the card),
    averaged over ``n``: the yardstick of a host-bound wall, which moves
    with the load of the machine's shared CPU cores."""
    import torch
    y = torch.zeros(8, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        y.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def kernels_at_shapes(rnd, tag, label, dims) -> tuple[dict, dict]:
    """Each kernel held against its plain version at a served path's
    shapes (prefill of MAIN_B x MAIN_S in bf16; a bf16 q against the
    model's float32 strided cache at the last decode position), then
    timed there against its plain version and SDPA, with its bound.
    Returns (max |err| by kernel, times by kernel)."""
    import torch
    NH, KV, hd = dims["NH"], dims["KV"], dims["hd"]
    pos = MAIN_S + MAIN_GEN - 2
    q, kc, vc = decode_inputs(rnd, MAIN_B, MAIN_MAXLEN, NH, KV, hd,
                              torch.bfloat16, torch.float32)
    errs = {"flash_attention": fwd_case(rnd, MAIN_B, MAIN_S, NH, KV, hd, 0,
                                        0.0, torch.bfloat16),
            "flash_decode": decode_case(q, kc, vc, pos, 0, 0.0,
                                        TOL["bfloat16"],
                                        f"{label} bf16 q, float32 strided "
                                        "cache")}
    log(f"{tag} kernels vs plain at {label}'s shapes (hd={hd}, G="
        f"{NH // KV}): max |err| {errs}")
    timed = {
        "flash_attention": time_prefill(rnd, label, MAIN_B, MAIN_S, **dims),
        "flash_decode": time_decode(rnd, label, MAIN_B, MAIN_MAXLEN, **dims,
                                    pos=pos, kv_dtype=torch.float32),
    }
    if timed["flash_decode"].pop("n_split") != 1:
        raise AssertionError(f"{tag} the timed decode was split")
    return errs, timed


def phase_h(rnd) -> dict:
    """The slice's MoE path: ``repro_torch.launch.serve --arch
    granite-moe-3b-a800m --full`` (32 layers, 40 experts top-8, bf16)."""
    import torch
    t0 = time.perf_counter()
    eng, sink_rt, obs, wall, launches = serve_full(GRANITE)
    query = served_query(eng)
    cfg = query.cfg
    check_responses("[h]", sink_rt, cfg.vocab_size, obs.finite)
    dims = dict(NH=cfg.n_heads, KV=cfg.n_kv_heads, hd=cfg.head_dim_)
    if cfg.n_layers != 32 or dims != GRANITE_DIMS:
        raise AssertionError(f"[h] served {cfg.n_layers} layers, {dims}")
    n_attn = cfg.n_layers
    want = {"flash_attention": n_attn * N_REQUESTS,
            "flash_decode": n_attn * (MAIN_GEN - 1) * N_REQUESTS}
    if launches != want:
        raise AssertionError(f"[h] launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in query.model.parameters())
    splits = decode_splits("[h]", **GRANITE_DIMS)
    dispatch_us = host_dispatch_us()
    prof = profile_request("[h]", eng, obs.walls, cfg.vocab_size)
    attention_kernel_check("[h]", prof["rows"], n_attn)
    log(f"[h] {GRANITE} full width and depth ({cfg.n_layers} layers, "
        f"d={cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim_}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, {n_params} bf16 params): "
        f"{sink_rt.n_received}/{N_REQUESTS} responses, launches {launches} "
        f"= per request {n_attn} flash_attention, {n_attn * (MAIN_GEN - 1)} "
        f"flash_decode")
    log(f"[h] model build {obs.build_s[0]:.3f} s; wall per request (batch "
        f"{MAIN_B}, seq {MAIN_S}, gen {MAIN_GEN}) {obs.walls} s, median of "
        f"requests 2-{N_REQUESTS} {statistics.median(obs.walls[1:])} s; "
        f"kernels per request {prof['kernels']}; idle share "
        f"{prof['idle_share']:.4f}; engine run {wall:.3f} s; peak device "
        f"memory {peak:.3f} GiB; decode splits {splits}; host dispatch of "
        f"one small op {dispatch_us:.2f} us")
    del eng, sink_rt, obs, query
    gc.collect()
    torch.cuda.empty_cache()
    errs, timed = kernels_at_shapes(rnd, "[h]", "granite-moe", GRANITE_DIMS)
    moe_gate()
    log(f"[h] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, timed=timed, errs=errs)


# ---------------------------------------------------------------------------
# (i) jamba-v0.1-52b at full width, one period of its pattern
# ---------------------------------------------------------------------------

JAMBA = "jamba-v0.1-52b"
JAMBA_LAYERS = 8        # one period: 7 mamba, 1 attention, 4 MLP, 4 MoE
JAMBA_D = 4096
JAMBA_DIMS = dict(NH=32, KV=8, hd=128)      # G = 4
JAMBA_REQUESTS = 2
JAMBA_LONG_S = 256      # two scan chunks of 128: the chunked branch


def phase_i(rnd) -> dict:
    """``repro_torch.launch.serve --arch jamba-v0.1-52b --full`` cut to
    one period (JAMBA_LAYERS layers) serving JAMBA_REQUESTS requests, one
    more request profiled, then one prefill of JAMBA_LONG_S tokens
    through the served model; both kernels held against their plain
    versions and timed at jamba's shapes (hd=128, G=4)."""
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    t0 = time.perf_counter()
    eng, sink_rt, obs, wall, launches = serve_full(
        JAMBA, requests=JAMBA_REQUESTS, n_layers=JAMBA_LAYERS)
    query = served_query(eng)
    cfg = query.cfg
    check_responses("[i]", sink_rt, cfg.vocab_size, obs.finite,
                    JAMBA_REQUESTS)
    kinds = collections.Counter(
        k for layer in cfg.layers() for k in (layer.mixer, layer.ffn))
    dims = dict(NH=cfg.n_heads, KV=cfg.n_kv_heads, hd=cfg.head_dim_)
    if cfg.n_layers != JAMBA_LAYERS or cfg.d_model != JAMBA_D or \
            dims != JAMBA_DIMS or \
            kinds != {"mamba": 7, "attn": 1, "mlp": 4, "moe": 4}:
        raise AssertionError(f"[i] served {cfg.n_layers} layers {kinds}, "
                             f"{dims}")
    n_attn = kinds["attn"]
    want = {"flash_attention": n_attn * JAMBA_REQUESTS,
            "flash_decode": n_attn * (MAIN_GEN - 1) * JAMBA_REQUESTS}
    if launches != want:
        raise AssertionError(f"[i] launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in query.model.parameters())
    splits = decode_splits("[i]", **JAMBA_DIMS)
    prof = profile_request("[i]", eng, obs.walls, cfg.vocab_size)
    attention_kernel_check("[i]", prof["rows"], n_attn)
    log(f"[i] {JAMBA} full width, one period ({cfg.n_layers} of 32 layers: "
        f"{dict(kinds)}; d={cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.head_dim_}, d_inner {cfg.d_inner_mamba}, d_state "
        f"{cfg.mamba.d_state}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}, {n_params} params, bf16): "
        f"{sink_rt.n_received}/{JAMBA_REQUESTS} responses, launches "
        f"{launches}")
    log(f"[i] model build {obs.build_s[0]:.3f} s; wall per request (batch "
        f"{MAIN_B}, seq {MAIN_S}, gen {MAIN_GEN}) {obs.walls} s; kernels "
        f"per request {prof['kernels']}; idle share "
        f"{prof['idle_share']:.4f}; engine run {wall:.3f} s; peak device "
        f"memory {peak:.3f} GiB; decode splits {splits}")
    # the chunked scan at full width: one prefill of JAMBA_LONG_S tokens
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=DEV).manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (MAIN_B, JAMBA_LONG_S),
                         generator=g, device=DEV)
    fa.launches = fd.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, cache = query.model.prefill(toks)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t1
    long_launches = (fa.launches, fd.launches)
    long_peak = torch.cuda.max_memory_allocated() / 2**30
    states = [c["mixer"]["ssm"] for gc_ in cache for c in gc_.values()
              if "ssm" in c["mixer"]]
    if logits.shape != (MAIN_B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()) or len(states) != 7 or \
            not all(bool(torch.isfinite(h).all()) for h in states):
        raise AssertionError(f"[i] long prefill: logits {logits.shape}, "
                             f"{len(states)} finite mamba states expected 7")
    if long_launches != (n_attn, 0):
        raise AssertionError(f"[i] long prefill launches {long_launches}")
    log(f"[i] prefill batch {MAIN_B} x {JAMBA_LONG_S} ({JAMBA_LONG_S // 128} "
        f"scan chunks of 128): finite logits and states, flash_attention "
        f"launches {long_launches[0]}; wall {long_s:.3f} s; peak device "
        f"memory {long_peak:.3f} GiB (weights + the (B,S,"
        f"{cfg.d_inner_mamba},{cfg.mamba.d_state}) float32 scan terms)")
    del eng, sink_rt, obs, query, logits, cache, states
    gc.collect()
    torch.cuda.empty_cache()
    errs, timed = kernels_at_shapes(rnd, "[i]", "jamba", JAMBA_DIMS)
    log(f"[i] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, timed=timed, errs=errs)


# ---------------------------------------------------------------------------
# (j) granite-moe-3b-a800m trained through the mesh step
# ---------------------------------------------------------------------------

# granite's training attention: q (4,1024,24,64), k/v 8 heads, causal
GRANITE_TRAIN = dict(B=TRAIN_B, S=TRAIN_S, **GRANITE_DIMS)
# (j5): the local heads that tensor parallelism over "model" hands
# flash_attention, one rank's share of a training shape: qwen2-7b on 4
# ranks (28 query heads, 4 KV heads of 128), gemma2-2b on 2 (8 query heads,
# 4 KV heads of 256, softcap 50, local window 4096 and global)
# (label, B, S, NH, KV, hd, window, softcap)
TP_LOCAL = (("qwen2-7b m=4", TRAIN_B, TRAIN_S, 7, 1, 128, 0, 0.0),
            ("gemma2-2b m=2 window 4096", TRAIN_B, TRAIN_S, 4, 2, 256, 4096,
             50.0),
            ("gemma2-2b m=2 window 0", TRAIN_B, TRAIN_S, 4, 2, 256, 0, 50.0))
# (j2): one step of the mesh + EP route against the mesh-free dense step
# from the same state and batch, float32 params and compute.  On one rank
# the EP route computes what the dense route does (the local capacity is
# the global one) with the same kernels, so the two agree to float32
# rounding: loss rtol 1e-6, each first moment (0.1 of its clipped
# gradient) within rtol = 1e-5, atol = 1e-5 of its leaf's largest entry,
# and every routing decision equal.  Kernel against plain as (g2)'s
# float32 gate (G2_TOL).
J2_RTOL = 1e-5
# (j4): the loss after restore_tree onto the mesh equals the unbroken
# run's: the same state and kernels
J4_RTOL = 1e-6


class nccl_rank:
    """A process group of one NCCL rank over a FileStore in a temporary
    directory (no port to collide on), checked with one all-reduce;
    destroyed on exit.  No fallback: if NCCL does not start, this
    raises."""

    def __enter__(self):
        import os
        import tempfile
        import torch
        import torch.distributed as dist
        self.tmp = tempfile.TemporaryDirectory()
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(self.tmp.name, "s"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        t = torch.full((1,), 3.0, device="cuda")
        dist.all_reduce(t)
        if t.item() != 3.0:
            raise AssertionError(f"[j] NCCL all-reduce of one rank gave {t}")
        log(f"[j] NCCL process group: backend {dist.get_backend()}, world "
            f"size {dist.get_world_size()}")
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        self.tmp.cleanup()


class count_routes:
    """Count the MoE layer's calls by route (``moe_apply`` calls them by
    module name)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.saved = (moe._moe_apply_ep, moe._moe_apply_dense)
        self.ep = self.dense = 0

        def ep(*a, **k):
            self.ep += 1
            return self.saved[0](*a, **k)

        def dense(*a, **k):
            self.dense += 1
            return self.saved[1](*a, **k)

        moe._moe_apply_ep, moe._moe_apply_dense = ep, dense
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._moe_apply_ep, moe._moe_apply_dense = self.saved


def granite_train_cfg(n_layers=None, dtype=None, **over):
    """granite-moe-3b-a800m with ``ep_shard`` (and ``over``), cut to
    ``n_layers`` and run in ``dtype`` where given."""
    from repro_torch.configs import get_config
    cfg = get_config(GRANITE)
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, ep_shard=True), **over)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                  compute_dtype=dtype)
    return cfg


def mesh_bundle(cfg, shape=(1, 1), axes=("data", "model")):
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import make_step_bundle
    return make_step_bundle(cfg, ShapeCfg("t", TRAIN_S, TRAIN_B, "train"),
                            make_mesh(shape, axes, DEV))


def granite_batches(cfg):
    import torch
    from repro_torch.data.pipeline import make_source
    src = make_source(cfg, TRAIN_S, seed=0)
    return lambda step: {k: torch.as_tensor(v, device=DEV) for k, v in
                         src.batch(step, 0, TRAIN_B).items()}


def active_params(cfg, shapes) -> int:
    """Parameters a token meets: every leaf but the embedding table (a
    lookup) and the experts a token is not routed to (top_k of
    num_experts of each expert leaf)."""
    m = cfg.moe
    n = 0
    for key, t in shapes.items():
        if key == "embed.embedding" and not cfg.tie_embeddings:
            continue
        share = m.top_k / m.num_experts if key.split(".")[-1] in (
            "w_up", "w_gate", "w_down") and ".ffn." in key else 1.0
        n += t.numel() * share
    return int(n)


def phase_j1() -> dict:
    """granite-moe-3b-a800m at full width and depth (32 layers, bf16,
    float32 AdamW, remat full) with ``ep_shard``: 6 steps at 4 x 1024
    through ``ElasticTrainer`` with the bundle of ``make_step_bundle(cfg,
    shape, mesh)`` on the (1, 1) ("data", "model") mesh, then one profiled
    step."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import view_as
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    from repro_torch.runtime import ElasticTrainer
    gc.collect()
    torch.cuda.empty_cache()
    cfg = granite_train_cfg()
    bundle = mesh_bundle(cfg)
    # on one rank the plan splits every kind present (the vocabulary of
    # 49155 too): the layers run their tensor-parallel code, the
    # collectives identities
    want = {"heads", "kv_heads", "vocab"}
    if bundle.tp.kinds != want:
        raise AssertionError(f"[j1] tensor-parallel kinds {bundle.tp.kinds},"
                             f" expected {want}")
    log(f"[j1] tensor-parallel plan on the (1, 1) mesh: kinds "
        f"{sorted(bundle.tp.kinds)}; {len(bundle.tp.views)} leaves compute "
        f"on their 'model' chunk (the whole leaf on one rank): "
        f"{sorted({k.split('.')[-1] for k in bundle.tp.views})}")
    torch.cuda.reset_peak_memory_stats()
    state = bundle.init_fn(torch.Generator(device=DEV).manual_seed(0))
    leaves = dict(state["params"].named_parameters())
    if not all(isinstance(p, DTensor) for p in leaves.values()):
        raise AssertionError("[j1] the state's leaves are not DTensors")
    n_params = sum(p.numel() for p in leaves.values())
    n_active = active_params(cfg, leaves)
    with observe_train() as obs, count_routes() as routes:
        trainer = ElasticTrainer(bundle, granite_batches(cfg),
                                 log_fn=lambda s: None)
        fa.launches = 0
        fd.launches = 0
        t0 = time.perf_counter()
        state = trainer.run(state, steps=TRAIN_STEPS)
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches,
                    "flash_decode": fd.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # each attention layer's forward, and its recompute under remat
    per_step = cfg.n_layers * (1 if cfg.remat == "none" else 2)
    if obs.launches != [per_step] * TRAIN_STEPS or \
            launches["flash_decode"]:
        raise AssertionError(f"[j1] flash_attention launches per step "
                             f"{obs.launches}, expected {per_step}; "
                             f"{launches}")
    if routes.ep != per_step * TRAIN_STEPS or routes.dense:
        raise AssertionError(f"[j1] MoE routes: {routes.ep} expert-"
                             f"parallel, {routes.dense} dense; expected "
                             f"{per_step * TRAIN_STEPS} and 0")
    losses = trainer.report.losses
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[j1] losses {losses}")
    changed = 0
    for key, p in state["params"].named_parameters():
        changed += int((view_as(p).cpu() != obs.before[key]).sum())
    if changed == 0:
        raise AssertionError("[j1] no parameter moved")
    tokens = TRAIN_B * TRAIN_S
    step_s = statistics.median(obs.walls[1:])
    flops = 8.0 * n_active * tokens
    log(f"[j1] {GRANITE} full width and depth ({cfg.n_layers} layers, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, {n_params} bf16 "
        f"params, {n_active} active per token, float32 AdamW, remat "
        f"{cfg.remat}), ep_shard, mesh (1, 1) (data, model) on NCCL, batch "
        f"{TRAIN_B} x {TRAIN_S}: losses {losses}; flash_attention launches "
        f"per step {obs.launches}; MoE calls {routes.ep} expert-parallel, "
        f"{routes.dense} dense; parameter entries changed {changed}/"
        f"{n_params}; run wall {wall:.3f} s")
    log(f"[j1] {gpu_line()}: wall per step {obs.walls} s; median of steps "
        f"2-{TRAIN_STEPS} {step_s} s; {tokens / step_s} tokens/s; peak "
        f"device memory {peak:.3f} GiB; model FLOPs per step {flops:.4g} "
        f"(8 N T, N = {n_active} active: the attention, the router, "
        f"{cfg.moe.top_k} of {cfg.moe.num_experts} experts, the norms and "
        f"the head), {flops / step_s / 1e12:.2f} TFLOP/s = "
        f"{flops / step_s / H100_BF16:.4f} of {H100_BF16:.3g}")
    prof = profile_train_step("j1", trainer, state, step_s)
    out = dict(launches=launches["flash_attention"], step_s=step_s,
               tokens_per_s=tokens / step_s, peak_gib=peak,
               flops_share=flops / step_s / H100_BF16,
               idle_share=prof["idle_share"], adamw_ms=prof["adamw_ms"])
    del state, trainer, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def one_step(bundle, weights, batch, plain=False):
    """A fresh state with ``weights``, one step: (loss, first moments,
    the routing decisions of every MoE call)."""
    import torch
    from repro_torch.distributed.sharding import view_as
    from repro_torch.train import load_state
    state = bundle.init_fn(torch.Generator(device=DEV).manual_seed(0))
    sd = dict(state["params"].named_parameters())
    load_state(state, {"params": weights, "opt": {
        "m": {k: torch.zeros(p.shape, device=DEV) for k, p in sd.items()},
        "v": {k: torch.zeros(p.shape, device=DEV) for k, p in sd.items()},
        "step": torch.zeros((), dtype=torch.int32, device=DEV)}})
    ctx = plain_attention() if plain else contextlib.nullcontext()
    with ctx, record_routing() as rec:
        state, metrics = bundle.step_fn(state, batch)
    m = {k: view_as(t).float() for k, t in state["opt"]["m"].items()}
    return float(metrics["loss"]), m, rec.calls, state


def compare_steps(tag, a, b, loss_rtol, m_tol, decisions=True) -> dict:
    """(loss, m, routing) of two one-step runs: the losses within
    ``loss_rtol``, every first moment within ``m_tol`` (rtol, and atol of
    its leaf's largest entry), the routing decisions counted (and held
    equal with ``decisions``)."""
    import torch
    (la, ma, ra, _), (lb, mb, rb, _) = a, b
    if abs(la - lb) > loss_rtol * abs(lb):
        raise AssertionError(f"{tag} loss {la} vs {lb}")
    worst = 0.0
    for key, want in mb.items():
        got = ma[key]
        scale = want.abs().max().clamp(min=1e-30)
        err = ((got - want).abs() / (m_tol * (want.abs() + scale))).max()
        worst = max(worst, float(err) * m_tol)
        if err > 1:
            raise AssertionError(f"{tag} first moment of {key} off by "
                                 f"{(got - want).abs().max().item()}")
    if len(ra) != len(rb) or not ra:
        raise AssertionError(f"{tag} MoE calls {len(ra)} vs {len(rb)}")
    diff = sum(int((x[0] != y[0]).sum()) + int((x[1] != y[1]).sum())
               for x, y in zip(ra, rb))
    pairs = sum(ids.numel() for ids, _ in ra)
    if decisions and diff:
        raise AssertionError(f"{tag} {diff} routing decisions differ")
    return dict(loss=(la, lb), worst=worst, routing_diff=diff, pairs=pairs,
                calls=len(ra))


def phase_j2() -> None:
    """2 full-width granite layers, float32: the mesh + EP step against
    the mesh-free dense step, then kernel against plain."""
    import torch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import Model
    from repro_torch.train import make_step_bundle
    cfg = granite_train_cfg(n_layers=2, dtype="float32")
    weights = Model(cfg, device=DEV).init_params(
        torch.Generator(device=DEV).manual_seed(0)).state_dict()
    batch = granite_batches(cfg)(0)
    mesh = one_step(mesh_bundle(cfg), weights, batch)
    dense = one_step(make_step_bundle(
        cfg, ShapeCfg("t", TRAIN_S, TRAIN_B, "train")), weights, batch)
    r = compare_steps("[j2] mesh+EP vs dense:", mesh, dense, J2_RTOL,
                      J2_RTOL)
    log(f"[j2] {GRANITE} full width, 2 layers, float32, batch {TRAIN_B} x "
        f"{TRAIN_S}, one step: mesh (1, 1) + EP vs the mesh-free dense step:"
        f" loss {r['loss'][0]} vs {r['loss'][1]}; first moments (every "
        f"gradient leaf, clipped, x 0.1) worst {r['worst']} (tol "
        f"{J2_RTOL}); routing decisions that differ {r['routing_diff']} "
        f"of 2 x {r['pairs']} (expert ids, keep) over {r['calls']} MoE calls")
    loss_rtol, grad_rel = G2_TOL["float32"]
    plain = one_step(mesh_bundle(cfg), weights, batch, plain=True)
    r = compare_steps("[j2] kernel vs plain:", mesh, plain, loss_rtol,
                      grad_rel, decisions=False)
    log(f"[j2] mesh + EP, kernel vs plain attention: loss {r['loss'][0]} vs "
        f"{r['loss'][1]} (rtol {loss_rtol}); first moments worst "
        f"{r['worst']} (tol {grad_rel}); routing decisions that differ "
        f"{r['routing_diff']} of 2 x {r['pairs']}")
    del mesh, dense, plain, weights
    gc.collect()
    torch.cuda.empty_cache()


def phase_j3() -> None:
    """A (1, 1, 1) ("pod", "data", "model") mesh with int8 compression:
    one step of the 2-layer model.  The averaged gradients and the new
    error feedback are dequantize(quantize(g + ef)) and its rest, by the
    plain functions, on the gradients the step computed."""
    import torch
    from repro_torch.distributed.sharding import view_as
    from repro_torch.models.params import from_jax_params
    from repro_torch.optim import compress
    from repro_torch.train import steps
    cfg = granite_train_cfg(n_layers=2, grad_compression="int8")
    bundle = mesh_bundle(cfg, (1, 1, 1), ("pod", "data", "model"))
    state = bundle.init_fn(torch.Generator(device=DEV).manual_seed(0))
    seen = []
    saved = steps.compressed_pod_allreduce

    def captured(grads, ef, group):
        out = saved(grads, ef, group)
        seen.append((grads, ef, group) + out)
        return out

    steps.compressed_pod_allreduce = captured
    try:
        state, metrics = bundle.step_fn(state, granite_batches(cfg)(0))
    finally:
        steps.compressed_pod_allreduce = saved
    (grads, ef, group, avg, new_ef), = seen
    if group is not None:
        raise AssertionError(f"[j3] a pod group of one rank: {group}")
    # the reference's layout: a stacked leaf (all groups) has one scale
    ef, avg, new_ef = (dict(tree_items(t)) for t in (ef, avg, new_ef))
    n = 0
    for path, g in tree_items(grads):
        g32 = g.float() + ef[path]
        want = compress.dequantize_int8(*compress.quantize_int8(g32))
        if not (torch.equal(avg[path], want.to(g.dtype))
                and torch.equal(new_ef[path], g32 - want)):
            raise AssertionError(f"[j3] {path}: the compressed mean or the "
                                 "error feedback differs from the plain "
                                 "functions")
        n += int((g32 - want != 0).sum())
    kept = from_jax_params(cfg, seen[0][4])
    for key, t in state["ef"].items():
        if not torch.equal(view_as(t), kept[key]):
            raise AssertionError(f"[j3] the state's error feedback of {key}"
                                 " is not the step's")
    if not math.isfinite(float(metrics["loss"])) or n == 0:
        raise AssertionError(f"[j3] loss {metrics['loss']}, nonzero error "
                             f"feedback entries {n}")
    log(f"[j3] {GRANITE} 2 layers, bf16, mesh (1, 1, 1) (pod, data, model),"
        f" int8 compression: one step, loss {float(metrics['loss'])}; the "
        f"mean and the error feedback of all {len(avg)} leaves (in the "
        f"reference's stacked layout: one scale per stacked leaf) equal "
        f"dequantize(quantize(g + ef)) and its rest bit for bit; {n} nonzero "
        f"error-feedback entries")
    del state, grads, avg, seen, kept
    gc.collect()
    torch.cuda.empty_cache()


def phase_j4() -> None:
    """restore_tree onto the mesh's placements: a checkpoint after step 1,
    restored into a fresh state; step 2 from it gives the unbroken run's
    loss."""
    import tempfile
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import restore_tree, save_tree
    from repro_torch.models.params import from_jax_state, to_jax_state
    from repro_torch.train import load_state
    cfg = granite_train_cfg(n_layers=2)
    bundle = mesh_bundle(cfg)
    batches = granite_batches(cfg)
    state = bundle.init_fn(torch.Generator(device=DEV).manual_seed(0))
    state, _ = bundle.step_fn(state, batches(0))
    with tempfile.TemporaryDirectory() as tmp:
        save_tree(to_jax_state(cfg, state), tmp + "/step_1")
        _, m = bundle.step_fn(state, batches(1))
        unbroken = float(m["loss"])
        del state
        fresh = bundle.init_fn(torch.Generator(device=DEV).manual_seed(1))
        shardings = to_jax_state(cfg, bundle.in_shardings[0])
        tree = restore_tree(tmp + "/step_1",
                            to_jax_state(cfg, fresh, device="meta"),
                            shardings)
    leaves = [t for _, t in tree_items(tree)]
    if not all(isinstance(t, DTensor) and t.device.type == DEV
               for t in leaves):
        raise AssertionError("[j4] restore_tree did not place every leaf on "
                             "the mesh")
    load_state(fresh, from_jax_state(cfg, tree))
    _, m = bundle.step_fn(fresh, batches(1))
    restored = float(m["loss"])
    if abs(restored - unbroken) > J4_RTOL * abs(unbroken):
        raise AssertionError(f"[j4] loss after the restore {restored} vs "
                             f"unbroken {unbroken}")
    log(f"[j4] {GRANITE} 2 layers, bf16, mesh (1, 1): checkpoint after step "
        f"1, restore_tree onto the bundle's placements ({len(leaves)} "
        f"DTensor leaves on the card), step 2 loss {restored} vs the "
        f"unbroken run's {unbroken} (rtol {J4_RTOL})")
    del fresh, tree, leaves
    gc.collect()
    torch.cuda.empty_cache()


def phase_j5(rnd) -> dict:
    """flash_attention at the local-head shapes of tensor parallelism
    (``TP_LOCAL``): forward and backward through the autograd function
    against ref.attention (``autograd_case``), then the kernel timed
    against its plain version and SDPA, with its bound."""
    import torch
    out = {}
    for label, *case in TP_LOCAL:
        err = autograd_case(rnd, *case, torch.bfloat16)
        out[label] = dict(max_abs_err=err, **time_prefill(
            rnd, f"TP local heads, {label}", *case))
    log(f"[j5] flash_attention at tensor parallelism's local heads "
        f"({', '.join(label for label, *_ in TP_LOCAL)}), bf16: one launch "
        f"per forward, forward within TOL of ref.attention (max |err| "
        f"{ {k: v['max_abs_err'] for k, v in out.items()} }), grads of q, "
        f"k, v equal to autograd through ref.attention bit for bit")
    torch.cuda.empty_cache()
    return out


def tree_items(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def phase_j(rnd) -> dict:
    """The slice's path: granite-moe training on the card through the mesh
    step, on a process group of one NCCL rank."""
    t0 = time.perf_counter()
    with nccl_rank():
        main = phase_j1()
        phase_j2()
        phase_j3()
        phase_j4()
    import torch
    dims = [GRANITE_TRAIN[k] for k in ("B", "S", "NH", "KV", "hd")]
    err = fwd_case(rnd, *dims, 0, 0.0, torch.bfloat16)
    timed = time_prefill(rnd, "granite training shape", *dims)
    tp_local = phase_j5(rnd)
    log(f"[j] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(main, max_abs_err=err, timed=timed, tp_local=tp_local)


# ---------------------------------------------------------------------------
# (k) qwen2-7b through the prefill and decode step bundles on a mesh
# ---------------------------------------------------------------------------

QWEN_ARCH = "qwen2-7b"
K_PREFILL_B = 1         # prefill_32k's batch, cut from 32
K_DECODE_B = 8          # decode_32k's batch, cut from 128
K_STEPS = 8             # decode positions 32760 .. 32767
K_PAIRS = 20            # alternating bundle / Model.decode_step steps
K_CHUNKS = 4            # the partials mode: sequence chunks of one layer
# (pos, window) of the partials gate at decode_32k's shapes: every chunk
# valid; a window that leaves three chunks without a valid key; a
# position that leaves the last chunk without one
K_PARTIALS = ((32767, 0), (32767, 4096), (20000, 0))
# the kernel's float32 partials against ref.decode_split's: the same sums
# over bf16 values in another order (atol of the leaf's largest entry)
PARTIALS_RTOL = 2e-5


def k_shapes():
    from repro_torch.configs import SHAPES
    return (dataclasses.replace(SHAPES["prefill_32k"],
                                global_batch=K_PREFILL_B),
            dataclasses.replace(SHAPES["decode_32k"],
                                global_batch=K_DECODE_B))


def tree_equal(a, b) -> list:
    """Paths of the leaves of two caches (DTensors or tensors) that
    differ."""
    from torch.distributed.tensor import DTensor
    bad = []
    for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
        x = x.to_local() if isinstance(x, DTensor) else x
        y = y.to_local() if isinstance(y, DTensor) else y
        if not (x.shape == y.shape and bool((x == y).all())):
            bad.append(path)
    return bad


def profile_call(tag, fn, wall_s) -> dict:
    """One call of ``fn`` under torch.profiler: kernels, busy ms and the
    idle share of the unprofiled wall ``wall_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    n = sum(r[1] for r in rows)
    idle = 1 - busy / (wall_s * 1e3)
    log(f"{tag} profiled: {n} kernels, device busy {busy:.3f} ms, idle "
        f"share {idle:.4f} of the unprofiled wall {wall_s * 1e3:.3f} ms")
    for ms, calls, key in sorted(rows, reverse=True)[:6]:
        log(f"{tag}   {ms:.3f} ms device, {calls} calls: {key[:90]}")
    return dict(kernels=n, busy_ms=busy, idle_share=idle)


def real_flops(fn) -> int:
    """The FLOPs ``FlopCounterMode`` counts in one call of ``fn`` on real
    CUDA tensors (the kernels launch: their operators' formulas)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    return fc.get_total_flops()


def op_host_cost(fd, q, kc, vc, pos, scale, calls=200, reps=6) -> float:
    """Host microseconds a ``flash_decode`` call through its
    ``torch.library`` operator takes beyond the same launch called
    directly (``_decode_launch``, the operator's CUDA kernel): blocks of
    ``calls`` back-to-back calls of each, alternating, no sync inside a
    block (the launch queue does not fill), the median of the paired
    differences."""
    import torch
    runs = {"op": lambda: fd.flash_decode(q, kc, vc, pos, scale=scale),
            "direct": lambda: fd._decode_launch(q, kc, vc, pos, scale, 0,
                                                0.0)}
    per = {"op": [], "direct": []}
    for i in range(reps):
        for name in (("op", "direct") if i % 2 else ("direct", "op")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                runs[name]()
            per[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    return statistics.median(a - b for a, b in zip(per["op"],
                                                   per["direct"]))


def phase_k1() -> dict:
    """qwen2-7b at full width and depth (28 layers, bf16) through
    ``make_step_bundle`` on the (1, 1) ("data", "model") mesh of one NCCL
    rank: one prefill at prefill_32k's seq (batch 1), then K_STEPS decode
    steps at decode_32k's seq (batch 8) on a cache drawn from a seed, each
    held bit for bit against ``Model.prefill`` / ``Model.decode_step`` on
    the same parameters (the decode on a copy of the cache)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.train import make_step_bundle
    from repro_torch.train.steps import place_params
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(QWEN_ARCH)
    pshape, dshape = k_shapes()
    mesh = make_mesh((1, 1), ("data", "model"), DEV)
    pb = make_step_bundle(cfg, pshape, mesh)
    db = make_step_bundle(cfg, dshape, mesh)
    want = {"ffn", "heads", "kv_heads", "vocab"}
    if pb.tp.kinds != want or db.tp.kinds != want:
        raise AssertionError(f"[k] tensor-parallel kinds {pb.tp.kinds} / "
                             f"{db.tp.kinds}, expected {want}")
    t0 = time.perf_counter()
    model = Model(cfg, device=DEV).init_params(
        torch.Generator(device=DEV).manual_seed(0))
    params = place_params(cfg, {k: p.detach() for k, p in
                                model.named_parameters()},
                          pb.in_shardings[0])
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"[k] {QWEN_ARCH} full width and depth ({cfg.n_layers} layers, "
        f"{n_params} bf16 params, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn and placed "
        f"on the (1, 1) mesh in {time.perf_counter() - t0:.1f} s; plan "
        f"{sorted(pb.tp.kinds)}")
    g = torch.Generator(device=DEV).manual_seed(1)

    # --- prefill: prefill_32k's seq 32768 at batch 1 ---------------------
    S = pshape.seq_len
    toks = torch.randint(0, cfg.vocab_size, (K_PREFILL_B, S), generator=g,
                         device=DEV)
    # the first call at these shapes pays the GEMMs' and the allocator's
    # set-up: timed apart, and the second call is the one measured
    t0 = time.perf_counter()
    pb.step_fn(params, toks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fd.launches = 0
    fd.partials_launches = fd.combine_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pb.step_fn(params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    p_launches = {"flash_attention": fa.launches,
                  "flash_decode": fd.launches,
                  "partials": fd.partials_launches,
                  "combine": fd.combine_launches}
    p_peak = torch.cuda.max_memory_allocated() / 2**30
    if p_launches != {"flash_attention": cfg.n_layers, "flash_decode": 0,
                      "partials": 0, "combine": 0}:
        raise AssertionError(f"[k] prefill launches {p_launches}, expected "
                             f"{cfg.n_layers} flash_attention")
    if tuple(logits.shape) != (K_PREFILL_B, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits.to_local()).all()):
        raise AssertionError(f"[k] prefill logits {tuple(logits.shape)}")
    t0 = time.perf_counter()
    want_logits, want_cache = model.prefill(toks)
    torch.cuda.synchronize()
    plain_prefill_s = time.perf_counter() - t0
    if not torch.equal(logits.to_local(), want_logits):
        raise AssertionError("[k] the prefill bundle's logits differ from "
                             "Model.prefill's")
    bad = tree_equal(cache, want_cache)
    if bad:
        raise AssertionError(f"[k] prefill cache leaves differ: {bad[:4]}")
    n_leaves = len(list(tree_items(cache)))
    prof_p = profile_call("[k] prefill", lambda: pb.step_fn(params, toks),
                          prefill_s)
    log(f"[k] prefill q ({K_PREFILL_B}, {S}) through the bundle: "
        f"{prefill_s:.3f} s (its first call {first_s:.3f} s; Model.prefill "
        f"{plain_prefill_s:.3f} s), "
        f"launches {p_launches}, peak {p_peak:.3f} GiB; logits and "
        f"{n_leaves} cache leaves equal Model.prefill's bit for bit")
    prefill_flops = real_flops(lambda: pb.step_fn(params, toks))
    del logits, cache, want_logits, want_cache
    gc.collect()
    torch.cuda.empty_cache()

    # --- decode: decode_32k's seq 32768 at batch 8, a cache from a seed --
    B, S = dshape.global_batch, dshape.seq_len
    full = model.init_cache(B, S, torch.bfloat16)
    for _, leaf in tree_items(full):
        for b in range(B):      # one row at a time: no float32 copy whole
            leaf[b].copy_(torch.randn(leaf[b].shape, generator=g,
                                      device=DEV))
    plain = [{n: {"mixer": {k: t.clone() for k, t in lc["mixer"].items()}}
              for n, lc in gcache.items()} for gcache in full]
    cache = [{n: {"mixer": {k: distribute(t, db.in_shardings[1][i][n][
        "mixer"][k]) for k, t in lc["mixer"].items()}}
        for n, lc in gcache.items()} for i, gcache in enumerate(full)]
    cache_gb = sum(t.numel() * t.element_size()
                   for _, t in tree_items(full)) / 1e9
    log(f"[k] decode cache ({B}, {cfg.n_kv_heads}, {cfg.head_dim_}, {S}) "
        f"bf16 x 2 x {cfg.n_layers} layers drawn from a seed: "
        f"{cache_gb:.2f} GB, and a copy for Model.decode_step; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    walls, plain_walls, launches = [], [], []
    first = S - K_STEPS
    for pos in range(first, S):
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                            device=DEV)
        fd.launches = fa.launches = 0
        fd.partials_launches = fd.combine_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = db.step_fn(params, cache, tok, pos)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append((fd.launches, fa.launches, fd.partials_launches,
                         fd.combine_launches))
        t0 = time.perf_counter()
        want_logits, plain = model.decode_step(plain, tok, pos)
        torch.cuda.synchronize()
        plain_walls.append(time.perf_counter() - t0)
        if not torch.equal(logits.to_local(), want_logits):
            raise AssertionError(f"[k] decode logits at pos {pos} differ "
                                 "from Model.decode_step's")
        for (path, a), (_, b) in zip(tree_items(cache), tree_items(plain)):
            a = a.to_local()
            at = (..., pos) if path.endswith("/k") else (..., pos, slice(None))
            if not torch.equal(a[at], b[at]):
                raise AssertionError(f"[k] cache {path} at pos {pos} "
                                     "differs from Model.decode_step's")
    d_peak = torch.cuda.max_memory_allocated() / 2**30
    # the mesh path's host cost: K_PAIRS pairs of one bundle step and one
    # Model.decode_step at the last position, each pair in the other
    # order than the one before, on the same device work
    runs = {"bundle": lambda: db.step_fn(params, cache, tok, S - 1),
            "plain": lambda: model.decode_step(plain, tok, S - 1)}
    pair_walls = {"bundle": [], "plain": []}
    for i in range(K_PAIRS):
        for name in (("bundle", "plain") if i % 2 else ("plain", "bundle")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            pair_walls[name].append(time.perf_counter() - t0)
    diffs = [a - b for a, b in zip(*pair_walls.values())]
    q1, mid, q3 = statistics.quantiles(diffs, n=4)
    log(f"[k] mesh path's host cost, {K_PAIRS} alternating pairs at pos "
        f"{S - 1}: bundle step median "
        f"{statistics.median(pair_walls['bundle'])} s, Model.decode_step "
        f"{statistics.median(pair_walls['plain'])} s; "
        f"bundle minus plain per pair: median {mid} s, quartiles {q1} / "
        f"{q3} s; bundle faster in "
        f"{sum(d < 0 for d in diffs)} of {K_PAIRS} pairs")
    if launches != [(cfg.n_layers, 0, 0, 0)] * K_STEPS:
        raise AssertionError(f"[k] decode launches per step (flash_decode, "
                             f"flash_attention, partials, combine) "
                             f"{launches}, expected ({cfg.n_layers}, 0, 0, "
                             "0)")
    if not bool(torch.isfinite(logits.to_local()).all()):
        raise AssertionError("[k] non-finite decode logits")
    step_s = statistics.median(walls[1:])
    prof_d = profile_call("[k] decode step", lambda: db.step_fn(
        params, cache, tok, S - 1), step_s)
    decode_flops = real_flops(lambda: db.step_fn(params, cache, tok, S - 1))
    op_us = op_host_cost(fd, torch.randn(
        (B, cfg.n_heads, cfg.head_dim_), generator=g, device=DEV).to(
            torch.bfloat16), cache[0]["l0"]["mixer"]["k"].to_local().permute(
                0, 3, 1, 2), cache[0]["l0"]["mixer"]["v"].to_local().permute(
                    0, 2, 1, 3), S - 1, cfg.head_dim_ ** -0.5)
    log(f"[k] {gpu_line()}: flash_decode through its torch.library "
        f"operator costs the host {op_us} us a call more than its launch "
        f"called directly (median of paired blocks of 200 calls), "
        f"{op_us * cfg.n_layers} us a decode step of {cfg.n_layers} layers "
        f"against a step of {step_s * 1e6:.1f} us")
    n_split = fd.plan(torch.empty((B, cfg.n_heads, cfg.head_dim_),
                                  dtype=torch.bfloat16, device=DEV),
                      cache[0]["l0"]["mixer"]["k"].to_local().permute(
                          0, 3, 1, 2), S - 1)
    log(f"[k] {gpu_line()}: {K_STEPS} decode steps at pos {first}-{S - 1}, "
        f"batch {B}, through the bundle: wall per step {walls} s (median of "
        f"steps 2-{K_STEPS} {step_s} s; Model.decode_step "
        f"{statistics.median(plain_walls[1:])} s); flash_decode launches "
        f"per step {[n[0] for n in launches]} (n_split {n_split}); peak "
        f"{d_peak:.3f} GiB; logits and every written cache position equal "
        f"Model.decode_step's bit for bit")
    del cache, plain, full, logits, want_logits, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prefill_s=prefill_s, first_prefill_s=first_s,
                plain_prefill_s=plain_prefill_s,
                prefill_peak_gib=p_peak, prefill_idle=prof_p["idle_share"],
                step_s=step_s, walls=walls, decode_peak_gib=d_peak,
                decode_idle=prof_d["idle_share"],
                prefill_busy_ms=prof_p["busy_ms"],
                decode_busy_ms=prof_d["busy_ms"],
                prefill_flops=prefill_flops, decode_flops=decode_flops,
                op_host_us=op_us,
                launches={"flash_attention": p_launches["flash_attention"],
                          "flash_decode": sum(n[0] for n in launches),
                          "partials": sum(n[2] for n in launches)})


def plain_prefill_chunked(q, k, v, scale, chunk: int = 1024, drop=None):
    """The model's plain causal attention (``_attend_chunk``'s arithmetic:
    float32 scores of ``chunk`` query rows against every key) on the
    card: ``ref.attention``'s whole score matrix does not fit at 32768.
    ``drop``, keys [lo, hi) left out: the negative control's result."""
    import torch
    from repro_torch.kernels import ref
    B, S, NH, hd = q.shape
    KV = k.shape[2]
    kf, vf = k.float(), v.float()
    kpos = torch.arange(S, device=q.device)
    outs = []
    for i in range(0, S, chunk):
        qg = q[:, i:i + chunk].reshape(B, -1, KV, NH // KV, hd).float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qg * scale, kf)
        qpos = i + torch.arange(qg.shape[1], device=q.device)
        keep = qpos[:, None] >= kpos[None, :]
        if drop is not None:
            keep = keep & ((kpos < drop[0]) | (kpos >= drop[1]))[None, :]
        s = torch.where(keep, s, ref.NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", p, vf).reshape(
            B, -1, NH, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def time_bundle_prefill(rnd) -> dict:
    """flash_attention at the bundle's prefill shape, q (1,32768,28,128)
    against 4 KV heads, causal: against the chunked plain attention and
    SDPA, with its bound."""
    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    B, S = K_PREFILL_B, k_shapes()[0].seq_len
    NH, KV, hd = QWEN["NH"], QWEN["KV"], QWEN["hd"]
    dt = torch.bfloat16
    q, k, v = rnd((B, S, NH, hd), dt), rnd((B, S, KV, hd), dt), \
        rnd((B, S, KV, hd), dt)
    scale = hd ** -0.5
    run = lambda: fa.flash_attention_fwd(q, k, v, scale=scale)  # noqa
    want = plain_prefill_chunked(q, k, v, scale)
    err = check_rows("flash_attention prefill_32k", run(), want,
                     TOL["bfloat16"])
    # one 64-key tile of the kernel's left out, for every later row
    expect_rejected("flash_attention prefill_32k without keys 16384-16447",
                    plain_prefill_chunked(q, k, v, scale,
                                          drop=(16384, 16448)),
                    want, TOL["bfloat16"])
    del want
    ms = time_ms(run, calls=3)
    plain = time_ms(lambda: plain_prefill_chunked(q, k, v, scale), calls=1,
                    reps=3)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), calls=3)
    flops = 4.0 * hd * attn_pairs(S, S, 0) * B * NH
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    log(f"[k] flash_attention q{(B, S, NH, hd)} kv{(B, S, KV, hd)} bf16 "
        f"causal: kernel {ms} ms, plain (chunked) {plain} ms, sdpa {lib} ms,"
        f" bound {b_ms} ms by {b_by} (share {b_ms / ms:.4f}); max |err| vs "
        f"plain {err}")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by)


def k_partials(q, kc, vc, pos, window, scale):
    """The partials entry on each of K_CHUNKS sequence chunks of the
    caches, combined by the combine entry: (o, [each chunk's (acc, m,
    l)])."""
    import torch
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    c = kc.shape[1] // K_CHUNKS
    parts = [fd.partials(q, kc[:, r * c:(r + 1) * c], vc[:, r * c:(r + 1) * c],
                         pos, offset=r * c, scale=scale, window=window)
             for r in range(K_CHUNKS)]
    acc, m, l = (torch.cat([p[i] for p in parts]) for i in range(3))
    return fd.combine(acc, m, l, q.dtype), parts


def phase_k2(rnd) -> dict:
    """The partials mode at decode_32k's shapes (batch 8): one layer's
    bf16 cache in K_CHUNKS sequence chunks in one process, each chunk
    through the partials entry and the partials combined, held against
    whole flash_decode and the plain version (``ref.decode_split(...,
    partials=True)`` per chunk, merged by ``ref.combine``), with a window
    and chunks without a valid key; then timed beside whole flash_decode,
    with the bound of the same decode."""
    import torch
    from repro_torch.kernels import ref
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    B, S = K_DECODE_B, k_shapes()[1].seq_len
    NH, KV, hd = QWEN["NH"], QWEN["KV"], QWEN["hd"]
    q, kc, vc = decode_inputs(rnd, B, S, NH, KV, hd, torch.bfloat16,
                              torch.bfloat16)
    scale = hd ** -0.5
    c = S // K_CHUNKS
    errs, empty = {}, {}
    fd.partials_launches = fd.combine_launches = 0
    for pos, window in K_PARTIALS:
        out, parts = k_partials(q, kc, vc, pos, window, scale)
        n = parts[0][0].shape[0]
        want_parts = []
        for r in range(K_CHUNKS):
            _, wp = ref.decode_split(q, kc[:, r * c:(r + 1) * c],
                                     vc[:, r * c:(r + 1) * c], pos,
                                     n_split=n, scale=scale, window=window,
                                     partials=True, offset=r * c)
            want_parts.append(wp)
            for name, got, want in zip(("acc", "m", "l"), parts[r], wp):
                tol = PARTIALS_RTOL * max(float(want.abs().max()), 1.0)
                check_close(f"flash_decode partials chunk {r} {name} pos "
                            f"{pos} window {window}", got, want, tol)
        nothing = [r for r in range(K_CHUNKS)
                   if ref.chunk_range(pos, window, r * c, c) == (0, 0)]
        for r in nothing:
            if not (bool((parts[r][1] == ref.NEG_INF).all())
                    and bool((parts[r][2] == 0).all())):
                raise AssertionError(f"[k] chunk {r} has no valid key at "
                                     f"pos {pos} window {window}, but its "
                                     "partials are not m = NEG_INF, l = 0")
        acc, m, l = (torch.cat([p[i] for p in want_parts]) for i in range(3))
        plain = ref.combine(acc, m, l, q.dtype)
        whole = fd.flash_decode(q, kc, vc, pos, scale=scale, window=window)
        label = f"pos {pos} window {window}"
        errs[label] = max(
            check_rows(f"partials + combine vs plain, {label}", out, plain,
                       TOL["bfloat16"]),
            check_rows(f"partials + combine vs whole flash_decode, "
                       f"{label}", out, whole, TOL["bfloat16"]),
            check_rows(f"partials + combine vs ref.decode, {label}", out,
                       ref.decode(q, kc, vc, pos, scale=scale,
                                  window=window), TOL["bfloat16"]))
        # the negative control: the plain merge without the split of
        # largest weight (the kernel dropping one of its splits)
        keep = torch.ones(m.shape[0], dtype=torch.bool, device=m.device)
        keep[int(l.sum(dim=(1, 2)).argmax())] = False
        expect_rejected(f"the merge without one of its {m.shape[0]} "
                        f"splits, {label}", ref.combine(
                            acc[keep], m[keep], l[keep], q.dtype), plain,
                        TOL["bfloat16"])
        empty[label] = nothing
    gate_launches = (fd.partials_launches, fd.combine_launches)
    if gate_launches != (K_CHUNKS * len(K_PARTIALS), len(K_PARTIALS)):
        raise AssertionError(f"[k] partials / combine launches "
                             f"{gate_launches}")
    pos = S - 1
    ms = time_ms(lambda: k_partials(q, kc, vc, pos, 0, scale))
    whole_ms = time_ms(lambda: fd.flash_decode(q, kc, vc, pos, scale=scale))

    def plain_run():
        ps = [ref.decode_split(q, kc[:, r * c:(r + 1) * c],
                               vc[:, r * c:(r + 1) * c], pos, n_split=1,
                               scale=scale, partials=True, offset=r * c)[1]
              for r in range(K_CHUNKS)]
        return ref.combine(*(torch.cat([p[i] for p in ps]) for i in
                             range(3)), q.dtype)

    plain_ms = time_ms(plain_run, calls=5, reps=3)
    # the same decode as one SDPA call (as time_decode prepares it)
    ql, kl, vl = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, scale=scale, enable_gqa=True))
    flops = 4.0 * hd * S * B * NH
    nbytes = 2 * 2 * B * NH * hd + 2 * B * KV * S * hd * 2
    b_ms, b_by = bound(flops, nbytes, "bfloat16")
    n = fd.partials(q, kc[:, :c], vc[:, :c], pos, offset=0,
                    scale=scale)[0].shape[0]
    log(f"[k] partials mode q{(B, NH, hd)} bf16, bf16 cache{(B, S, KV, hd)} "
        f"in {K_CHUNKS} chunks of {c} ({n} splits each, {K_CHUNKS * n} "
        f"partials combined): {ms} ms for the {K_CHUNKS} partials launches "
        f"and the combine, whole flash_decode {whole_ms} ms, plain "
        f"{plain_ms} ms, sdpa {lib} ms, bound {b_ms} ms by {b_by} (share "
        f"{b_ms / ms:.4f}); "
        f"max |err| {errs}; chunks without a valid key {empty}; gate "
        f"launches (partials, combine) {gate_launches}")
    del q, kc, vc
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                whole_ms=whole_ms, gate_launches=list(gate_launches),
                splits_per_chunk=n)


def phase_k(rnd) -> dict:
    """The slice's path: qwen2-7b served through the prefill and decode
    bundles on a process group of one NCCL rank; both kernels at the
    bundles' shapes; the partials mode of a sequence-split cache."""
    import torch
    t0 = time.perf_counter()
    with nccl_rank():
        main = phase_k1()
    prefill = time_bundle_prefill(rnd)
    decode = time_decode(rnd, "serve bundle decode_32k", K_DECODE_B,
                         k_shapes()[1].seq_len, **QWEN,
                         pos=k_shapes()[1].seq_len - 1,
                         kv_dtype=torch.bfloat16)
    decode.pop("n_split")
    B, S = K_DECODE_B, k_shapes()[1].seq_len
    q, kc, vc = decode_inputs(rnd, B, S, **QWEN, q_dtype=torch.bfloat16,
                              kv_dtype=torch.bfloat16)
    decode["max_abs_err"] = decode_case(q, kc, vc, S - 1, 0, 0.0,
                                        TOL["bfloat16"], "decode_32k")
    del q, kc, vc
    partials = phase_k2(rnd)
    log(f"[k] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(main, prefill=prefill, decode=decode, partials=partials)


# ---------------------------------------------------------------------------
# (l) the dry run: the roofline of the card's program, traced
# ---------------------------------------------------------------------------

L_CELLS = ("prefill_32k", "decode_32k")
DRYRUN = """
import json, sys
from repro_torch.launch.dryrun import run_cell
out = {s: run_cell("qwen2-7b", s, out_dir=sys.argv[1]) for s in sys.argv[2:]}
print(json.dumps(out))
"""


def phase_l(serve: dict) -> dict:
    """(l1) ``launch/dryrun.run_cell`` for qwen2-7b at prefill_32k and
    decode_32k on the fake 16x16 mesh (rank 0 of 256 fake ranks, in a
    process of its own); (l2) phase k's one-card cells on the (1, 1) mesh
    of one NCCL rank traced on fake CUDA tensors, and on fake meta tensors
    as a host without CUDA traces them: both FLOP counts equal to the
    FLOPs counted in (k) on real CUDA tensors, no kernel launched; (l3)
    their roofline terms at the H100's rates beside (k)'s measured device
    times."""
    import os
    import tempfile
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.program import analyze_program, card_trace
    from repro_torch.analysis.roofline import roofline_terms
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import step_inputs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import make_step_bundle
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [sys.executable, "-c", DRYRUN, tmp, *L_CELLS],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"[l] the dry run failed: {r.stderr[-3000:]}")
    cells = json.loads(r.stdout.strip().splitlines()[-1])
    for line in r.stdout.splitlines():
        if line.startswith("[dryrun]"):
            log(f"[l] {line}")
    for name, c in cells.items():
        if c["status"] != "OK" or c["n_chips"] != 256 or not \
                c["hlo_analysis"]["flops_per_device"] > 0:
            raise AssertionError(f"[l] {name} on 16x16: {c}")
        log(f"[l] {name} 16x16 per device: "
            f"{c['hlo_analysis']['flops_per_device']} FLOPs, "
            f"{c['hlo_analysis']['hbm_bytes_per_device']} HBM bytes, "
            f"{c['hlo_analysis']['ici_bytes_per_device']} ICI bytes; "
            f"roofline {c['roofline']}")
    cfg = get_config(QWEN_ARCH)
    out = {"16x16": {k: c["roofline"] for k, c in cells.items()}}
    with nccl_rank():
        mesh = make_mesh((1, 1), ("data", "model"), DEV)
        for tag, shape in zip(("prefill", "decode"), k_shapes()):
            bundle = make_step_bundle(cfg, shape, mesh)
            before = (fa.launches, fd.launches, fd.partials_launches,
                      fd.combine_launches)
            traced = {}
            for device in ("cuda", "meta"):
                t1 = time.perf_counter()
                with FakeTensorMode(allow_non_fake_inputs=True), \
                        card_trace(device):
                    traced[device] = analyze_program(
                        bundle.step_fn, *step_inputs(bundle, device))
                log(f"[l] {tag} traced on fake {device} tensors in "
                    f"{time.perf_counter() - t1:.2f} s")
            after = (fa.launches, fd.launches, fd.partials_launches,
                     fd.combine_launches)
            real = serve[f"{tag}_flops"]
            flops = {d: a.flops for d, a in traced.items()}
            if after != before:
                raise AssertionError(f"[l] a fake trace launched a kernel: "
                                     f"{before} -> {after}")
            if not flops["cuda"] == flops["meta"] == real:
                raise AssertionError(f"[l] {tag}: traced FLOPs {flops}, "
                                     f"counted on the card {real}")
            a = traced["cuda"]
            tokens = shape.global_batch * (
                shape.seq_len if shape.kind == "prefill" else 1)
            rl = roofline_terms(
                a, model_flops_total=cfg.model_flops_per_token("serve")
                * tokens, n_chips=1)
            busy_s = serve[f"{tag}_busy_ms"] / 1e3
            wall_s = serve["prefill_s" if tag == "prefill" else "step_s"]
            bound_s = max(rl.t_compute, rl.t_memory)
            log(f"[l] {gpu_line()}: {tag} {QWEN_ARCH} "
                f"({shape.global_batch}, {shape.seq_len}) on one card: "
                f"traced {a.flops} FLOPs = {real} counted on real CUDA "
                f"tensors in (k); {a.hbm_bytes} HBM bytes (eager model); "
                f"t_compute {rl.t_compute} s, t_memory {rl.t_memory} s, "
                f"max {bound_s} s; measured in (k): device busy {busy_s} s "
                f"(share of the bound {bound_s / busy_s:.4f}), wall "
                f"{wall_s} s")
            out[tag] = dict(flops=a.flops, hbm_bytes=a.hbm_bytes,
                            t_compute=rl.t_compute, t_memory=rl.t_memory,
                            busy_s=busy_s, wall_s=wall_s)
    log(f"[l] phase wall {time.perf_counter() - t0:.1f} s")
    return out


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
    granite = phase_h(rnd)
    jamba = phase_i(rnd)
    mesh_train = phase_j(rnd)
    serve_bundle = phase_k(rnd)
    phase_l(serve_bundle)
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
        tr = mtr = {"launches": 0}
        tp_local = {}
        if name == "flash_attention":
            tr = {"launches": train["launches"],
                  "max_abs_err": train["max_abs_err"],
                  **train["timed"]["window 4096"]}
            # granite-moe training through the mesh step (j1): its 6
            # steps' launches, the kernel at q (4,1024,24,64), 8 KV heads
            mtr = {"launches": mesh_train["launches"],
                   "max_abs_err": mesh_train["max_abs_err"],
                   **mesh_train["timed"]}
            # the local heads of tensor parallelism over "model" (j5)
            tp_local = {"train_tp_local_heads": mesh_train["tp_local"]}
        # serving through the prefill and decode bundles (k): launches of
        # one prefill at 32768 and of the decode steps at 32760-32767, the
        # kernel at those shapes; the partials mode of a sequence-split
        # cache (not on one card's path: launched by its gate only)
        sb = {"serve_bundle": {
            "launches": serve_bundle["launches"][name],
            **serve_bundle["prefill" if name == "flash_attention"
                           else "decode"]}}
        if name == "flash_decode":
            sb["serve_bundle_partials"] = {
                "launches": serve_bundle["launches"]["partials"],
                **serve_bundle["partials"]}
        # serving the MoE (h) and hybrid (i) paths: their launches, and the
        # kernel checked and timed at their shapes (hd=64 G=3; hd=128 G=4)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **t,
                        "bound_share": t["bound_ms"] / t["ms"],
                        "design": design, "train": tr,
                        "train_granite_moe_mesh": mtr, **tp_local, **sb,
                        **{key: {"launches": run["launches"][name],
                                 "max_abs_err": run["errs"][name],
                                 **run["timed"][name]}
                           for key, run in (("serve_granite_moe", granite),
                                            ("serve_jamba", jamba))}})
    log(f"[done] torch {torch.__version__} (cuda {torch.version.cuda}); "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
