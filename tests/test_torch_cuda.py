"""The port's CUDA kernels on the card (``cuda`` marker: skipped without a
GPU).  This file imports neither JAX nor ``repro``, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain torch version (``kernels/ref.py``)
on the same card tensors: float32 atol = rtol = 2e-5, bfloat16 2e-2 (the
bars of ``tests/test_kernels.py``).  Whole smoke models on the card (the
kernels) are held against the same parameters on the CPU (the
reference's XLA paths) at 2e-4, the bar of ``tests/test_models.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.spe import _merge_prefill_cache
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref
from repro_torch.models import Model

pytestmark = pytest.mark.cuda

FWD_CASES = [
    # B, S, NH, KV, hd, window, softcap
    (2, 64, 4, 4, 32, 0, 0.0),
    (2, 128, 8, 2, 64, 0, 0.0),
    (1, 256, 8, 1, 64, 0, 0.0),
    (1, 128, 4, 2, 32, 32, 0.0),
    (1, 128, 4, 2, 32, 0, 50.0),
    (1, 96, 2, 2, 16, 24, 30.0),      # ragged tile edge
    (1, 300, 8, 4, 256, 100, 50.0),   # gemma2 head_dim, ragged
]

DECODE_CASES = [
    # B, S, NH, KV, hd, pos, window, softcap
    (2, 128, 4, 4, 32, 64, 0, 0.0),
    (2, 256, 8, 2, 64, 255, 0, 0.0),
    (1, 512, 8, 1, 64, 0, 0, 0.0),
    (1, 256, 4, 2, 32, 200, 64, 0.0),
    (1, 128, 4, 4, 32, 100, 0, 50.0),
    (4, 80, 28, 4, 128, 70, 0, 0.0),  # qwen2-7b, G=7
]

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
            for s in shapes]


def close(out, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FWD_CASES)
def test_flash_attention_kernel_vs_plain(case, dtype, cuda):
    B, S, NH, KV, hd, window, cap = case
    q, k, v = (a.to(cuda, dtype) for a in arrays(
        1, (B, S, NH, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = fa.launches
    out = ops.flash_attention(q, k, v, hd ** -0.5, True, window, cap)
    assert fa.launches == before + 1
    close(out, ref.attention(q, k, v, scale=hd ** -0.5, window=window,
                             softcap=cap), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_kernel_vs_plain(case, dtype, cuda):
    B, S, NH, KV, hd, pos, window, cap = case
    q, k, v = (a.to(cuda, dtype) for a in arrays(
        2, (B, NH, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = fd.launches
    out = ops.flash_decode(q, k, v, pos, scale=hd ** -0.5, window=window,
                           softcap=cap)
    assert fd.launches == before + 1
    close(out, ref.decode(q, k, v, pos, scale=hd ** -0.5, window=window,
                          softcap=cap), TOL[dtype])


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_strided_model_cache(kv_dtype, cuda):
    """bf16 q against the model's (B,KV,hd,S) K / (B,KV,S,hd) V caches,
    read through strided (B,S,KV,hd) views with no copy."""
    q, kc, vc = arrays(3, (4, 28, 128), (4, 4, 128, 80), (4, 4, 80, 128))
    q = q.to(cuda, torch.bfloat16)
    kv = kc.to(cuda, kv_dtype).permute(0, 3, 1, 2)
    vv = vc.to(cuda, kv_dtype).permute(0, 2, 1, 3)
    out = ops.flash_decode(q, kv, vv, 70, scale=128 ** -0.5)
    close(out, ref.decode(q, kv, vv, 70, scale=128 ** -0.5), 2e-2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 64, 2, 48), device=cuda)     # head_dim 48
    before = (fa.launches, fd.launches)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q, q, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_decode(q[:, 0], q, q, 3, scale=0.1)
    with pytest.raises(TypeError, match="dtypes"):
        ops.flash_attention(q[..., :32].half(), q[..., :32].half(),
                            q[..., :32].half(), 0.1)
    with pytest.raises(ValueError, match="pos"):
        ops.flash_decode(q[:, 0, :, :32].contiguous(), q[..., :32],
                         q[..., :32], 64, scale=0.1)
    assert (fa.launches, fd.launches) == before


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-2b", "granite-34b"])
def test_model_on_card_matches_cpu_paths(arch, cuda):
    cfg = reduce_for_smoke(get_config(arch))
    cpu = Model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    before = (fa.launches, fd.launches)
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        lg, pc = model.prefill(toks.to(dev))
        cache = _merge_prefill_cache(model.init_cache(2, 48, torch.float32),
                                     pc, 40)
        nxt = toks[:, :1].to(dev)
        ld, _ = model.decode_step(cache, nxt, 40)
        outs.append((lg.cpu(), ld.cpu()))
    n_attn = cfg.n_layers
    assert (fa.launches, fd.launches) == (before[0] + n_attn,
                                          before[1] + n_attn)
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=2e-4)
