"""attn_bwd_ms.train: the device milliseconds a train step spends in the
kernels launched inside the port's span ``attn.flash_bwd``
(``repro_torch.kernels.ops._fa_bwd``: the attention backward, recomputed
in float32 through ``ref.attention``, on autograd's thread); from the
port's own ranges (``benchlib.program``), so None for a port without
them."""
from benchlib import program

SPANS = program.SPANS


def read(r):
    return program.span_ms_per_unit(r, ("attn.flash_bwd",))
