"""flash_attention_roofline.prefill: of the calls to the port's public
entry ``repro_torch.kernels.ops.flash_attention``, the least time of
their work at the card's peaks (FLOPs over the causal pairs, each input
read and the output written once; ``benchlib.work.attention_call``) over
the device time of the kernels they launched, in percent."""
from benchlib import work
from benchlib.readers import roofline

TARGET = "repro_torch.kernels.ops:flash_attention"


def call_work(q, k, v, scale, causal=True, window=0, softcap=0.0):
    return work.attention_call(tuple(q.shape), tuple(k.shape),
                               causal=causal, window=window,
                               itemsize=q.element_size())


SPANS = {TARGET: call_work}


def read(r):
    return roofline(r, TARGET)
