"""flash_decode_roofline.decode: of the calls to the port's public entry
``repro_torch.kernels.ops.flash_decode``, the least time of their work
at the card's peaks (each row's keys 0 .. pos of each KV head read once,
q read, the output written; ``benchlib.work.decode_call``) over the
device time of the kernels they launched, in percent."""
from benchlib import work
from benchlib.readers import roofline

TARGET = "repro_torch.kernels.ops:flash_decode"


def call_work(q, k_cache, v_cache, pos, *, scale, window=0, softcap=0.0):
    return work.decode_call(tuple(q.shape), tuple(k_cache.shape), int(pos),
                            window=window, q_itemsize=q.element_size(),
                            kv_itemsize=k_cache.element_size())


SPANS = {TARGET: call_work}


def read(r):
    return roofline(r, TARGET)
