"""moe_dispatch_ms.train: the device milliseconds a train step spends in
the kernels launched inside the port's spans ``moe.dispatch`` and
``moe.combine`` and their backward (``repro_torch.models.moe._experts``:
the scatter of the kept pairs into the experts' buffer, the gather back
and the k-way sum; forward, remat recompute and autograd's backward, the
experts' own FFN left out); from the port's own ranges
(``benchlib.program``), so None for a port without them."""
from benchlib import program

SPANS = program.SPANS
NAMES = ("moe.dispatch", "moe.dispatch.backward", "moe.combine",
         "moe.combine.backward")


def read(r):
    return program.span_ms_per_unit(r, NAMES)
