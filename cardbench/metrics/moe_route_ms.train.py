"""moe_route_ms.train: the device milliseconds a train step spends in the
kernels launched inside ``repro_torch.models.moe.route`` (the router's
product, softmax, top-k and the slot positions by a stable sort of the
expert ids; in the forward pass and in its recompute under remat, not in
autograd's backward)."""
from benchlib.readers import span_ms_per_unit

TARGET = "repro_torch.models.moe:route"
SPANS = {TARGET: None}


def read(r):
    return span_ms_per_unit(r, TARGET)
