"""adamw_ms.train: the device milliseconds a train step spends in the
kernels launched inside ``repro_torch.optim.adamw.AdamW.update`` (the
global-norm clip and the update of every leaf)."""
from benchlib.readers import span_ms_per_unit

TARGET = "repro_torch.optim.adamw:AdamW.update"
SPANS = {TARGET: None}


def read(r):
    return span_ms_per_unit(r, TARGET)
