"""moe_drop_share.train: of the (token, choice) pairs that the port's
``repro_torch.models.moe.route`` decided in the traced window, the share
past their expert's capacity, in percent (100 x ``moe.pairs_dropped`` /
``moe.pairs_routed``; the remat recompute routes, and counts, again);
None for a port without the counters."""
from benchlib import program

SPANS = program.SPANS


def read(r):
    counts = program.counters()
    if not counts or counts["moe.pairs_routed"] <= 0:
        return None
    return 100.0 * counts["moe.pairs_dropped"] / counts["moe.pairs_routed"]
