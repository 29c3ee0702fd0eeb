from repro_torch.optim.adamw import (
    AdamW, OptConfig, clip_by_global_norm, global_norm,
)
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["AdamW", "OptConfig", "global_norm", "clip_by_global_norm",
           "cosine_warmup"]
