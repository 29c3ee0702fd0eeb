from repro_torch.optim.adamw import (
    AdamW, OptConfig, clip_by_global_norm, global_norm,
)
from repro_torch.optim.compress import (
    compressed_pod_allreduce, dequantize_int8, ef_init, quantize_int8,
)
from repro_torch.optim.schedule import cosine_warmup

__all__ = ["AdamW", "OptConfig", "global_norm", "clip_by_global_norm",
           "cosine_warmup", "quantize_int8", "dequantize_int8",
           "compressed_pod_allreduce", "ef_init"]
