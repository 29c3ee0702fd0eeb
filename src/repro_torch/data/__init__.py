from repro_torch.data.pipeline import (
    SyntheticLM, ModalityStub, make_train_batches, Prefetcher,
)

__all__ = ["SyntheticLM", "ModalityStub", "make_train_batches", "Prefetcher"]
