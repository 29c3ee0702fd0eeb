from repro_torch.runtime.driver import ElasticTrainer, TrainReport

__all__ = ["ElasticTrainer", "TrainReport"]
