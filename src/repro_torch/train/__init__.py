"""Training (mirrors ``repro.train``): AdamW, the train step and the
``ElasticTrainer`` supervision loop (``train.elastic``)."""
from . import optimizer
from .step import TrainConfig, init_train_state, make_train_step

__all__ = ["TrainConfig", "init_train_state", "make_train_step", "optimizer"]
