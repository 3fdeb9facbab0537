"""Training (mirrors ``repro.train``): AdamW and the train step.

``ElasticTrainer`` (``repro.train.elastic``) is ROADMAP queue A item 10.
"""
from . import optimizer
from .step import TrainConfig, init_train_state, make_train_step

__all__ = ["TrainConfig", "init_train_state", "make_train_step", "optimizer"]
