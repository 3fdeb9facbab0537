"""Data substrate: the use-case generators and the LM token pipeline (pure
numpy, copied from the JAX package)."""
from .synthetic import DATASETS, Dataset, load_dataset
from .tokens import TokenPipeline, TokenPipelineConfig

__all__ = ["Dataset", "load_dataset", "DATASETS", "TokenPipeline",
           "TokenPipelineConfig"]
