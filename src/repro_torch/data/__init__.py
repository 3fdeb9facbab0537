"""Data substrate: the use-case generators (pure numpy)."""
from .synthetic import DATASETS, Dataset, load_dataset

__all__ = ["Dataset", "load_dataset", "DATASETS"]
