"""Planter core: mapping trained ML models to staged table-lookup pipelines.

The paper's primary contribution, on the H100: encode-based mapping over
the hand-written CUDA lookup kernels, with the paper's stage/entry
resource accounting.
"""
from .encode_based import EBTreeEnsemble, eb_ensemble_from_arrays
from .pipeline import MappedModel, Pipeline, Stage
from .planter import (
    DEFAULT_STRATEGY,
    MAPPERS,
    SIZE_PARAMS,
    PlanterConfig,
    PlanterResult,
    convert_model,
    plant,
    train_model,
)
from .tables import (
    FeatureTable,
    LookupTable,
    NodeTable,
    PackedBnn,
    Resources,
    TernaryTable,
    pack_bits_uint32,
    pack_codes,
    range_to_ternary,
)

__all__ = [
    "MappedModel", "Pipeline", "Stage", "PlanterConfig", "PlanterResult",
    "plant", "train_model", "convert_model", "MAPPERS", "DEFAULT_STRATEGY",
    "SIZE_PARAMS", "EBTreeEnsemble", "eb_ensemble_from_arrays",
    "FeatureTable", "LookupTable", "NodeTable", "PackedBnn", "Resources",
    "TernaryTable", "pack_bits_uint32", "pack_codes", "range_to_ternary",
]
