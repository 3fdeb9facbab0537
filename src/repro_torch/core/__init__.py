"""Planter core: mapping trained ML models to staged table-lookup pipelines.

The paper's primary contribution, on the H100: encode-based, lookup-based
and direct-map mappings over the hand-written CUDA kernels, with the
paper's stage/entry resource accounting.
"""
from .direct_map import DMBnn, DMForest, dm_bnn_from_arrays, dm_forest_from_arrays
from .encode_based import EBTreeEnsemble, eb_ensemble_from_arrays
from .lookup_based import LBModel, lb_model_from_arrays
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
    "SIZE_PARAMS", "EBTreeEnsemble", "eb_ensemble_from_arrays", "LBModel",
    "lb_model_from_arrays", "DMForest", "DMBnn", "dm_forest_from_arrays",
    "dm_bnn_from_arrays",
    "FeatureTable", "LookupTable", "NodeTable", "PackedBnn", "Resources",
    "TernaryTable", "pack_bits_uint32", "pack_codes", "range_to_ternary",
]
