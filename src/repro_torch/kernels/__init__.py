"""Hand-written CUDA kernels for the Planter data-plane primitives.

Each kernel ships as ``<name>.py`` (checks, launch counter, ctypes call
into ``csrc/eb_kernels.cu``), with its plain PyTorch version in ``ref.py``
and device dispatch in ``ops.py``.  The CUDA sources are built on first
use, never at import.

* ``bucketize.py``     — EB feature encode (replaces ``bucketize_pallas``).
* ``ternary_match.py`` — TCAM decision table (``ternary_match_pallas``).
* ``fused_eb.py``      — encode + pack + match in one launch
  (``fused_eb_pallas``); the gate kernel of gate-sized tables.
"""
from .ops import (
    bucketize,
    fused_eb_match,
    launch_counts,
    reset_launch_counts,
    ternary_match,
)

__all__ = ["bucketize", "ternary_match", "fused_eb_match", "launch_counts",
           "reset_launch_counts"]
