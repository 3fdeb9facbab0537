"""Hand-written CUDA kernels for the Planter data-plane primitives.

Each kernel ships as ``<name>.py`` (checks, launch counter, ctypes call
into ``csrc/``), with its plain PyTorch version in ``ref.py`` and device
dispatch in ``ops.py``.  The CUDA sources are built on first use, never at
import.

* ``bucketize.py``     — EB feature encode (replaces ``bucketize_pallas``).
* ``ternary_match.py`` — TCAM decision table (``ternary_match_pallas``).
* ``fused_eb.py``      — encode + pack + match in one launch
  (``fused_eb_pallas``); the gate kernel of gate-sized tables.
* ``lb_lookup.py``     — LB feature tables + accumulate
  (``lb_lookup_pallas``), and the whole LB predict in the same launch.
* ``bnn_mlp.py``       — DM-BNN XNOR-popcount layer
  (``bnn_popcount_matmul_pallas``).
* ``paged_attention.py`` — paged attention over the block-table KV cache
  of the serve path (``paged_attention``).
* ``linear.py``        — the serve step's products, each row's bits
  independent of the other rows (no Pallas kernel: XLA's dots).
* ``moe.py``           — the MoE block's expert down product and combine
  in one launch (no Pallas kernel: XLA's einsums).

The first three live in ``csrc/eb_kernels.cu``, the next two in
``csrc/lb_dm_kernels.cu``, then ``csrc/paged_attention.cu``,
``csrc/linear.cu`` and ``csrc/moe.cu``.
"""
from .ops import (
    bnn_forward,
    bnn_popcount_matmul,
    bucketize,
    fused_eb_match,
    launch_counts,
    lb_lookup,
    linear,
    moe_down_combine,
    pack_bits,
    paged_attention,
    reset_launch_counts,
    ternary_match,
)

__all__ = ["bucketize", "ternary_match", "fused_eb_match", "lb_lookup",
           "bnn_popcount_matmul", "pack_bits", "bnn_forward",
           "paged_attention", "linear", "moe_down_combine", "launch_counts",
           "reset_launch_counts"]
