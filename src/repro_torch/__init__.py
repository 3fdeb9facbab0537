"""PyTorch / CUDA port of the Planter system for the NVIDIA H100.

Mirrors ``src/repro/`` module for module; each TPU (Pallas) kernel on a
ported path is a hand-written Hopper kernel under ``kernels/``.  The port
imports ``torch`` and never ``jax``, and nothing of the JAX package.

This slice carries Planter's plant -> predict path for encode-based (EB)
mappings: ``data``, the EB trainers in ``ml``, ``core`` (tables, pipeline,
EB mappers, planter) and the ``bucketize``, ``ternary_match`` and
``fused_eb`` kernels.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (see ``device.py``).
"""
from .device import card_info, resolve_device

__all__ = ["card_info", "resolve_device"]
