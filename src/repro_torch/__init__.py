"""PyTorch / CUDA port of the Planter system for the NVIDIA H100.

Mirrors ``src/repro/`` module for module; each TPU (Pallas) kernel on a
ported path is a hand-written Hopper kernel under ``kernels/``.  The port
imports ``torch`` and never ``jax``, and nothing of the JAX package.

It carries Planter's plant -> predict path for every mapping: ``data``,
the trainers in ``ml``, ``core`` (tables, pipeline, the encode-based,
lookup-based and direct-map mappers, planter) and the ``bucketize``,
``ternary_match``, ``fused_eb``, ``lb_lookup`` and ``bnn_popcount_matmul``
kernels; and the host-driven paged serve path of the dense LM family:
``configs``, ``arch`` (model, weight conversion, sampling), ``nn``,
``serve`` (engine, page pool, faults) and the ``paged_attention``
kernel; and the trainer of the dense LM family: ``train`` (AdamW, the
train step), ``ckpt``, ``data.tokens``, ``dist`` (compression,
preemption) and ``launch.train``, every forward product through the
``linear`` kernel.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see ``device.py``).
"""
from .device import card_info, resolve_device

__all__ = ["card_info", "resolve_device"]
