"""Match/action pipeline IR with the paper's resource accounting.

A ``Pipeline`` is an ordered list of logical stages.  Tables that the paper
lets share one physical stage (e.g. all EB feature tables; all per-tree code
tables) live in a single ``Stage`` and are accounted once for stage count
but summed for entries — exactly the paper's model (§4.1: "all feature
tables share a pipeline stage ... the entire mapping requires only two
logical stages").

``MappedModel`` is the deployable artifact: accounting + a numpy reference
predictor + a PyTorch predictor factory.  Backends: ``"ref"`` runs the
plain PyTorch versions of the kernels on the given device, ``"cuda"`` the
model's CUDA kernels (EB: staged ``bucketize`` + ``ternary_match``; LB:
one ``lb_lookup`` launch with the decision fused in; DM-BNN:
``bnn_popcount_matmul``; the DM tree walk has no
kernel), ``"cuda_fused"`` one ``fused_eb`` launch per table (EB only), and
``"auto"`` picks with ``select_backend``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Union

import numpy as np
import torch

from ..device import resolve_device
from .tables import Resources

__all__ = ["Stage", "Pipeline", "MappedModel", "BACKENDS"]

BACKENDS = ("ref", "cuda", "cuda_fused", "auto")


@dataclasses.dataclass
class Stage:
    name: str
    kind: str  # feature | ternary | lut | logic | walk | bnn
    tables: List[Any] = dataclasses.field(default_factory=list)
    extra_stages: int = 0  # additional sequential stages this step burns (DM)

    def resources(self) -> Resources:
        entries = 0
        bits = 0
        stages = 1 + self.extra_stages
        for t in self.tables:
            r = t.resources()
            entries += r.entries
            bits = max(bits, r.entry_bits)
            stages = max(stages, r.stages + self.extra_stages)
        return Resources(stages=stages, entries=entries, entry_bits=bits)


@dataclasses.dataclass
class Pipeline:
    stages: List[Stage]

    def resources(self) -> Resources:
        total = Resources(stages=0, entries=0, entry_bits=0)
        for s in self.stages:
            total = total + s.resources()
        return total

    def summary(self) -> Dict[str, int]:
        r = self.resources()
        return {
            "stages": r.stages,
            "entries": r.entries,
            "entry_bits": r.entry_bits,
            "table_bits": r.table_bits,
        }


@dataclasses.dataclass
class MappedModel:
    """A trained model mapped to the M/A pipeline."""

    model_kind: str  # e.g. 'rf'
    strategy: str  # 'eb' | 'lb' | 'dm'
    pipeline: Pipeline
    predict_np: Callable[[np.ndarray], np.ndarray]
    # (backend, device) -> predictor taking [B, F] int values, giving [B]
    # int32 labels ([B, K] float32 outputs for LB ``raw`` models)
    make_torch_fn: Callable[[str, torch.device], Callable]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    convert_seconds: float = 0.0

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_np(np.asarray(x))

    def torch_predict(self, backend: str = "auto",
                      device: Union[str, torch.device] = "cuda") -> Callable:
        """The deployable predictor on ``device`` (default ``cuda``)."""
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        dev = resolve_device(device)
        if backend == "auto":
            backend = self.select_backend(dev)
        if backend == "cuda_fused" and self.strategy != "eb":
            raise ValueError(f"'cuda_fused' is the EB fused kernel; a "
                             f"{self.strategy.upper()} model takes 'cuda'")
        return self.make_torch_fn(backend, dev)

    def resources(self) -> Resources:
        return self.pipeline.resources()

    # ------------------------------------------------- backend selection
    # The JAX package's fused-kernel VMEM budget, kept so that both
    # packages take the same decision; the H100 kernel walks larger tables
    # in shared-memory tiles, so this bound is due for a measured revisit.
    GATE_MAX_ENTRIES = 4096

    def gate_sized(self) -> bool:
        """True when every table fits one fused launch."""
        return self.resources().entries <= self.GATE_MAX_ENTRIES

    def select_backend(self, device: Union[str, torch.device]) -> str:
        """Pick the predictor backend for ``device``.

        On ``cuda`` an EB model that is gate-sized gets the one-launch
        ``fused_eb`` kernel, any other EB model the staged kernels, and an
        LB or DM model its own kernels (``"cuda"``); the plain version is
        never picked on the card.  On the CPU the plain version is the only
        one.
        """
        if torch.device(device).type == "cpu":
            return "ref"
        if self.strategy != "eb":
            return "cuda"
        return "cuda_fused" if self.gate_sized() else "cuda"

