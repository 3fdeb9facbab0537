"""CUDA kernel: LB feature tables + final-stage accumulate + decision.

Replaces ``lb_lookup_pallas`` (``src/repro/kernels/lb_lookup.py``), which
turned each feature's lookup into a one-hot x LUT matmul in float32 on the
MXU (exact only while ``F * 2^action_bits < 2^24``, so the JAX package
falls back to its gather oracle above 16 action bits), and, under
``jax.jit``, the XLA fusion of the LB predict around it
(``LBModel.make_jax_fn``: clip, bias, argmax / argmin / one-vs-one vote /
dequantization).

One launch, five epilogues (``epilogue``):

* ``"sums"`` (the Pallas function's contract): codes ``[B, F]`` int32 ->
  sums ``[B, K]`` int32 with 32-bit wrap; a code outside ``[0, V)`` adds 0,
  as in the Pallas kernel's one-hot product.
* ``"argmax"``, ``"argmin"``, ``"ovo_vote"``, ``"raw"`` (the LB predict):
  x is the raw int32 features; each is clamped to ``[0, V-1]`` (these
  modes clamp, only ``"sums"`` adds 0 out of range), then ``s[k] = bias[k]
  + sum_f lut[f, x_f, k]`` with wrap, compared signed.  argmax / argmin
  write the label ``[B]`` int32, first index on ties; ``"ovo_vote"`` has
  pair m (``pairs[m] = (a_m, c_m)``) vote ``a_m`` when ``s[m] > 0``, else
  ``c_m``, and writes the first of ``n_classes`` classes with the most
  votes; ``"raw"`` writes ``s / float32(scale)`` ``[B, K]`` float32 (IEEE
  division).

On the H100 the work is ``B*F*K`` int32 adds over ``B*F*4`` bytes of input
and 4 bytes (a label) or ``4K`` bytes a row of output, so it is bound by
device-memory bytes.  Design (``csrc/lb_dm_kernels.cu`` says why): a
thread owns a row and holds its K sums in registers; each block's rows
come in tiles staged in shared memory by 16-byte ``cp.async`` in a
three-tile ring; the LUT is staged once per block in shared memory, each
``(f, code)`` row padded to one vector load, up to the card's 227 KB
(opted in), past that read through the cache.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import _build
from ._launch import aligned16, require, stream_ptr
from .ref import LB_EPILOGUES, lb_lookup_ref

launches = 0  # kernel launches; the main-path check reads and resets it

PLAN_KEYS = ("grid", "blocks_per_sm", "smem_bytes", "lut_in_smem",
             "rows_per_tile", "tiles_per_block", "sums_in_registers")


def lb_lookup(x: torch.Tensor, luts: torch.Tensor, epilogue: str = "sums",
              bias: Optional[torch.Tensor] = None,
              pairs: Optional[torch.Tensor] = None, n_classes: int = 0,
              scale: float = 1.0) -> torch.Tensor:
    """x [B, F] int32, luts [F, V, K] int32 -> sums [B, K] int32 (a code
    outside [0, V) adds 0), or with ``epilogue`` the LB predict's output
    from the raw features (clamped to [0, V-1]): the label [B] int32
    (``"argmax"``, ``"argmin"``, ``"ovo_vote"`` over ``pairs`` [K, 2] and
    ``n_classes``) or ``s / scale`` [B, K] float32 (``"raw"``), with
    ``bias`` [K] int32 added to the sums."""
    global launches
    _check_args(luts, epilogue, bias, pairs, n_classes)
    if x.device.type == "cpu":
        return lb_lookup_ref(x, luts, epilogue, bias, pairs, n_classes, scale)
    dev = x.device
    require(x, "x", 2, dev)
    require(luts, "luts", 3, dev)
    B, F = x.shape
    Fl, V, K = luts.shape
    if Fl != F:
        raise ValueError(f"luts {tuple(luts.shape)} vs x {(B, F)}")
    if luts.numel() >= 2**31:
        raise ValueError(f"luts {tuple(luts.shape)} exceed int32 indexing")
    if bias is not None:
        require(bias, "bias", 1, dev)
    if pairs is not None:
        require(pairs, "pairs", 2, dev)
    label = epilogue in ("argmax", "argmin", "ovo_vote")
    out = torch.empty((B,) if label else (B, K),
                      dtype=torch.float32 if epilogue == "raw"
                      else torch.int32, device=dev)
    lib = _build.load("lb_dm_kernels")
    err = lib.lb_lookup(aligned16(x).data_ptr(), luts.data_ptr(),
                        None if bias is None else bias.data_ptr(),
                        None if pairs is None else pairs.data_ptr(),
                        out.data_ptr(), B, F, V, K, int(n_classes),
                        LB_EPILOGUES.index(epilogue), float(scale),
                        stream_ptr(dev))
    _build.check(lib, err, "lb_lookup")
    launches += 1
    return out


def _check_args(luts, epilogue, bias, pairs, n_classes) -> None:
    """The shapes and arguments each epilogue takes; raise on others."""
    if epilogue not in LB_EPILOGUES:
        raise ValueError(f"epilogue {epilogue!r} not in {LB_EPILOGUES}")
    if luts.dim() != 3:
        raise ValueError(f"luts must be [F, V, K], got {tuple(luts.shape)}")
    K = luts.shape[2]
    if epilogue == "sums" and (bias is not None or pairs is not None):
        raise ValueError("the sums epilogue takes no bias and no pairs")
    if bias is not None and tuple(bias.shape) != (K,):
        raise ValueError(f"bias {tuple(bias.shape)} vs K = {K}")
    if epilogue == "ovo_vote":
        if pairs is None or tuple(pairs.shape) != (K, 2) or n_classes < 1:
            got = None if pairs is None else tuple(pairs.shape)
            raise ValueError(f"ovo_vote takes pairs [{K}, 2] and n_classes "
                             f">= 1, got {got} and {n_classes}")
    elif pairs is not None:
        raise ValueError(f"pairs are for ovo_vote, not {epilogue!r}")
    if epilogue in ("argmax", "argmin") and K == 0:
        raise ValueError(f"{epilogue} over K = 0 sums")


def plan(B: int, F: int, V: int, K: int,
         epilogue: str = "sums") -> Dict[str, int]:
    """The launch ``lb_lookup`` makes for these sizes on the current card,
    without launching it: grid, resident blocks an SM (the occupancy
    calculator), dynamic shared memory, whether the LUT sits in shared
    memory, rows a tile, tiles a block and the sums a thread holds."""
    lib = _build.load("lb_dm_kernels")
    report = (ctypes.c_int * len(PLAN_KEYS))()
    err = lib.lb_lookup_plan(B, F, V, K, LB_EPILOGUES.index(epilogue), report)
    _build.check(lib, err, "lb_lookup_plan")
    return dict(zip(PLAN_KEYS, report))
