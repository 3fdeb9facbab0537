"""Smoke run of the PyTorch port on one H100: build, check, drive, time.

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card, bitwise,
   at the sweep shapes of the kernel tests plus edge cases: ``bucketize``
   at T = 1, T not a power of two, rows past 48 KB and past the shared-
   memory budget, INT32_MAX values, a view at an offset, threshold rows
   in any order (compare-counted); ``lb_lookup`` with codes outside
   [0, V), which add 0, and its predict modes (argmax, argmin, ovo_vote,
   raw) on raw features in and outside [0, V) with a wrapping bias, at K
   up to 16 (past the register chunk of 8), LUTs in opted-in shared
   memory and past 227 KB; ``bnn_popcount_matmul``'s modes (packed or
   feature input x counts, sign words or scores) at W 1-4 and 10, N 48
   and 33, 600,001 rows;
3. main path: ``plant`` rf, encode-based, size L on unsw (not gate-sized,
   so ``torch_predict("auto")`` runs ``bucketize`` + ``ternary_match``)
   and predict 2^20 flows; labels equal the plain path on the card, and on
   the first 65,536 flows the numpy reference and the native forest;
4. fused path: the same for rf size M (gate-sized, so ``fused_eb``);
5. per-kernel times (CUDA events around one call, median, which include
   the host's launch overhead; and the profiler's device time) beside the
   plain version's, the least time the card could take, and for
   ``bucketize`` one ``torch.searchsorted`` call as the library yardstick;
   flows/s of both predict paths;
6. LB path: ``plant`` svm, nb, kmeans, pca and ae, lookup-based, size L
   on unsw and predict 2^20 flows through ``auto``: one ``lb_lookup``
   launch per predict (clamp, gather, bias and the decision fused), and
   one device kernel on the profiler; labels (pca/ae: int32 sums bitwise,
   float outputs within 1e-5) equal the plain path on the card, and on
   the first 65,536 flows the numpy reference; each predict timed, and
   the launch plan (grid, blocks an SM, shared memory) printed;
7. DM path: bnn direct-map size L, trained on the card: two
   ``bnn_popcount_matmul`` launches per predict (layer 1 packs the
   features and its signs, layer 2 writes the scores), labels equal the
   plain path, the numpy reference and the native model; dt and rf
   direct-map size L walk their trees in plain torch on the card, labels
   equal numpy and native.  Then ``lb_lookup`` (kmeans-LB L: the sums
   mode on the clamped codes, with ``F.embedding_bag`` as library
   yardstick, and the predict's own fused argmin launch on the raw
   features, a row each) and ``bnn_popcount_matmul`` (BNN-L layer 1,
   counts mode, with a bf16 ``torch.matmul`` of the ±1 matrices) are timed
   like phase 5, and the BNN predict's two fused launches beside their
   bounds (the ``fused`` list of the kernel's JSON row);
8. ``paged_attention``: the kernel against its plain version over a grid
   (C 1 and 8, page 8 and 16, H/KV 12/2 and 4/4, bf16 and int8 pools,
   window 0 and 13, table entries past the pool, and a row at position -1
   that sees no key) within one bf16 ulp of the output's largest
   magnitude; its rows bitwise invariant to the batch (a slot alone vs in
   a batch of 16), the chunk (C = 8 vs C = 1 calls), the physical page
   order and other values in the rows past each slot's position; timed at
   the serve decode shape (16 slots, 64 pages of 16, bf16) with every
   position weighed and with 256 of 1,024 visible, each beside its plain
   version and a gather + ``F.scaled_dot_product_attention`` yardstick.
   ``linear``: for each of a qwen2-1.5b step's eight products (wq, wk, wv,
   wo, w_gate, w_up, w_down, the float32 head) and M in {1, 16, 48, 64,
   128, 256}, every row bitwise equal at offsets 0 and 7 and computed
   alone; within ``linear_limit`` of its plain version (2 K 2^-24
   sum|x||w| plus one bf16 ulp of a bf16 output, fixed before any run);
   the step's two groups (``linear_group`` of wq/wk/wv and of
   w_gate/w_up) at the same M, each member bitwise its lone launch; each
   product and group timed at M = 16 and 128, L2-cold (rotating over
   copies of its weights past 120 MB), beside cuBLAS (``x @ w``, a
   group's members one after another) and its byte bound, and summed
   into a step's products at C = 8 and C = 1;
9. serve: qwen2-1.5b at full width and depth, weights random-init from
   ``--seed`` (default 0), through ``ServeEngine`` + ``ContinuousBatcher``
   over the paged cache (16 slots, cache 1024, page 16) with an rf-S
   admission gate on unsw features: 32 requests, prompt lengths drawn in
   [16, 256] from the seed, 32 tokens each.  ``paged_attention`` launches
   equal steps x 28, ``linear`` steps x (4 x 28 + 1), ``fused_eb``
   launched at admission, served + dropped
   = submitted; tokens/s and ms per step; a torch.profiler window for the
   device's busy and idle share;
10. serve parity, on limits fixed before any run: (a) the same workload
   through the ``"torch"`` backend, capturing the attention inputs of all
   28 layers at steps 0, 64, 128 and 192: the kernel on each within one
   bf16 ulp of the plain output's largest magnitude; (b) the served
   streams teacher-forced through the kernel path and the plain path over
   at least 512 generated positions: at each, ``max|logits_kernel -
   logits_plain| <= 0.03 * max|logits_plain|`` (delta), and a greedy flip
   only where the plain top-2 margin is within 2 delta (the flips and the
   greedy agreement rate are printed, not gated); (c) ``share_prefix``
   streams bitwise equal to unshared ones; (d) one ``kv_int8`` run;
11. the device batcher: phase 9's workload through
   ``DeviceContinuousBatcher`` (the fused step, one CUDA graph per shape
   key, replayed ``sync_every`` times a host round trip): (a) sync_every
   16, prefill_chunk 8, graph on: served + dropped = submitted, the
   gate-reject set = the gate's numpy verdicts, drops only gate-reject or
   quarantined, ``pool.ref`` back to the prefix holds; (b) prefill_chunk
   1: done, dropped, drop reasons and every stream bitwise equal to phase
   9's host batcher; (c) graph vs eager and sync_every 1 vs 16, bitwise;
   (d) chunk 8 vs 1: every stream and drop bitwise, and each of layer 0's
   products gives a row the same bits in a [128, K] as in a [16, K]
   operand; (e) rounds of the eager and the replayed step under
   ``torch.cuda.set_sync_debug_mode("error")``; (f) the profiler's
   kernels over one round and its gate call: ``paged_attention`` = steps
   run x 28, ``linear`` = steps run x (4 x 28 + 1), ``fused_eb`` =
   (steps run + 1) x the gate's tables, no other kernel of the repo.
   Tokens/s and ms a step,
   graph and eager, beside phase 9's, the steps with work, run and wasted,
   and the device's idle share of a replayed step;
12. speculative decoding: phase 9's workload through the device batcher
   with ``spec_k`` 3 and a bigram draft trained on a pilot wave (phase
   11's streams of the first 16 requests): every greedy stream and drop
   bitwise phase 11's, at least one draft accepted, a round without a
   synchronising call; drafted, accepted, acceptance rate and tokens/s of
   a warm wave beside phase 11's;
13. ``obs`` and faults: a traced run (Tracer + Metrics) whose streams and
   drops are bitwise the untraced run's, every lifecycle valid, TTFT and
   decode ms a token (p50, p99) printed; a fault-plan run (a corrupted
   token in slot 3 at drain 1, every free page held at drain 2 for two
   drains): exactly that request quarantined, every other stream phase
   11's, ``pool.ref`` back to its prefix holds.

Bounds: bytes over 3.35 TB/s, or operations over the bf16 tensor-core
peak or the int32 lane rate (64 lanes an SM x the SMs x ``clocks.max.sm``,
printed on the first line beside the card).

Its last three lines are the kernels JSON, the card's ``name, power.limit``
and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 1 << 20  # flows per main-path predict
CHUNK = 1 << 16  # rows per plain-version chunk on the card
INT32_MAX = np.iinfo(np.int32).max
# H100 SXM published peak (NVIDIA data sheet): HBM3 bytes/s.
PEAK_BYTES = 3.35e12
# int32 operations/s: Hopper has 64 INT32 lanes an SM (half its 128 FP32
# lanes), so 64 x the SMs x the SM clock nvidia-smi reports as its maximum;
# ``main`` sets it from the card (16.7e12 on an NVIDIA H100 80GB HBM3 at
# 700.00 W, whose clocks.max.sm is 1980 MHz).
INT32_LANES_PER_SM = 64
PEAK_INT32_OPS = 0.0
SOURCE = "src/repro_torch/kernels/csrc/eb_kernels.cu"
LB_DM_SOURCE = "src/repro_torch/kernels/csrc/lb_dm_kernels.cu"
PA_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
LINEAR_SOURCE = "src/repro_torch/kernels/csrc/linear.cu"
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), FLOP/s
PEAK_BF16_FLOPS = 989e12
REPLACES = {
    "bucketize": "src/repro/kernels/bucketize.py:32",
    "ternary_match": "src/repro/kernels/ternary_match.py:53",
    "fused_eb": "src/repro/kernels/fused_eb.py:66",
    "lb_lookup": "src/repro/kernels/lb_lookup.py:39",
    "bnn_popcount_matmul": "src/repro/kernels/bnn_mlp.py:33",
    "paged_attention": "src/repro/kernels/paged_attention.py:107",
    # no Pallas kernel: the step's products are XLA dots in the JAX package
    # (attention.py:57-59 and :289, mlp.py:24-25, arch/model.py:330)
    "linear": "src/repro/nn/attention.py:57",
}
LB_MODELS = ("svm", "nb", "kmeans", "pca", "ae")


def peak_int32_ops(dev) -> float:
    """INT32_LANES_PER_SM x the card's SMs x ``clocks.max.sm`` (Hz)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=30).stdout
    mhz = float(out.splitlines()[0].strip())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def i32(a: np.ndarray, dev) -> torch.Tensor:
    """numpy array (uint32 words as their int32 bits) -> int32 on ``dev``."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a.astype(np.int32, copy=False), device=dev)


def same(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else "shape"
        fail(f"{name}: kernel differs from its plain version ({bad})")


# ----------------------------------------------------------- phase 2 cases
def rand_rows(rng, N, W, n_keys):
    values = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    masks = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
    values &= masks
    pa = (np.arange(N, dtype=np.int32) * 256
          + rng.integers(0, 256, N).astype(np.int32))
    keys = rng.integers(0, 2**32, (n_keys, W), dtype=np.uint32)
    keys[: n_keys // 2] = values[rng.integers(0, N, n_keys // 2)]
    return keys, values, masks, pa


def check_kernels(dev) -> int:
    from test_torch_cuda import _lb_out_of_range_case, _unsorted_bucketize_case

    from repro_torch.core.tables import key_layout
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(42)
    n = 0
    # bucketize: test sweep, INT32_MAX against padding; T = 1, T not a
    # power of two, rows past 48 KB (opt-in, 64 KB) and past the shared-
    # memory budget (read through L1, 256 KB), many persistent strides; a
    # view at an unaligned offset (element by element)
    cases = [(B, F, T) for B in (1, 7, 256, 1000)
             for F, T in ((1, 1), (5, 9), (8, 32))] + [
                 (3000, 8, 2000), (BATCH + 3, 5, 1), (100003, 5, 37),
                 (20001, 8, 8000)]
    for B, F, T in cases:
        vals = rng.integers(0, 2**16, (B + 1, F)).astype(np.int32)
        thr = np.sort(rng.integers(0, 2**16, (F, T)), axis=1).astype(np.int32)
        thr[:, T // 2:] = INT32_MAX  # padded tail
        vals[:2, 0] = INT32_MAX
        vals[::7, -1] = INT32_MAX
        vals[1::5, 0] = -3
        big, t = i32(vals, dev), i32(thr, dev)
        for name, v in (("", big[:B]), (" view at an offset", big[1:])):
            same(f"bucketize {B}x{F}x{T}{name}", ops.bucketize(v, t),
                 chunked(lambda c: ref.bucketize_ref(c, t), v))
            n += 1
    # bucketize on rows in any order (compare-counted): [5, 3, INT32_MAX],
    # a reversed row, ties; rows in shared memory and through L1
    for B, T in ((1000, 3), (300001, 28), (5000, 8000)):
        vals, thr = _unsorted_bucketize_case(T, B, T)
        v, t = i32(vals, dev), i32(thr, dev)
        same(f"bucketize {B}x{thr.shape[0]}x{T}, rows in any order",
             ops.bucketize(v, t), chunked(lambda c: ref.bucketize_ref(c, t), v))
        n += 1
    # ternary_match: test sweep, W = 3 and 5 (run-time word count), N
    # beyond one shared-memory tile and not a multiple of any tile, B = 1
    for B, N, W in ((1, 1, 1), (64, 100, 1), (200, 700, 2), (33, 513, 3),
                    (1, 700, 2), (1000, 5000, 3), (300, 301, 5)):
        k, v, m, pa = (i32(a, dev) for a in rand_rows(rng, N, W, B))
        same(f"ternary_match {B}x{N}x{W}", ops.ternary_match(k, v, m, pa, 254),
             ref.ternary_match_ref(k, v, m, pa, 254))
        n += 1
    # overlapping rows: the higher priority wins
    v = i32(np.array([[0b1000], [0b1000]], np.uint32), dev)
    pa = i32(np.array([0 * 256 + 7, 1 * 256 + 9], np.int32), dev)
    k = i32(np.array([[0b1010]], np.uint32), dev)
    got = ops.ternary_match(k, v, v, pa, 0)
    same("ternary_match priority", got, ref.ternary_match_ref(k, v, v, pa, 0))
    if got.item() != 9:
        fail(f"ternary_match priority: got {got.item()}, want 9")
    # no row matches: the default action
    v = i32(np.array([[0xFFFFFFFF]], np.uint32), dev)
    k = i32(np.array([[3]], np.uint32), dev)
    pa = i32(np.array([5], np.int32), dev)
    got = ops.ternary_match(k, v, v, pa, 123)
    if got.item() != 123:
        fail(f"ternary_match default: got {got.item()}, want 123")
    n += 2
    # fused_eb: encode + pack + match, thresholds in and beyond the shared
    # staging budget, rows beyond one tile, identity codes, B = 1
    for B, F, T, N, identity in ((1, 5, 12, 201, False),
                                 (1000, 5, 28, 540, False),
                                 (777, 8, 600, 3000, False),
                                 (513, 5, 1, 1024, True)):
        if identity:
            widths = [8] * F
            vals = rng.integers(0, 256, (B, F)).astype(np.int32)
            thr = np.full((F, T), INT32_MAX, np.int32)
        else:
            vals = rng.integers(0, 2**16, (B, F)).astype(np.int32)
            vals[0, -1] = INT32_MAX
            thr = np.sort(rng.integers(0, 2**16, (F, T)), axis=1).astype(np.int32)
            thr[:, -1] = INT32_MAX
            widths = [max(1, int(np.ceil(np.log2(T + 1))))] * F
        layout = key_layout(widths)
        W = max(w for w, _, _ in layout) + 1
        lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
        x, t = i32(vals, dev), i32(thr, dev)
        codes = x if identity else ref.bucketize_ref(x, t)
        keys = ref.pack_codes_ref(codes, layout, W).cpu().numpy().view(np.uint32)
        _, rv, rm, pa = rand_rows(rng, N, W, 0)
        hit = rng.integers(0, B, N // 2)
        rv[: N // 2] = keys[hit] & rm[: N // 2]
        rv, rm, pa = i32(rv, dev), i32(rm, dev), i32(pa, dev)
        same(f"fused_eb {B}x{F}x{T} N={N} identity={identity}",
             ops.fused_eb_match(x, t, rv, rm, pa, lay, 77, identity),
             ref.fused_eb_ref(x, t, rv, rm, pa, lay, 77, identity))
        n += 1
    # lb_lookup: the JAX sweep, the 48 KB shared-memory edge, and a LUT
    # past it that is read through the cache
    for B, F, V, K in ((1, 1, 2, 1), (100, 5, 64, 6), (257, 3, 256, 16),
                       (3000, 8, 256, 16), (70000, 5, 256, 3)):
        codes = i32(rng.integers(0, V, (B, F)), dev)
        luts = i32(rng.integers(-(2**15), 2**15, (F, V, K)), dev)
        same(f"lb_lookup {B}x{F}x{V}x{K}", ops.lb_lookup(codes, luts),
             ref.lb_lookup_ref(codes, luts))
        n += 1
    # lb_lookup: codes outside [0, V) add 0; LUT in shared memory (past
    # 48 KB: opted in) and past the card's 227 KB (through the cache)
    for B, F, V, K in ((100, 5, 64, 6), (3000, 8, 256, 16), (2049, 5, 256, 3),
                       (5000, 8, 1024, 8)):
        codes, luts = (i32(a, dev)
                       for a in _lb_out_of_range_case(B, B, F, V, K))
        same(f"lb_lookup {B}x{F}x{V}x{K}, codes outside [0, V)",
             ops.lb_lookup(codes, luts), ref.lb_lookup_ref(codes, luts))
        n += 1
    n += check_lb_modes(rng, dev)
    # bnn_popcount_matmul: the JAX sweep (n_in bits -> words), words with
    # bit 31 set, and a batch of many tiles
    for B, n_in, N in ((1, 1, 1), (64, 40, 16), (100, 100, 3), (17, 64, 33),
                       (70001, 40, 48)):
        W = -(-n_in // 32)
        x = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
        w = rng.integers(0, 2**32, (N, W), dtype=np.uint32)
        x[0, 0] |= np.uint32(1 << 31)
        w[0, -1] |= np.uint32(1 << 31)
        x, w = i32(x, dev), i32(w, dev)
        same(f"bnn_popcount_matmul {B}x{W} N={N}",
             ops.bnn_popcount_matmul(x, w), ref.bnn_popcount_matmul_ref(x, w))
        n += 1
    n += check_bnn_modes(rng, dev)
    torch.cuda.synchronize(dev)
    return n


# (B, F, V, K) of the lb_lookup predict-mode grid: the sums grid above,
# the main path's shape past many tiles a block, K past the register cap
# (13, 16), LUTs past 48 KB (128 KB, opted-in shared memory) and past 227 KB
# (256 KB, through the cache)
LB_MODE_GRID = ((1, 1, 2, 1), (100, 5, 64, 6), (257, 3, 256, 16),
                (3000, 8, 256, 16), (70000, 5, 256, 3), (BATCH + 3, 5, 256, 3),
                (BATCH + 1, 5, 256, 2), (20001, 4, 16, 13), (5000, 8, 1024, 8))
LB_MODES = ("argmax", "argmin", "ovo_vote", "raw")


def check_lb_modes(rng, dev) -> int:
    """lb_lookup's predict modes against their plain versions: labels
    bitwise, raw within 1e-5; raw features in and outside [0, V), a bias
    add that wraps, sums that tie, one-vs-one pairs of the fewest classes
    that give K of them."""
    from test_torch_cuda import _lb_predict_case

    from repro_torch.kernels import ops, ref

    n = 0
    for B, F, V, K in LB_MODE_GRID:
        n_classes = next(c for c in range(2, 64) if c * (c - 1) // 2 >= K)
        x, luts, bias, pairs = (i32(a, dev) for a in _lb_predict_case(
            int(rng.integers(2**31)), B, F, V, K, n_classes))
        for mode in LB_MODES:
            kw = dict(bias=bias, scale=0.37)
            if mode == "ovo_vote":
                kw.update(pairs=pairs, n_classes=n_classes)
            got = ops.lb_lookup(x, luts, mode, **kw)
            want = chunked(lambda c: ref.lb_lookup_ref(c, luts, mode, **kw),
                           x)
            name = f"lb_lookup {B}x{F}x{V}x{K} {mode}"
            if mode == "raw":
                if (got.dtype != torch.float32 or got.shape != want.shape
                        or not torch.allclose(got, want, rtol=1e-5,
                                              atol=1e-5)):
                    fail(f"{name}: kernel differs from its plain version")
            else:
                same(name, got, want)
            n += 1
    return n


# W -> (in_bits, F) of a feature input that packs into W words
BNN_FEATURES = {1: (8, 3), 2: (8, 5), 3: (7, 13), 4: (5, 25), 10: (9, 35)}


def check_bnn_modes(rng, dev, B: int = 600001) -> int:
    """bnn_popcount_matmul's modes against their plain versions: packed or
    feature input (prologue) x counts, sign words or scores, at W 1-4 (one
    vector load) and 10 (run-time chunks), N a multiple of 4 and not, B
    past many persistent strides; features past in_bits and negative."""
    from repro_torch.kernels import ops, ref

    n = 0
    for W, (in_bits, F) in BNN_FEATURES.items():
        for N in (48, 33):
            w = i32(rng.integers(0, 2**32, (N, W), dtype=np.uint32), dev)
            feats = rng.integers(0, 2**in_bits, (B, F)).astype(np.int32)
            feats[::11] = rng.integers(-2**31, 2**31, (len(feats[::11]), F))
            packed = rng.integers(0, 2**32, (B, W), dtype=np.uint32)
            for x, bits, n_in in ((i32(packed, dev), 0, 32 * W - 5),
                                  (i32(feats, dev), in_bits, F * in_bits)):
                for ep in ("counts", "sign", "score"):
                    same(f"bnn_popcount_matmul {B}x{W} N={N} in_bits={bits}"
                         f" {ep}",
                         ops.bnn_popcount_matmul(x, w, bits, ep, n_in),
                         chunked(lambda c: ref.bnn_popcount_matmul_ref(
                             c, w, bits, ep, n_in), x))
                    n += 1
    return n


# ------------------------------------------------------- phases 3 and 4
@dataclasses.dataclass
class PathRun:
    res: Any  # PlanterResult
    x: torch.Tensor  # the flows on the card
    fn: Callable  # the "auto" predictor
    plain: Callable  # the same tables through the plain versions
    backend: str
    launches: Dict[str, int]  # kernel launches of the one main-path predict


def drive(size: str, dev, batch: int) -> PathRun:
    """plant rf-EB of ``size``; predict ``batch`` flows through ``auto``."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.kernels import ops

    ds = load_dataset("unsw", n=6000)
    res = plant(PlanterConfig(model="rf", strategy="eb", size=size,
                              device=str(dev)),
                ds.X_train, ds.y_train, ds.X_test)
    rng = np.random.default_rng(SEED)
    flows = ds.X_test[rng.integers(0, len(ds.X_test), batch)]
    x = torch.as_tensor(flows.astype(np.int32), device=dev)
    backend = res.mapped.select_backend(dev)
    fn = res.mapped.torch_predict("auto", device=dev)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    labels = fn(x)
    torch.cuda.synchronize(dev)
    counts = ops.launch_counts()
    plain = res.mapped.torch_predict("ref", device=dev)
    want = torch.cat([plain(x[i:i + CHUNK]) for i in range(0, batch, CHUNK)])
    same(f"rf-{size} {backend} labels", labels, want)
    head = flows[:CHUNK]
    got = labels[:CHUNK].cpu().numpy()
    if not np.array_equal(got, res.mapped.predict(head)):
        fail(f"rf-{size}: labels differ from the numpy reference")
    if not np.array_equal(got, res.trained.predict(head)):
        fail(f"rf-{size}: labels differ from the native forest")
    return PathRun(res, x, fn, plain, backend, counts)


def chunked(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over ``x`` in CHUNK-row pieces (the plain versions' memory)."""
    return torch.cat([fn(x[i:i + CHUNK]) for i in range(0, x.shape[0], CHUNK)])


def flows(ds, dev, batch: int):
    """``batch`` flows drawn from the test split with ``default_rng(SEED)``:
    (numpy int64, int32 on ``dev``)."""
    rng = np.random.default_rng(SEED)
    f = ds.X_test[rng.integers(0, len(ds.X_test), batch)]
    return f, torch.as_tensor(f.astype(np.int32), device=dev)


def drive_lb(dev, batch: int) -> Dict[str, PathRun]:
    """plant each LB model at size L; predict ``batch`` flows through
    ``auto`` with the launch counts set to 0 just before and read after."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.kernels import ops, ref

    ds = load_dataset("unsw", n=6000)
    head, x = flows(ds, dev, batch)
    head = head[:CHUNK]
    runs = {}
    for model in LB_MODELS:
        y = None if model in ("kmeans", "pca", "ae") else ds.y_train
        res = plant(PlanterConfig(model=model, strategy="lb", size="L",
                                  device=str(dev)), ds.X_train, y, ds.X_test)
        backend = res.mapped.select_backend(dev)
        fn = res.mapped.torch_predict("auto", device=dev)
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        out = fn(x)
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        if counts["lb_lookup"] != 1 or sum(counts.values()) != 1:
            fail(f"{model}-LB predict launched {counts}, want one lb_lookup")
        plain = res.mapped.torch_predict("ref", device=dev)
        want = chunked(plain, x)
        lb = res.mapped.predict_np.__self__
        if lb.mode == "raw":
            # the int32 sums bitwise, then the dequantized float32 outputs
            luts = torch.as_tensor(np.ascontiguousarray(lb.luts), device=dev)
            codes = x.clamp(0, lb.luts.shape[1] - 1)
            same(f"{model}-LB sums", ops.lb_lookup(codes, luts),
                 chunked(lambda c: ref.lb_lookup_ref(c, luts), codes))
            if out.dtype != torch.float32 or not torch.allclose(
                    out, want, rtol=1e-5, atol=1e-5):
                fail(f"{model}-LB outputs differ from the plain path")
            if not np.allclose(out[:CHUNK].cpu().numpy(),
                               res.mapped.predict(head), rtol=1e-5, atol=1e-5):
                fail(f"{model}-LB outputs differ from the numpy reference")
        else:
            same(f"{model}-LB labels", out, want)
            if not np.array_equal(out[:CHUNK].cpu().numpy(),
                                  res.mapped.predict(head)):
                fail(f"{model}-LB labels differ from the numpy reference")
        runs[model] = PathRun(res, x, fn, plain, backend, counts)
    return runs


def drive_dm(dev, batch: int) -> Dict[str, PathRun]:
    """bnn-DM size L through ``auto`` (two ``bnn_popcount_matmul``
    launches), and dt/rf-DM size L through their plain-torch walk."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.kernels import ops

    ds = load_dataset("unsw", n=6000)
    head, x = flows(ds, dev, batch)
    head = head[:CHUNK]
    runs = {}
    for model in ("bnn", "dt", "rf"):
        res = plant(PlanterConfig(model=model, strategy="dm", size="L",
                                  device=str(dev)),
                    ds.X_train, ds.y_train, ds.X_test)
        backend = res.mapped.select_backend(dev)
        fn = res.mapped.torch_predict("auto", device=dev)
        torch.cuda.synchronize(dev)
        ops.reset_launch_counts()
        labels = fn(x)
        torch.cuda.synchronize(dev)
        counts = ops.launch_counts()
        kernel = 2 if model == "bnn" else 0
        if (counts["bnn_popcount_matmul"] != kernel
                or sum(counts.values()) != kernel):
            fail(f"{model}-DM predict launched {counts}, want {kernel} "
                 "bnn_popcount_matmul")
        plain = res.mapped.torch_predict("ref", device=dev)
        if model == "bnn":
            same("bnn-DM labels", labels, chunked(plain, x))
        got = labels[:CHUNK].cpu().numpy()
        if not np.array_equal(got, res.mapped.predict(head)):
            fail(f"{model}-DM labels differ from the numpy reference")
        if not np.array_equal(got, res.trained.predict(head)):
            fail(f"{model}-DM labels differ from the native model")
        runs[model] = PathRun(res, x, fn, plain, backend, counts)
    return runs


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, spins: bool = False):
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler (CUPTI): the card's own time, without the host's launch
    overhead that a single call's CUDA events also span while the card
    idles.  With ``spins`` the window opens with ``open_window``'s spin
    kernels, not counted, which absorb the records the profiler drops at
    a window's start.  None when the profiler saw no kernel in three
    windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if spins:
                open_window(torch.device("cuda"))
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation and "spin_kernel" not in e.key)
        if us > 0:
            return us / reps / 1e3
    return None


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_rows(staged, fused, dev):
    """Time each kernel at its main-path shapes (largest table)."""
    from repro_torch.core.tables import key_layout
    from repro_torch.kernels import ops, ref

    rows = []
    for name, run in (("bucketize", staged), ("ternary_match", staged),
                      ("fused_eb", fused)):
        x = run.x
        ens = run.res.mapped.predict_np.__self__
        thr, tbls = ens.device_tables(dev)
        rv, rm, pa, d = max(tbls, key=lambda t: t[0].shape[0])
        layout = key_layout(ens.widths)
        B, F = x.shape
        T = thr.shape[1]
        N, W = rv.shape
        library_ms = library_device_ms = None
        if name == "bucketize":
            args = (x, thr)
            kern, plain = ops.bucketize, ref.bucketize_ref
            n_bytes, n_ops = 2 * B * F * 4 + F * T * 4, B * F * T
            vt = x.T.contiguous()
            library_ms = time_ms(lambda: torch.searchsorted(thr, vt, right=True))
            library_device_ms = device_ms(
                lambda: torch.searchsorted(thr, vt, right=True))
        elif name == "ternary_match":
            keys = ref.pack_codes_ref(ref.bucketize_ref(x, thr), layout, W)
            args = (keys, rv, rm, pa, d)
            kern, plain = ops.ternary_match, ref.ternary_match_ref
            n_bytes = B * W * 4 + N * (2 * W + 1) * 4 + B * 4
            n_ops = B * N * (2 * W + 2)
        else:
            lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
            args = (x, thr, rv, rm, pa, lay, d)
            kern, plain = ops.fused_eb_match, ref.fused_eb_ref
            n_bytes = B * F * 4 + F * T * 4 + N * (2 * W + 1) * 4 + B * 4
            n_ops = B * F * T + B * N * (2 * W + 2)
        got, want = kern(*args), plain(*args)
        same(f"{name} at main-path shapes", got, want)
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": run.launches[name],
            "bitwise": True, "max_abs_err": err,
            "ms": time_ms(lambda: kern(*args)),
            "device_ms": device_ms(lambda: kern(*args)),
            "plain_ms": time_ms(lambda: plain(*args), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "shape": {"B": B, "F": F, "T": T, "N": N, "W": W},
        })
    return rows


def lb_dm_kernel_rows(lb_runs, dm_runs, dev):
    """Time ``lb_lookup`` on kmeans-LB L (the widest K) and
    ``bnn_popcount_matmul`` on BNN-L layer 1, at 2^20 flows."""
    from repro_torch.kernels import ops, ref

    rows = []
    run = lb_runs["kmeans"]
    lb = run.res.mapped.predict_np.__self__
    luts = torch.as_tensor(np.ascontiguousarray(lb.luts), device=dev)
    F, V, K = luts.shape
    codes = run.x.clamp(0, V - 1)
    B = codes.shape[0]
    offsets = torch.arange(F, device=dev) * V
    bag = (codes.long() + offsets).contiguous()
    weight = luts.reshape(F * V, K).float()
    rows.append(dict(
        name="lb_lookup", args=(codes, luts), kern=ops.lb_lookup,
        plain=ref.lb_lookup_ref, run=run, source=LB_DM_SOURCE,
        n_bytes=B * F * 4 + F * V * K * 4 + B * K * 4, n_ops=B * F * K,
        library=lambda: torch.nn.functional.embedding_bag(bag, weight,
                                                          mode="sum"),
        shape={"B": B, "F": F, "V": V, "K": K, "mode": "sums"}))
    # the predict's own launch: raw features in, the argmin label out
    fused_args = lb_fused_args(lb, run.x, dev)
    rows.append(dict(
        name="lb_lookup", args=fused_args, kern=ops.lb_lookup,
        plain=ref.lb_lookup_ref, run=run, source=LB_DM_SOURCE,
        n_bytes=B * F * 4 + F * V * K * 4 + K * 4 + B * 4,
        n_ops=B * K * (F + 2) + 2 * B * F, library=None,
        shape={"B": B, "F": F, "V": V, "K": K, "mode": f"{lb.mode} (fused)"}))

    run = dm_runs["bnn"]
    bnn = run.res.mapped.predict_np.__self__
    (w, n_in), (w2, n_in2) = bnn_layers(bnn, dev)
    shifts = torch.arange(bnn.in_bits, dtype=torch.int32, device=dev)
    bits = ((run.x[..., None] >> shifts) & 1).reshape(B, -1)
    x = ops.pack_bits(bits)
    N, W = w.shape
    N2, W2 = w2.shape
    F = run.x.shape[1]
    x_pm = (bits * 2 - 1).to(torch.bfloat16)
    w_pm = torch.as_tensor(run.res.trained.binary_weights()[0].T,
                           dtype=torch.bfloat16, device=dev).contiguous()
    rows.append(dict(
        name="bnn_popcount_matmul", args=(x, w), kern=ops.bnn_popcount_matmul,
        plain=ref.bnn_popcount_matmul_ref, run=run, source=LB_DM_SOURCE,
        n_bytes=B * W * 4 + N * W * 4 + B * N * 4, n_ops=B * N * W * 4,
        library=lambda: torch.matmul(x_pm, w_pm.T),
        shape={"B": B, "W": W, "N": N, "n_in": n_in, "mode": "counts"}))
    # the predict's own launches: layer 1 builds its input words from the
    # features and packs its signs, layer 2 writes the scores
    h = ops.bnn_popcount_matmul(run.x, w, bnn.in_bits, "sign", n_in)
    fused = [
        dict(layer=1, args=(run.x, w, bnn.in_bits, "sign", n_in),
             n_bytes=B * F * 4 + N * W * 4 + B * -(-N // 32) * 4,
             n_ops=B * N * W * 4,
             shape={"B": B, "F": F, "in_bits": bnn.in_bits, "W": W, "N": N,
                    "mode": "features -> sign words"}),
        dict(layer=2, args=(h, w2, 0, "score", n_in2),
             n_bytes=B * W2 * 4 + N2 * W2 * 4 + B * N2 * 4,
             n_ops=B * N2 * W2 * 4,
             shape={"B": B, "W": W2, "N": N2, "mode": "packed -> scores"})]

    out = []
    for r in rows:
        kern, plain, args = r["kern"], r["plain"], r["args"]
        got = kern(*args)
        want = chunked(lambda a: plain(a, *args[1:]), args[0])
        same(f"{r['name']} at main-path shapes", got, want)
        err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
        b_ms, b_by = bound_ms(r["n_bytes"], r["n_ops"])
        out.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": REPLACES[r["name"]],
            "launches": r["run"].launches[r["name"]],
            "bitwise": True, "max_abs_err": err,
            "ms": time_ms(lambda: kern(*args)),
            "device_ms": device_ms(lambda: kern(*args)),
            "plain_ms": time_ms(lambda: plain(*args), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(r["library"]) if r["library"] else None,
            "library_device_ms": device_ms(r["library"]) if r["library"]
            else None, "shape": r["shape"], "n_bytes": r["n_bytes"],
            "n_ops": r["n_ops"],
        })
    out[-1]["fused"] = [fused_layer_row(f) for f in fused]
    return out


def bnn_layers(bnn, dev):
    """The DM-BNN's packed layers on ``dev``: [(w [N, W] int32, n_in)]."""
    return [(torch.as_tensor(np.ascontiguousarray(w).view(np.int32),
                             device=dev), int(n_in))
            for w, n_in in bnn.packed.layers]


def fused_layer_row(f) -> Dict[str, Any]:
    """One fused bnn_popcount_matmul launch of the predict against its
    plain version, bitwise, and timed beside its bound."""
    from repro_torch.kernels import ops, ref

    args = f["args"]
    got = ops.bnn_popcount_matmul(*args)
    want = chunked(lambda a: ref.bnn_popcount_matmul_ref(a, *args[1:]),
                   args[0])
    same(f"bnn_popcount_matmul layer {f['layer']} ({f['shape']['mode']})",
         got, want)
    b_ms, b_by = bound_ms(f["n_bytes"], f["n_ops"])
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    return {"layer": f["layer"], "max_abs_err": err,
            "ms": time_ms(lambda: ops.bnn_popcount_matmul(*args)),
            "device_ms": device_ms(lambda: ops.bnn_popcount_matmul(*args)),
            "plain_ms": time_ms(lambda: ref.bnn_popcount_matmul_ref(*args),
                                reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "shape": f["shape"]}


def lb_fused_args(lb, x, dev):
    """The arguments of the LB predict's one ``lb_lookup`` launch: the raw
    features, then the model's luts, mode, bias, pairs, classes and scale
    on ``dev``."""
    return (x, *lb.kernel_args(dev))


def device_kernels(fn, calls: int = 5, tries: int = 3):
    """{kernel name: launches} on the card over ``calls`` calls of ``fn``
    (torch.profiler), asked up to ``tries`` times while the profiler sees
    no kernel; empty when it never does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation}
        if seen:
            return seen
    return {}


def check_lb_one_kernel(model: str, run: PathRun, calls: int = 5) -> str:
    """An LB predict on an int32 input on the card runs exactly one device
    kernel, the lb_lookup kernel (profiler; ``calls`` predicts)."""
    seen = device_kernels(lambda: run.fn(run.x), calls)
    if not seen:
        return "device kernels not measured (the profiler saw none)"
    if (len(seen) != 1 or "lb_lookup_kernel" not in next(iter(seen))
            or next(iter(seen.values())) != calls):
        fail(f"{model}-LB predict ran {seen} on the card over {calls} calls, "
             "want one lb_lookup kernel a call")
    name, count = next(iter(seen.items()))
    return f"one device kernel a predict ({count} in {calls}: {name[:60]})"


def lb_dm_kernels_only(run: PathRun, dev) -> Callable:
    """The LB / DM-BNN predict's kernel launches alone, on the inputs that
    predict gives them (the LB predict's one fused launch on the raw
    features; the features into layer 1, which packs its signs, and those
    words into the last layer's scores)."""
    from repro_torch.kernels import ops

    model = run.res.mapped.predict_np.__self__
    if run.res.mapped.strategy == "lb":
        args = lb_fused_args(model, run.x, dev)
        return lambda: ops.lb_lookup(*args)
    args, h = [], run.x
    layers = bnn_layers(model, dev)
    for i, (w, n_in) in enumerate(layers):
        last = i == len(layers) - 1
        args.append((h, w, model.in_bits if i == 0 else 0,
                     "score" if last else "sign", n_in))
        h = ops.bnn_popcount_matmul(*args[-1])
    return lambda: [ops.bnn_popcount_matmul(*a) for a in args]


def flows_per_s(fn, x) -> float:
    for _ in range(2):
        fn(x)
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return x.shape[0] / statistics.median(runs)


def kernels_only(run: PathRun, dev) -> Callable:
    """The path's kernel launches for one predict, without the plain-torch
    packing, stacking and combine around them (same inputs)."""
    from repro_torch.core.tables import key_layout
    from repro_torch.kernels import ops, ref

    ens = run.res.mapped.predict_np.__self__
    thr, tbls = ens.device_tables(dev)
    layout = key_layout(ens.widths)
    if run.backend == "cuda_fused":
        lay = torch.as_tensor(layout, dtype=torch.int32, device=dev)
        return lambda: [ops.fused_eb_match(run.x, thr, v, m, pa, lay, d)
                        for v, m, pa, d in tbls]
    n_words = tbls[0][0].shape[1]
    keys = ref.pack_codes_ref(ref.bucketize_ref(run.x, thr), layout, n_words)
    return lambda: [ops.bucketize(run.x, thr)] + [
        ops.ternary_match(keys, v, m, pa, d) for v, m, pa, d in tbls]


# ------------------------------------------------- phase 8: paged_attention
def pa_case(rng, dev, B, C, H, KV, hd, page, n_ps, quantized, past=True):
    """q, pools (bf16, or int8 with float32 scales), a shuffled block table
    (with entries past the pool when ``past``) and positions, on ``dev``."""
    N = B * n_ps
    q = torch.as_tensor(rng.normal(0, 1, (B, C, H, hd)), dtype=torch.bfloat16,
                        device=dev)
    tbl = rng.permutation(N).reshape(B, n_ps).astype(np.int32)
    if past:
        tbl[0, -1] = N + 3
        tbl[-1, 0] = N
    pos0 = rng.integers(0, n_ps * page - C + 1, B)
    pos = (pos0[:, None] + np.arange(C)[None]).astype(np.int32)
    shape = (N, page, KV, hd)
    if quantized:
        pools = [torch.as_tensor(rng.integers(-127, 128, shape),
                                 dtype=torch.int8, device=dev)
                 for _ in range(2)]
        scales = [torch.as_tensor(rng.uniform(0.005, 0.02, shape[:-1] + (1,)),
                                  dtype=torch.float32, device=dev)
                  for _ in range(2)]
    else:
        pools = [torch.as_tensor(rng.normal(0, 1, shape),
                                 dtype=torch.bfloat16, device=dev)
                 for _ in range(2)]
        scales = [None, None]
    return (q, pools[0], pools[1], torch.as_tensor(tbl, device=dev),
            torch.as_tensor(pos, device=dev), scales[0], scales[1])


def bf16_ulp(want: torch.Tensor) -> float:
    """One bf16 ulp of ``want``'s largest magnitude: the kernel's limit
    against its plain version (both round to bf16 at the same places
    after float32 sums taken in other orders)."""
    m = want.float().abs().max().item()
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def pa_err_ulps(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bf16 ulps of max |want|; fail past one."""
    err = (got.float() - want.float()).abs().max().item()
    ulp = bf16_ulp(want)
    if not torch.isfinite(got).all() or not err <= ulp:
        fail(f"{name}: kernel differs from its plain version by {err} > one "
             f"bf16 ulp ({ulp})")
    return err / ulp if ulp else 0.0


def check_paged_attention(dev) -> str:
    """Kernel vs plain over the case grid, then the four invariances."""
    from test_torch_cuda import _overwrite_past as overwrite_past

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(7)
    n, worst = 0, 0.0
    for C in (1, 8):
        for page, n_ps in ((16, 6), (8, 12)):
            for H, KV in ((12, 2), (4, 4)):
                for quantized in (False, True):
                    for window in (0, 13):
                        args = pa_case(rng, dev, 3, C, H, KV, 128, page, n_ps,
                                       quantized)
                        q, k, v, tbl, pos, ks, vs = args
                        worst = max(worst, pa_err_ulps(
                            f"paged_attention C={C} page={page} H={H} KV={KV} "
                            f"int8={quantized} window={window}",
                            ops.paged_attention(q, k, v, tbl, pos, window, ks,
                                                vs),
                            ref.paged_attention_ref(q, k, v, tbl, pos, window,
                                                    ks, vs)))
                        n += 1
    # a row at position -1 sees no key: the oracle's full-axis softmax
    for C in (1, 8):
        q, k, v, tbl, pos, ks, vs = pa_case(rng, dev, 3, C, 12, 2, 128, 16, 6,
                                            False)
        pos[0] = torch.arange(-1, C - 1, dtype=torch.int32, device=dev)
        worst = max(worst, pa_err_ulps(
            f"paged_attention C={C} with a row at position -1",
            ops.paged_attention(q, k, v, tbl, pos, 13),
            ref.paged_attention_ref(q, k, v, tbl, pos, 13)))
        n += 1
    # the invariances, bitwise, at the serve decode shape
    B, H, KV, hd, page, n_ps = 16, 12, 2, 128, 16, 64
    q, k, v, tbl, pos, _, _ = pa_case(rng, dev, B, 1, H, KV, hd, page, n_ps,
                                      False)
    full = ops.paged_attention(q, k, v, tbl, pos, 0)
    for b in (0, 7, 15):  # a slot alone vs in the batch of 16
        alone = ops.paged_attention(q[b:b + 1].contiguous(), k, v,
                                    tbl[b:b + 1].contiguous(),
                                    pos[b:b + 1].contiguous(), 0)
        same(f"paged_attention slot {b} alone vs in a batch of {B}",
             alone[0], full[b])
    q8, k8, v8, tbl8, pos8, _, _ = pa_case(rng, dev, 4, 8, H, KV, hd, page,
                                           n_ps, False)
    chunk = ops.paged_attention(q8, k8, v8, tbl8, pos8, 13)
    for c in range(8):  # a chunk of 8 vs eight C = 1 calls, same pool
        one = ops.paged_attention(q8[:, c:c + 1].contiguous(), k8, v8, tbl8,
                                  pos8[:, c:c + 1].contiguous(), 13)
        same(f"paged_attention chunk row {c} vs C = 1", one[:, 0],
             chunk[:, c])
    perm = torch.as_tensor(rng.permutation(k.shape[0]), device=dev)
    k2, v2 = torch.empty_like(k), torch.empty_like(v)
    k2[perm], v2[perm] = k, v  # physical page p moves to perm[p]
    tbl2 = perm[tbl.clamp(0, k.shape[0] - 1).long()].to(torch.int32)
    same("paged_attention under permuted physical pages",
         ops.paged_attention(q, k2, v2, tbl2, pos, 0), full)
    # rows past each slot's position are never read: other values there
    # change nothing (decode; the chunk with a window; int8 pools)
    k3, v3 = overwrite_past(1, tbl, pos, k, v)
    same("paged_attention with the rows past each position overwritten",
         ops.paged_attention(q, k3, v3, tbl, pos, 0), full)
    k3, v3 = overwrite_past(2, tbl8, pos8, k8, v8)
    same("paged_attention chunk with the rows past each position "
         "overwritten", ops.paged_attention(q8, k3, v3, tbl8, pos8, 13),
         chunk)
    qi, ki, vi, tbli, posi, ksi, vsi = pa_case(rng, dev, 4, 8, H, KV, hd,
                                               page, n_ps, True)
    want = ops.paged_attention(qi, ki, vi, tbli, posi, 0, ksi, vsi)
    pools = overwrite_past(3, tbli, posi, ki, vi, ksi, vsi)
    same("paged_attention int8 with the rows past each position "
         "overwritten", ops.paged_attention(qi, *pools[:2], tbli, posi, 0,
                                            *pools[2:]), want)
    torch.cuda.synchronize(dev)
    return (f"{n} grid cases (2 with a row at position -1) within one bf16 "
            f"ulp of the output's largest magnitude (worst {worst:.2f} ulp); "
            f"rows bitwise invariant to B (3 slots alone vs in a batch of "
            f"{B}), C (8 rows vs C = 1), the physical page order, and the "
            f"rows past each position (3 cases)")


PA_VISIBLE = 256  # positions each slot sees in the second timing


def paged_attention_row(dev):
    """Time the kernel at the serve decode shape (16 slots, 64 pages of
    16, bf16 pools) twice: every slot at the end of its table, so every K
    and V row is weighed (where skipping cannot help); and every slot at
    position PA_VISIBLE - 1 (the serve cell's range), where the kernel
    reads a quarter of the rows.  Each beside its plain version and a
    gather + ``F.scaled_dot_product_attention`` yardstick (at the second,
    of the pages up to the position)."""
    B, C, H, KV, hd, page, n_ps = 16, 1, 12, 2, 128, 16, 64
    S = n_ps * page
    rng = np.random.default_rng(SEED)
    q, k, v, tbl, _, _, _ = pa_case(rng, dev, B, C, H, KV, hd, page, n_ps,
                                    False, past=False)
    full = pa_timing(q, k, v, tbl, S, dev)
    row = {"name": "paged_attention", "route": "cuda", "source": PA_SOURCE,
           "replaces": REPLACES["paged_attention"], "launches": None,
           "bitwise": False, **full}
    row["skip"] = pa_timing(q, k, v, tbl, PA_VISIBLE, dev)
    return row


def pa_timing(q, k, v, tbl, visible: int, dev) -> Dict[str, Any]:
    """The kernel, its plain version and gather + SDPA with every slot at
    position ``visible - 1``, timed; the bound from the rows it must read."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.paged_attention import paged_attention_hbm_bytes
    from repro_torch.nn.attn_backend import position_mask, repeat_kv

    B, C, H, hd = q.shape
    N, page, KV, _ = k.shape
    n_ps = tbl.shape[1]
    pos = torch.full((B, C), visible - 1, dtype=torch.int32, device=dev)
    args = (q, k, v, tbl, pos, 0)
    got, want = ops.paged_attention(*args), ref.paged_attention_ref(*args)
    pa_err_ulps(f"paged_attention at the serve decode shape, {visible} "
                f"positions visible", got, want)
    err = (got.float() - want.float()).abs().max().item()
    n_pg = -(-visible // page)  # the pages up to the position
    gtbl = tbl[:, :n_pg].long()
    S_lib = n_pg * page

    def library():
        kf = repeat_kv(k[gtbl].reshape(B, S_lib, KV, hd), H).transpose(1, 2)
        vf = repeat_kv(v[gtbl].reshape(B, S_lib, KV, hd), H).transpose(1, 2)
        mask = position_mask(pos, torch.arange(S_lib, device=dev)[None], 0,
                             True)[:, None].to(q.dtype)
        return F.scaled_dot_product_attention(q.transpose(1, 2), kf, vf,
                                              attn_mask=mask).transpose(1, 2)

    n_bytes = paged_attention_hbm_bytes(
        B, C, H, KV, hd, n_ps, page, pool_bytes=k.element_size(),
        quantized=False, act_bytes=q.element_size(),
        positions=pos.cpu().numpy(), window=0)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = 4 * B * C * H * hd * visible / PEAK_BF16_FLOPS * 1e3  # qk, PV
    return {
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.paged_attention(*args)),
        "device_ms": device_ms(lambda: ops.paged_attention(*args)),
        "plain_ms": time_ms(lambda: ref.paged_attention_ref(*args)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": time_ms(library),
        "library_device_ms": device_ms(library),
        "library_max_abs_err": (library().float() - want.float()).abs().max()
        .item(),
        "shape": {"B": B, "C": C, "H": H, "KV": KV, "hd": hd, "page": page,
                  "n_ps": n_ps, "visible": visible, "bytes": n_bytes},
    }


# --------------------------------------------------- phase 8: linear
LINEAR_ROWS = (1, 16, 48, 64, 128, 256)  # M of the row-invariance grid
LINEAR_TIMED = (16, 128)  # M of the timings: C = 1 and C = 8 at 16 slots


def linear_weights(cfg):
    """The eight weight shapes of a qwen2-1.5b step, (name, K, N, float32
    out): seven products a layer and the head."""
    D, hd = cfg.d_model, cfg.head_dim_
    return [("wq", D, cfg.q_heads * hd, False),
            ("wk", D, cfg.n_kv_heads * hd, False),
            ("wv", D, cfg.n_kv_heads * hd, False),
            ("wo", cfg.q_heads * hd, D, False),
            ("w_gate", D, cfg.d_ff, False), ("w_up", D, cfg.d_ff, False),
            ("w_down", cfg.d_ff, D, False),
            ("head", D, cfg.vocab_padded, True)]


def linear_case(dev, M, K, N, seed):
    """bf16 x [M, K] ~ N(0, 1), w [K, N] ~ N(0, 1/K) on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=dev) / np.sqrt(K)).to(
        torch.bfloat16)
    return x, w


def check_linear(cfg, dev) -> str:
    """(a) every row of each of the step's eight products bitwise equal to
    the same row in another row count, at another position and alone, for
    M in LINEAR_ROWS; (b) within ``linear_limit`` (fixed before any run:
    2 K 2^-24 sum|x||w| for two float32 summation orders, plus one bf16 ulp
    of the output) of the plain version at the timed M."""
    from test_torch_cuda import linear_limit

    from repro_torch.kernels import ops, ref

    n_rows = n_cmp = 0
    for i, (name, K, N, f32) in enumerate(linear_weights(cfg)):
        out = torch.float32 if f32 else None
        X, w = linear_case(dev, max(LINEAR_ROWS) + 7, K, N, SEED + i)
        for M in LINEAR_ROWS:
            a = ops.linear(X[:M], w, out)
            b = ops.linear(X[7:7 + M].contiguous(), w, out)
            if not torch.equal(a[7:], b[: M - 7]):
                fail(f"(8 linear) {name}: rows differ between [{M}, {K}] "
                     f"operands at offsets 0 and 7")
            for r in sorted({0, M // 2, M - 1}):
                alone = ops.linear(X[r:r + 1].contiguous(), w, out)
                if not torch.equal(alone[0], a[r]):
                    fail(f"(8 linear) {name}: row {r} alone differs from "
                         f"row {r} of a [{M}, {K}] operand")
                n_cmp += 1
            n_rows += M
        for M in LINEAR_TIMED:
            x = X[:M].contiguous()
            got, want = ops.linear(x, w, out), ref.linear_ref(x, w, out)
            bad = (got.float() - want.float()).abs() > linear_limit(
                x, w, want, f32)
            if bad.any():
                fail(f"(8 linear) {name} at M = {M}: {int(bad.sum())} "
                     f"elements past the limit of the plain version")
    return (f"(a) the 8 weight shapes x M in {LINEAR_ROWS}: {n_rows} rows "
            f"bitwise equal at offsets 0 and 7, {n_cmp} rows bitwise equal "
            f"computed alone; (b) within the limit of the plain version at "
            f"M in {LINEAR_TIMED}")


def linear_groups(cfg):
    """The step's grouped launches: (name, member names) of
    ``linear_weights``."""
    return [("qkv", ("wq", "wk", "wv")), ("gate_up", ("w_gate", "w_up"))]


def check_linear_groups(cfg, dev) -> str:
    """Each member of the step's two grouped launches bitwise its lone
    launch, for M in LINEAR_ROWS; a group is one launch."""
    from repro_torch.kernels import ops

    shapes = {name: (K, N) for name, K, N, _ in linear_weights(cfg)}
    n = 0
    for gname, members in linear_groups(cfg):
        K = shapes[members[0]][0]
        X, _ = linear_case(dev, max(LINEAR_ROWS), K, 8, SEED + 100)
        ws = [linear_case(dev, 1, K, shapes[m][1], SEED + 101 + i)[1]
              for i, m in enumerate(members)]
        for M in LINEAR_ROWS:
            x = X[:M].contiguous()
            before = ops.launch_counts()["linear"]
            got = ops.linear_group(x, ws)
            if ops.launch_counts()["linear"] != before + 1:
                fail(f"(8 linear) the {gname} group made more than one "
                     f"launch")
            for m, g, w in zip(members, got, ws):
                if not torch.equal(g, ops.linear(x, w)):
                    fail(f"(8 linear) {gname} at M = {M}: {m} differs from "
                         f"its lone launch")
                n += 1
    return (f"(c) the groups {[g for g, _ in linear_groups(cfg)]} at M in "
            f"{LINEAR_ROWS}: {n} members bitwise their lone launches, one "
            f"launch a group")


# a timing rotates over copies of its weights that together pass this many
# bytes, so every call finds them out of the 50 MB L2, as a serve step does
COLD_BYTES = 120e6


def rotating(copies, call):
    """A callable that runs ``call(copy)`` over ``copies`` in turn."""
    state = {"i": 0}

    def fn():
        i = state["i"]
        state["i"] = (i + 1) % len(copies)
        return call(copies[i])

    return fn


def linear_timings(cfg, dev):
    """Each of the eight products and the two groups at M in LINEAR_TIMED,
    L2-cold (rotating over copies of the weights past COLD_BYTES): the
    kernel's events and device time, cuBLAS's (``x @ w``, or the head's
    ``torch.mm(out_dtype=float32)``; a group's members one after another),
    the plain version's, the error against it and the byte bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.linear import linear_hbm_bytes

    shapes = {name: (K, N, f32) for name, K, N, f32 in linear_weights(cfg)}
    units = [(name, (name,)) for name in shapes] + linear_groups(cfg)
    per = []
    for i, (name, members) in enumerate(units):
        f32 = shapes[members[0]][2]
        out = torch.float32 if f32 else None
        K = shapes[members[0]][0]
        ws = [linear_case(dev, 1, K, shapes[m][1], SEED + 10 * i + j)[1]
              for j, m in enumerate(members)]
        w_bytes = sum(w.numel() * 2 for w in ws)
        copies = [ws] + [[w.clone() for w in ws]
                         for _ in range(int(np.ceil(COLD_BYTES / w_bytes))
                                        - 1)]
        X, _ = linear_case(dev, max(LINEAR_TIMED), K, 8, SEED + 10 * i + 9)
        for M in LINEAR_TIMED:
            x = X[:M].contiguous()
            if len(ws) == 1:
                kernel = rotating(copies, lambda c: ops.linear(x, c[0], out))
            else:
                kernel = rotating(copies, lambda c: ops.linear_group(x, c))
            lib = linear_library(x, f32)
            library = lib and rotating(copies,
                                       lambda c: [lib(w) for w in c])
            got = ops.linear_group(x, ws, out)
            err = max((g.float() - ref.linear_ref(x, w, out).float())
                      .abs().max().item() for g, w in zip(got, ws))
            n_bytes = 2 * M * K + sum(
                linear_hbm_bytes(M, K, w.shape[1], 4 if f32 else 2)
                - 2 * M * K for w in ws)
            flops = sum(2 * M * K * w.shape[1] for w in ws)
            t_bytes = n_bytes / PEAK_BYTES * 1e3
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            per.append({
                "weight": name, "members": list(members), "M": M, "K": K,
                "N": [w.shape[1] for w in ws], "max_abs_err": err,
                "copies": len(copies),
                "ms": time_ms(kernel),
                "device_ms": device_ms(kernel, spins=True),
                "plain_ms": time_ms(
                    lambda: [ref.linear_ref(x, w, out) for w in ws],
                    reps=5, warmup=1),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": time_ms(library) if library else None,
                "library_device_ms": (device_ms(library, spins=True)
                                      if library else None)})
        del copies, ws
        torch.cuda.empty_cache()
    return per


def linear_library(x, f32):
    """``w -> `` one PyTorch call computing the same product (cuBLAS):
    ``x @ w``, or for the float32 head ``torch.mm`` with ``out_dtype``
    where this PyTorch has it (else None)."""
    if not f32:
        return lambda w: x @ w
    try:
        torch.mm(x[:1], x[:1].T, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return None
    return lambda w: torch.mm(x, w, out_dtype=torch.float32)


def linear_step(cfg, per, m_layer: int, m_head: int, key: str):
    """``key`` summed over one step's launches: per layer the q/k/v group,
    wo, the gate/up group and w_down at ``m_layer`` rows, and the head at
    ``m_head``; for cuBLAS (``library*``) the seven products alone.  None
    when a term is missing."""
    by = {(r["weight"], r["M"]): r[key] for r in per}
    lone = key.startswith("library")
    names = (("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down") if lone
             else ("qkv", "wo", "gate_up", "w_down"))
    vals = [by[(n, m_layer)] for n in names] * cfg.n_layers
    vals.append(by[("head", m_head)])
    return None if None in vals else sum(vals)


def linear_step_row(cfg, per, launches: int) -> Dict[str, Any]:
    """The JSON row: one device-batcher step's products at C = DEVICE_CHUNK
    (each layer's four launches at M = 16 x DEVICE_CHUNK, the head at
    M = 16), summed from ``per``; ``c1`` the same at C = 1 (M = 16
    throughout, the host batcher's step)."""
    B = SERVE["max_batch"]
    m8 = B * DEVICE_CHUNK
    row = {"name": "linear", "route": "cuda", "source": LINEAR_SOURCE,
           "replaces": REPLACES["linear"], "launches": launches,
           "bitwise": False,
           "max_abs_err": max(r["max_abs_err"] for r in per),
           "bound_by": "bytes",
           "shape": {"step": f"{cfg.n_layers} x (q/k/v group, wo, gate/up "
                             f"group, w_down) at M = {m8}, the head at "
                             f"M = {B}; L2-cold"},
           "per_product": per}
    for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms"):
        row[key] = linear_step(cfg, per, m8, B, key)
    row["c1"] = {key: linear_step(cfg, per, B, B, key)
                 for key in ("device_ms", "bound_ms", "library_device_ms")}
    return row


# ------------------------------------------------------ phases 9 and 10
SERVE = dict(max_batch=16, cache_len=1024, page_size=16)
SERVE_REQUESTS, SERVE_TOKENS = 32, 32
PROMPT_LENS = (16, 256)  # prompt lengths are drawn in this closed range
# the parity contract of phase 10, fixed before any run
CAPTURE_STEPS = (0, 64, 128, 192)  # serve steps whose attention is captured
LOGIT_TOL = 0.03  # delta = LOGIT_TOL * max |plain logits|, per position
MIN_POSITIONS = 512  # teacher-forced generated positions, at least
SHARED_PREFIX = 72  # tokens every prompt of the share_prefix check shares


@dataclasses.dataclass
class ServeRun:
    cfg: Any
    params: Any
    gate: Any
    prompts: list
    feats: np.ndarray
    cb: Any  # the ContinuousBatcher after the run
    seconds: float
    launches: Dict[str, int]


def serve_workload(cfg, params, gate, prompts, feats, dev, attn_impl="auto"):
    """The phase-9 traffic through ServeEngine + ContinuousBatcher:
    (batcher after the run, seconds, kernel launches during it)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    engine = ServeEngine(cfg, params, ServeConfig(**SERVE,
                                                  attn_impl=attn_impl),
                         gate=gate, device=dev)
    cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=SERVE_TOKENS)
    torch.cuda.synchronize(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for rid, (p, f) in enumerate(zip(prompts, feats)):
        cb.submit(rid, p, features=f)
    cb.run(max_steps=20000)
    torch.cuda.synchronize(dev)
    return cb, time.perf_counter() - t0, ops.launch_counts()


def drive_serve(dev, seed: int) -> ServeRun:
    """qwen2-1.5b at full width through ServeEngine + ContinuousBatcher."""
    from repro_torch.arch import model as M
    from repro_torch.configs import get_config
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    cfg = get_config("qwen2-1.5b")
    params = M.init_params(cfg, seed, dev)
    ds = load_dataset("unsw", n=4000)
    gate = plant(PlanterConfig(model="rf", size="S", device=str(dev)),
                 ds.X_train, ds.y_train, ds.X_test).mapped
    if gate.select_backend(dev) != "cuda_fused":
        fail(f"the rf-S gate takes {gate.select_backend(dev)}, not cuda_fused")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                                     SERVE_REQUESTS)]
    feats = ds.X_test[np.arange(SERVE_REQUESTS) % len(ds.X_test)]
    warm = ContinuousBatcher(ServeEngine(cfg, params, ServeConfig(**SERVE),
                                         device=dev),
                             eos_token=-1, max_tokens=4)
    warm.submit("warm-up", prompts[0][:8])
    warm.run(max_steps=100)
    cb, seconds, counts = serve_workload(cfg, params, gate, prompts, feats,
                                         dev)
    return ServeRun(cfg, params, gate, prompts, feats, cb, seconds, counts)


def check_serve(run: ServeRun) -> str:
    cb, cfg = run.cb, run.cfg
    if run.launches["paged_attention"] != cb.steps * cfg.n_layers:
        fail(f"paged_attention launched {run.launches['paged_attention']} "
             f"times in {cb.steps} steps of {cfg.n_layers} layers")
    if run.launches["fused_eb"] < SERVE_REQUESTS:
        fail(f"fused_eb launched {run.launches['fused_eb']} times for "
             f"{SERVE_REQUESTS} admissions")
    if run.launches["linear"] != cb.steps * step_products(cfg):
        fail(f"linear launched {run.launches['linear']} times in {cb.steps} "
             f"steps of {step_products(cfg)} products")
    others = {k: n for k, n in run.launches.items()
              if n and k not in ("paged_attention", "fused_eb", "linear")}
    if others:
        fail(f"the serve path launched other kernels: {others}")
    served, dropped = set(cb.done), set(cb.dropped)
    if served & dropped or len(served) + len(dropped) != SERVE_REQUESTS:
        fail(f"served {len(served)} + dropped {len(dropped)} != "
             f"{SERVE_REQUESTS} requests")
    keep = run.gate.predict(run.feats) != 1
    rejected = {r for r, why in cb.drop_reasons.items() if why == "gate-reject"}
    if rejected != set(np.where(~keep)[0].tolist()):
        fail("gate-reject drops differ from the gate's numpy verdicts")
    if set(cb.drop_reasons.values()) - {"gate-reject", "quarantined"}:
        fail(f"unexpected drops: {cb.drop_reasons}")
    for rid, toks in cb.done.items():
        if len(toks) != SERVE_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"request {rid}: {len(toks)} tokens, or out of vocab")
    n_tok = sum(len(t) for t in cb.done.values())
    return (f"{len(served)} served, {len(dropped)} dropped "
            f"({dict(collections.Counter(cb.drop_reasons.values()))}), "
            f"{n_tok} tokens in {cb.steps} steps, {run.seconds:.3f} s: "
            f"{n_tok / run.seconds:.1f} tokens/s, "
            f"{run.seconds / cb.steps * 1e3:.3f} ms per step; launches "
            f"{ {k: n for k, n in run.launches.items() if n} }")


def step_products(cfg) -> int:
    """``linear`` launches a serve step: 4 a layer (the q/k/v group, wo,
    the gate/up group, w_down) and the head."""
    return 4 * cfg.n_layers + 1


def kernel_class(name: str) -> str:
    """A device kernel's class in a serve step's time."""
    name = name.lower()
    for cls in ("paged_attention", "fused_eb", "linear"):
        if cls in name:
            return cls
    if any(w in name for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                               "matmul")):
        return "matmul"
    return "other"


def profile_serve(run: ServeRun, dev, steps: int = 24) -> str:
    """Where a serve step's time goes, at 16 live slots: ``steps`` host-
    batcher steps timed with the host clock, then ``steps`` more under
    torch.profiler for the device time by kernel; the device's idle share
    is 1 - device time / the unprofiled wall time of a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    engine = ServeEngine(run.cfg, run.params, ServeConfig(**SERVE),
                         device=dev)
    cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=2 * steps + 8)
    for rid in range(SERVE["max_batch"]):
        cb.submit(rid, run.prompts[rid][:16])
    cb.run(max_steps=4)  # every slot live and warm
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    cb.run(max_steps=steps)
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cb.run(max_steps=steps)
        torch.cuda.synchronize(dev)
    by = collections.Counter()
    for evt in prof.key_averages():
        # kernels only: a CPU op (aten::mm) carries its kernels' time too
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        by[kernel_class(evt.key)] += evt.self_device_time_total / 1e3 / steps
    busy = sum(by.values())
    if busy <= 0:
        return "device time not measured (the profiler saw no kernels)"
    return (f"{steps} steps of {SERVE['max_batch']} live slots: "
            f"{wall:.3f} ms per step (host clock, unprofiled); device ms per "
            f"step { {k: round(v, 4) for k, v in by.items()} } (profiler), "
            f"so the device idles {1 - busy / wall:.3f} of the step")


def check_captured_attention(run: ServeRun, dev) -> str:
    """(a) The workload through the plain ``"torch"`` backend; at the
    CAPTURE_STEPS every layer's attention inputs also go through the
    kernel, which must lie within one bf16 ulp of the plain output."""
    from repro_torch.kernels import ops
    from repro_torch.nn import attn_backend as AB

    plain = AB.get("torch")
    calls, worst, n = [0], [0.0], [0]

    def capturing(q, kv, *, n_heads, head_dim, window):
        out = plain(q, kv, n_heads=n_heads, head_dim=head_dim, window=window)
        step, layer = divmod(calls[0], run.cfg.n_layers)
        calls[0] += 1
        if step in CAPTURE_STEPS:
            got = ops.paged_attention(q, kv.k, kv.v, kv.block_tbl, kv.pos,
                                      window, kv.k_scale, kv.v_scale)
            worst[0] = max(worst[0], pa_err_ulps(
                f"captured attention, step {step} layer {layer}", got, out))
            n[0] += 1
        return out

    AB.register("torch-capture", capturing)
    cb, _, _ = serve_workload(run.cfg, run.params, run.gate, run.prompts,
                              run.feats, dev, attn_impl="torch-capture")
    want = len(CAPTURE_STEPS) * run.cfg.n_layers
    if n[0] != want:
        fail(f"captured {n[0]} layer calls, expected {want} (the plain run "
             f"took {cb.steps} steps)")
    agree = [np.mean(np.array(cb.done[r]) == np.array(run.cb.done[r]))
             for r in sorted(set(cb.done) & set(run.cb.done))]
    return (f"(a) plain-backend serve run, {cb.steps} steps: the kernel on "
            f"the captured inputs of all {run.cfg.n_layers} layers at steps "
            f"{CAPTURE_STEPS} ({n[0]} calls) within one bf16 ulp of the "
            f"plain output (worst {worst[0]:.2f} ulp); its served streams "
            f"agree with the kernel run's on {np.mean(agree):.4f} of tokens")


def teacher_rows(run: ServeRun, done: Dict[Any, list], dev, impl: str,
                 chunk: int = 32) -> Dict[tuple, torch.Tensor]:
    """The served streams (prompt + generated) of ``sorted(done)`` through
    the ``impl`` attention on a fresh pool, ``chunk`` tokens a step:
    {(index in sorted(done), position): float32 logits} at every position
    that predicts a generated token."""
    from repro_torch.arch import model as M

    rids = sorted(done)
    seqs = [run.prompts[r] + done[r] for r in rids]
    B, n_ps = len(seqs), SERVE["cache_len"] // SERVE["page_size"]
    tbl = torch.arange(B * n_ps, dtype=torch.int32,
                       device=dev).reshape(B, n_ps)
    L = max(len(s) for s in seqs)
    toks = np.zeros((B, L), np.int32)
    for b, s in enumerate(seqs):
        toks[b, : len(s)] = s
    kv = M.init_paged_kv(run.cfg, B * n_ps, SERVE["page_size"], device=dev)
    rows = {}
    for t0 in range(0, L, chunk):
        n_new = np.array([min(chunk, max(0, len(s) - t0)) for s in seqs],
                         np.int32)
        lg, kv = M.paged_decode_step(
            run.params, kv, tbl,
            torch.full((B,), t0, dtype=torch.int32, device=dev),
            torch.as_tensor(toks[:, t0:t0 + chunk], device=dev),
            torch.as_tensor(n_new, device=dev), run.cfg, attn_impl=impl,
            all_positions=True)
        for b, r in enumerate(rids):  # positions predicting generated
            P = len(run.prompts[r])
            for j in range(int(n_new[b])):
                if P - 1 <= t0 + j < len(seqs[b]) - 1:
                    rows[(b, t0 + j)] = lg[b, j].clone()
        del lg
    return rows


def check_teacher_forced(run: ServeRun, dev) -> str:
    """(b) The kernel run's served streams through the kernel path and the
    plain path (``teacher_rows``): float32 logits at every position that
    predicts a generated token, held to delta = LOGIT_TOL * max |plain
    logits| there."""
    done = run.cb.done
    seqs = [run.prompts[r] + done[r] for r in sorted(done)]
    out = {impl: teacher_rows(run, done, dev, impl)
           for impl in ("cuda", "torch")}
    keys = sorted(out["cuda"])
    a = torch.stack([out["cuda"][k] for k in keys])
    c = torch.stack([out["torch"][k] for k in keys])
    served = torch.as_tensor([seqs[b][t + 1] for b, t in keys], device=dev)
    n_pos = a.shape[0]
    if n_pos < MIN_POSITIONS:
        fail(f"teacher-forced over {n_pos} generated positions, fewer than "
             f"{MIN_POSITIONS}")
    diff = (a - c).abs().amax(-1)
    delta = LOGIT_TOL * c.abs().amax(-1)
    ratio = (diff / delta).max().item()
    if not (diff <= delta).all():
        fail(f"teacher-forced logits: {int((diff > delta).sum())} of {n_pos} "
             f"positions differ by more than delta (worst {ratio:.3f} delta)")
    top2 = c.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    flip = a.argmax(-1) != c.argmax(-1)
    loose = flip & (margin > 2 * delta)
    if loose.any():
        fail(f"{int(loose.sum())} greedy flips where the plain top-2 margin "
             f"exceeds 2 delta")
    del out
    return (f"(b) teacher-forced over {n_pos} generated positions: max "
            f"|logits_kernel - logits_plain| within {ratio:.3f} delta at the "
            f"worst position (mean {(diff / delta).mean().item():.3f}); "
            f"{int(flip.sum())} greedy flips, all within 2 delta; greedy "
            f"agreement {1 - flip.float().mean().item():.4f} (not a gate: "
            f"{(margin <= 2 * delta).float().mean().item():.3f} of positions "
            f"have a plain top-2 margin within 2 delta); kernel path greedy "
            f"== served on {(a.argmax(-1) == served).float().mean().item():.4f}"
            f" of positions")


def serve_variant(run: ServeRun, dev, prompts, waves, **kw) -> Any:
    """A ContinuousBatcher over a fresh engine (own pool) with ``kw`` set,
    fed ``prompts`` in ``waves`` (lists of indices), 8 tokens each."""
    from repro_torch.serve.engine import (ContinuousBatcher, ServeConfig,
                                          ServeEngine)

    engine = ServeEngine(run.cfg, run.params, ServeConfig(**SERVE, **kw),
                         device=dev)
    cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=8)
    for wave in waves:
        for rid in wave:
            cb.submit(rid, prompts[rid])
        cb.run(max_steps=5000)
    return cb


def check_shared_and_int8(run: ServeRun, dev) -> str:
    """(c) share_prefix streams bitwise equal to unshared ones; (d) one
    kv_int8 run completes."""
    rng = np.random.default_rng(SEED + 1)
    prefix = rng.integers(1, run.cfg.vocab_size, SHARED_PREFIX).tolist()
    prompts = [prefix + rng.integers(1, run.cfg.vocab_size,
                                     int(rng.integers(1, 20))).tolist()
               for _ in range(24)]
    waves = [range(16), range(16, 24)]  # the first wave fills the trie
    plain = serve_variant(run, dev, prompts, waves)
    shared = serve_variant(run, dev, prompts, waves, share_prefix=True)
    # a greedy token in the padded vocab columns quarantines its request,
    # as in the JAX package: such drops must match too
    if (shared.done != plain.done or shared.dropped != plain.dropped
            or len(plain.done) + len(plain.dropped) != len(prompts)):
        fail("share_prefix streams differ from the unshared ones")
    if shared.pool.stats["shared_tokens"] <= 0:
        fail("share_prefix run shared no prefix tokens")
    i8 = serve_variant(run, dev, prompts, [range(8)], kv_int8=True)
    if (len(i8.done) + len(i8.dropped) != 8
            or set(i8.drop_reasons.values()) - {"quarantined"}
            or not all(len(t) == 8 for t in i8.done.values())):
        fail(f"kv_int8 run served {len(i8.done)} of 8 requests "
             f"({i8.drop_reasons})")
    return (f"(c) share_prefix == unshared bitwise over {len(prompts)} "
            f"requests ({shared.pool.stats['shared_tokens']} prompt tokens "
            f"shared); (d) kv_int8 served {len(i8.done)} of 8 "
            f"({len(i8.dropped)} quarantined)")


# ------------------------------------------------------------ phase 11
DEVICE_ROUND, DEVICE_CHUNK = 16, 8  # sync_every, prefill_chunk of (a)
# the profiler drops the first device records of a session, more the more
# sessions the process has run before (phase 11's window once lost all 6
# launches of the gate call that opens it); a window opens with this many
# spin kernels, which absorb the loss and are not counted
PROFILER_SPINS = 256
OUR_KERNELS = ("bucketize_kernel", "ternary_match_kernel", "fused_eb_kernel",
               "lb_lookup_kernel", "bnn_counts_kernel", "bnn_rows_kernel",
               "paged_attention_kernel", "linear_wgmma_kernel")


@dataclasses.dataclass
class DeviceRun:
    cb: Any  # the DeviceContinuousBatcher after its first wave
    seconds: float  # the first wave, graph capture included
    launches: Dict[str, int]  # wrapper counts over the first wave


def device_batcher(run: ServeRun, dev, chunk=DEVICE_CHUNK,
                   sync_every=DEVICE_ROUND, graph=True, **kw):
    """Phase 9's engine through a fresh ``DeviceContinuousBatcher``; ``kw``
    (spec_k and draft, tracer and metrics, fault_injector) go to it."""
    from repro_torch.serve.engine import (DeviceContinuousBatcher,
                                          ServeConfig, ServeEngine)

    engine = ServeEngine(run.cfg, run.params, ServeConfig(**SERVE),
                         gate=run.gate, device=dev)
    return DeviceContinuousBatcher(engine, eos_token=-1,
                                   max_tokens=SERVE_TOKENS,
                                   sync_every=sync_every,
                                   prefill_chunk=chunk, graph=graph, **kw)


def device_wave(cb, run: ServeRun, dev, tag=None, n=SERVE_REQUESTS) -> float:
    """Submit phase 9's requests (ids ``(tag, i)`` past the first wave),
    run them to the end; seconds on the host clock, synchronised."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i, (p, f) in enumerate(zip(run.prompts[:n], run.feats[:n])):
        cb.submit(i if tag is None else (tag, i), p, features=f)
    cb.run(max_steps=20000)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def drive_device(run: ServeRun, dev, **kw) -> DeviceRun:
    """One batcher, phase 9's workload; the wrapper counts are reset just
    before and read just after."""
    from repro_torch.kernels import ops

    cb = device_batcher(run, dev, **kw)
    ops.reset_launch_counts()
    seconds = device_wave(cb, run, dev)
    return DeviceRun(cb, seconds, ops.launch_counts())


def wave_streams(cb) -> Dict[Any, list]:
    """The first wave's streams (plain request ids)."""
    return {r: t for r, t in cb.done.items() if not isinstance(r, tuple)}


def check_device_main(d: DeviceRun, run: ServeRun) -> str:
    """(a) the terminal states, the gate's verdicts, the pool, the path's
    kernels."""
    cb, cfg = d.cb, run.cfg
    for k in ("paged_attention", "fused_eb", "linear"):
        if d.launches[k] <= 0:
            fail(f"the device batcher did not launch {k}: {d.launches}")
    others = {k: n for k, n in d.launches.items()
              if n and k not in ("paged_attention", "fused_eb", "linear")}
    if others:
        fail(f"the device batcher launched other kernels: {others}")
    served, dropped = set(cb.done), set(cb.dropped)
    if served & dropped or len(served) + len(dropped) != SERVE_REQUESTS:
        fail(f"device batcher: served {len(served)} + dropped "
             f"{len(dropped)} != {SERVE_REQUESTS}")
    keep = run.gate.predict(run.feats) != 1
    rejected = {r for r, why in cb.drop_reasons.items() if why == "gate-reject"}
    if rejected != set(np.where(~keep)[0].tolist()):
        fail("device batcher: gate-reject drops differ from the gate's "
             "numpy verdicts")
    if set(cb.drop_reasons.values()) - {"gate-reject", "quarantined"}:
        fail(f"device batcher: unexpected drops {cb.drop_reasons}")
    for rid, toks in cb.done.items():
        if len(toks) != SERVE_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in toks):
            fail(f"device batcher request {rid}: {len(toks)} tokens, or "
                 "out of vocab")
    held = np.where(cb.pool.ref > 0)[0]
    if (set(held.tolist()) != cb.pool.cached_pages()
            or (cb.pool.ref[held] != 1).any() or (cb.pool.ref < 0).any()):
        fail(f"device batcher: the pool holds {int(cb.pool.ref.sum())} "
             f"references past the {cb.pool.n_cached} prefix holds")
    n_tok = sum(len(t) for t in cb.done.values())
    return (f"(a) sync_every {DEVICE_ROUND}, prefill_chunk {DEVICE_CHUNK}, "
            f"graph: {len(served)} served, {len(dropped)} dropped "
            f"({dict(collections.Counter(cb.drop_reasons.values()))}), "
            f"{n_tok} tokens; {cb.steps} steps with work, "
            f"{cb.steps_executed} run, {cb.steps_wasted} wasted; first "
            f"wave {d.seconds:.3f} s with the graph capture; pool back to "
            f"{cb.pool.n_cached} prefix holds; wrapper launches "
            f"{ {k: n for k, n in d.launches.items() if n} } (the eager "
            f"warm-up, the capture and the gate calls)")


def first_wave_drops(cb) -> tuple:
    """The first wave's dropped list and reasons (plain request ids)."""
    return ([r for r in cb.dropped if not isinstance(r, tuple)],
            {r: w for r, w in cb.drop_reasons.items()
             if not isinstance(r, tuple)})


def same_run(name: str, a, b) -> None:
    if (wave_streams(a) != wave_streams(b)
            or first_wave_drops(a) != first_wave_drops(b)):
        fail(f"{name}: streams or drops differ")


def gemm_rows_invariant(run: ServeRun, dev) -> str:
    """Each of layer 0's products through ``ops.linear``, the step's
    product: a row of a chunked step's [16 x DEVICE_CHUNK, K] operand has
    the bits of the same row in a token-by-token step's [16, K] (random
    bf16 activations); fails otherwise."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    layer = run.params["layers"][0]
    B = SERVE["max_batch"]
    names = []
    for name, w in (("wq", layer["mixer"]["wq"]), ("wk", layer["mixer"]["wk"]),
                    ("wv", layer["mixer"]["wv"]), ("wo", layer["mixer"]["wo"]),
                    ("w_gate", layer["mlp"]["w_gate"]),
                    ("w_up", layer["mlp"]["w_up"]),
                    ("w_down", layer["mlp"]["w_down"])):
        x = torch.randn((B * DEVICE_CHUNK, w.shape[0]), generator=gen,
                        device=dev).to(w.dtype)
        rows = x.reshape(B, DEVICE_CHUNK, -1)[:, 0].contiguous()
        if not torch.equal(ops.linear(x, w).reshape(B, DEVICE_CHUNK, -1)[:, 0],
                           ops.linear(rows, w)):
            fail(f"(d) {name} {tuple(w.shape)}: a row of the "
                 f"[{B * DEVICE_CHUNK}, K] product differs from its "
                 f"[{B}, K] product's")
        names.append(f"{name} {tuple(w.shape)}")
    return ", ".join(names)


def check_chunked(chunked, tbt, run: ServeRun, dev) -> str:
    """(d) chunk 8 against token-by-token: the same drops and every stream
    bitwise equal (ROADMAP §C.5)."""
    a = wave_streams(chunked)
    same_run("(d) chunk 8 vs 1", chunked, tbt)
    return (f"(d) chunk {DEVICE_CHUNK} vs 1: all {len(a)} streams bitwise "
            f"equal ({sum(len(t) for t in a.values())} tokens), drops "
            f"equal; a row of each product of layer 0 has the same bits in "
            f"[{SERVE['max_batch']} x {DEVICE_CHUNK}, K] and "
            f"[{SERVE['max_batch']}, K] operands: "
            f"{gemm_rows_invariant(run, dev)}")


def check_no_sync(run: ServeRun, dev, tag: str = "(e)", **kw) -> str:
    """(e) one round of the eager step and one of the replayed graph, from
    a mid-flight state, under ``set_sync_debug_mode("error")``; ``kw`` go
    to the batcher."""
    out = []
    for graph in (False, True):
        cb = device_batcher(run, dev, graph=graph, **kw)
        for i in range(SERVE["max_batch"]):
            cb.submit(i, run.prompts[i], features=run.feats[i])
        cb.run(max_steps=4)
        (fs,) = cb._steps.values()
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fs.run(DEVICE_ROUND)
        except RuntimeError as exc:
            fail(f"{tag} a {'replayed' if graph else 'eager'} round made "
                 f"the host wait: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(dev)
        out.append("replayed" if graph else "eager")
    return (f"{tag} {DEVICE_ROUND}-step rounds, "
            f"{' and '.join(out)}, under set_sync_debug_mode(\"error\"): "
            f"no synchronising call")


def gate_tables(gate) -> int:
    return sum(len(st.tables) for st in gate.pipeline.stages
               if st.kind == "ternary")


def open_window(dev) -> None:
    """The first work of a profiler window: ``PROFILER_SPINS`` spin
    kernels (``torch.cuda._sleep``), which ``kernel_counts`` skips."""
    for _ in range(PROFILER_SPINS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize(dev)


def kernel_counts(prof) -> tuple:
    """(launches of the repo's kernels by name, device ms by kernel class,
    device events) in a profile."""
    from torch.autograd import DeviceType

    counts: Dict[str, int] = collections.Counter()
    by: Dict[str, float] = collections.Counter()
    events = 0
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA or evt.is_user_annotation
                or "spin_kernel" in evt.key):
            continue
        by[kernel_class(evt.key)] += evt.self_device_time_total / 1e3
        events += evt.count
        for k in OUR_KERNELS:
            if k in evt.key:
                counts[k] += evt.count
    return dict(counts), dict(by), events


def profile_round(cb, run: ServeRun, dev, tag: str) -> tuple:
    """A fresh wave's first round (its gate call and ``DEVICE_ROUND``
    replays) under torch.profiler, then the rest of the wave unprofiled:
    (the repo's kernels by name, steps run in the round)."""
    from torch.profiler import ProfilerActivity, profile

    for i, (p, f) in enumerate(zip(run.prompts, run.feats)):
        cb.submit((tag, i), p, features=f)
    s0, keys = cb.steps_executed, len(cb._steps)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_window(dev)
        cb.run(max_steps=DEVICE_ROUND)
        torch.cuda.synchronize(dev)
    steps = cb.steps_executed - s0
    if steps != DEVICE_ROUND or len(cb._steps) != keys:
        fail(f"(f) the profiled round ran {steps} steps, or captured")
    cb.run(max_steps=20000)
    return kernel_counts(prof)[0], steps


def profile_device(cb, run: ServeRun, dev) -> Dict[str, Any]:
    """(f) the kernels of one round: its gate call and ``DEVICE_ROUND``
    replays (about 37,000 device events; a window of a whole run, about
    220,000).  Then one warm wave timed on the host clock and one under
    the profiler give the device time a step and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    L, T = run.cfg.n_layers, gate_tables(run.gate)
    want = {"paged_attention_kernel": DEVICE_ROUND * L,
            "fused_eb_kernel": (DEVICE_ROUND + 1) * T,
            "linear_wgmma_kernel": DEVICE_ROUND * step_products(run.cfg)}
    want = {k: n for k, n in want.items() if n}
    counts, rsteps = profile_round(cb, run, dev, "round")
    if counts != want:
        fail(f"(f) the profiler saw {counts} in a round of {rsteps} steps, "
             f"expected {want} (one gate call of {T} tables)")
    s0 = cb.steps_executed
    wall = device_wave(cb, run, dev, tag="timed")
    steps = cb.steps_executed - s0
    n_tok = sum(len(t) for r, t in cb.done.items()
                if isinstance(r, tuple) and r[0] == "timed")
    s0 = cb.steps_executed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_window(dev)
        device_wave(cb, run, dev, tag="profiled")
    psteps = cb.steps_executed - s0
    wcounts, by, events = kernel_counts(prof)
    busy = sum(by.values())
    return dict(seconds=wall, steps=steps, tokens=n_tok,
                ms_step=wall / steps * 1e3, busy_ms_step=busy / psteps,
                by={k: round(v / psteps, 4) for k, v in by.items()},
                idle=1 - (busy / psteps) / (wall / steps * 1e3),
                counts=counts, rsteps=rsteps, wcounts=wcounts, psteps=psteps, events=events)


# ------------------------------------------------------------ phase 12
SPEC_K = 3


def drive_spec(run: ServeRun, d: DeviceRun, dev) -> Dict[str, Any]:
    """Phase 9's workload with ``spec_k`` SPEC_K and a bigram draft trained
    on a pilot wave (phase 11's first ``max_batch`` streams, as the
    launcher's ``--draft pilot``): every greedy stream and drop bitwise
    phase 11's; then a warm wave timed on the host clock."""
    from repro_torch.serve.spec import train_draft

    pilot = wave_streams(d.cb)
    chains = [list(p) for p in run.prompts] + [
        list(run.prompts[r]) + list(t) for r, t in sorted(pilot.items())
        if r < SERVE["max_batch"]]
    draft = train_draft(chains, vocab_size=run.cfg.vocab_size)
    cb = device_batcher(run, dev, spec_k=SPEC_K, draft=draft)
    device_wave(cb, run, dev)
    same_run("(12) spec greedy vs plain greedy", cb, d.cb)
    first, first_steps = cb.spec_stats(), cb.steps
    s0 = cb.steps_executed
    wall = device_wave(cb, run, dev, tag="timed")
    tokens = sum(len(t) for r, t in cb.done.items()
                 if isinstance(r, tuple) and r[0] == "timed")
    return dict(cb=cb, draft=draft, stats=first, first_steps=first_steps,
                seconds=wall, steps=cb.steps_executed - s0, tokens=tokens)


# ------------------------------------------------------------ phase 13
FAULT_SLOT, FAULT_DRAIN = 3, 1  # CorruptTokens: a slot live at drain 1


def check_traced(run: ServeRun, d: DeviceRun, dev) -> str:
    """A traced run of the device batcher (``obs`` Tracer and Metrics):
    streams and drops bitwise the untraced phase 11 run's, every request
    one terminal event; TTFT and decode ms a token from the tracer."""
    from repro_torch.obs import Metrics, Tracer

    mx = Metrics()
    tr = Tracer(metrics=mx)
    cb = device_batcher(run, dev, tracer=tr, metrics=mx)
    wall = device_wave(cb, run, dev)
    same_run("(13) traced vs untraced", cb, d.cb)
    problems = tr.validate()
    if problems:
        fail(f"(13) tracer lifecycle violations: {problems[:5]}")
    if sum(r.terminal is not None for r in tr.requests.values()) != (
            SERVE_REQUESTS):
        fail("(13) not every request reached a terminal event")
    pct = tr.phase_percentiles()
    show = {k: {q: round(v[q], 3) for q in ("p50", "p99")} | {"n": v["n"]}
            for k, v in pct.items() if v["n"]}
    n_tok = sum(len(t) for t in cb.done.values())
    return (f"traced run (first wave, graph capture included): streams and "
            f"drops bitwise the untraced run's, {n_tok} tokens in "
            f"{wall:.4f} s; lifecycles valid; percentiles (ms) {show}; "
            f"counters {mx.snapshot()['counters']}")


def check_faults(run: ServeRun, d: DeviceRun, dev) -> str:
    """A fault-plan run: ``CorruptTokens`` on slot FAULT_SLOT at drain
    FAULT_DRAIN (the request the fill put there, prefilled by then and not
    yet done, is quarantined) and ``PoolExhaust`` at drain 2 held for 2
    drains; every other request is served with phase 11's stream, and
    ``pool.ref`` is back to its prefix holds."""
    from repro_torch.serve.faults import CorruptTokens, FaultPlan, PoolExhaust

    plan = FaultPlan([CorruptTokens(slot=FAULT_SLOT, at_drain=FAULT_DRAIN),
                      PoolExhaust(at_drain=2, hold_drains=2)])
    inj = plan.injector()
    cb = device_batcher(run, dev, fault_injector=inj)
    device_wave(cb, run, dev)
    reasons = first_wave_drops(d.cb)[1]
    kept = [r for r in range(SERVE_REQUESTS)
            if reasons.get(r) != "gate-reject"]
    victim = kept[FAULT_SLOT]  # the step fills slots in FIFO order
    want = {**reasons, victim: "quarantined"}
    if cb.drop_reasons != want or len(inj.fired) != 2:
        fail(f"(13) fault run: drops {cb.drop_reasons}, expected {want}; "
             f"fired {inj.fired}")
    ref = wave_streams(d.cb)
    if {r: t for r, t in ref.items() if r != victim} != wave_streams(cb):
        fail("(13) fault run: a stream no fault touched differs")
    held = np.where(cb.pool.ref > 0)[0]
    if (set(held.tolist()) != cb.pool.cached_pages()
            or (cb.pool.ref[held] != 1).any() or (cb.pool.ref < 0).any()
            or cb._exh_holds):
        fail(f"(13) fault run: the pool holds {int(cb.pool.ref.sum())} "
             f"references past its {cb.pool.n_cached} prefix holds")
    return (f"fault plan {[type(f).__name__ for f in inj.fired]}: request "
            f"{victim} (slot {FAULT_SLOT}) quarantined at drain "
            f"{FAULT_DRAIN}, the other {len(wave_streams(cb))} streams "
            f"bitwise phase 11's, pool back to {cb.pool.n_cached} prefix "
            f"holds")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the serve phases' weights and traffic")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))  # the card tests' input makers
    try:
        from repro_torch import card_info, resolve_device
        from repro_torch.kernels import _build
    except ImportError as exc:
        fail(f"the repro_torch package is not beside this script ({exc})")
    dev = resolve_device("cuda")
    # the plain versions' float32 products run in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = ", ".join(card_info())
    global PEAK_INT32_OPS
    PEAK_INT32_OPS = peak_int32_ops(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}; "
          f"int32 peak {PEAK_INT32_OPS:.4e} ops/s ({INT32_LANES_PER_SM} "
          f"lanes x {torch.cuda.get_device_properties(dev).multi_processor_count}"
          f" SMs x clocks.max.sm)")

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[1 build] {time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOG.items():
        print(f"  {name}.cu ptxas:\n" + "\n".join(
            "    " + ln for ln in log.splitlines() if ln.strip()))

    n = check_kernels(dev)
    print(f"[2 kernels] {n} cases bitwise equal to their plain versions")

    staged = drive("L", dev, BATCH)
    fused = drive("M", dev, BATCH)
    for phase, run, size, backend, kernels in (
            ("3 main path", staged, "L", "cuda", ("bucketize", "ternary_match")),
            ("4 fused path", fused, "M", "cuda_fused", ("fused_eb",))):
        if run.backend != backend:
            fail(f"rf-{size} auto picked {run.backend}, expected {backend}")
        for k in kernels:
            if run.launches[k] <= 0:
                fail(f"rf-{size} path did not launch {k}: {run.launches}")
        print(f"[{phase}] rf-EB {size}: {run.res.mapped.resources().entries} "
              f"entries, backend={run.backend}, {BATCH} flows, launches "
              f"{run.launches}, labels == plain == numpy == native")

    rows = kernel_rows(staged, fused, dev)
    for path, run in (("staged", staged), ("fused", fused)):
        predict_ms = time_ms(lambda: run.fn(run.x), reps=10)
        kernel_ms = time_ms(kernels_only(run, dev), reps=10)
        print(f"[5 throughput] {path} ({run.backend}): "
              f"{flows_per_s(run.fn, run.x):.0f} flows/s; one predict of "
              f"{BATCH} flows {predict_ms:.4f} ms on the card, of which its "
              f"kernel launches {kernel_ms:.4f} ms; plain on the card: "
              f"{flows_per_s(run.plain, run.x[:CHUNK]):.0f} flows/s ({card})")

    lb_runs = drive_lb(dev, BATCH)
    from repro_torch.kernels.lb_lookup import plan as lb_plan
    for model, run in lb_runs.items():
        lb = run.res.mapped.predict_np.__self__
        F, V, K = lb.luts.shape
        print(f"[6 LB path] {model}-LB L: LUT {list(lb.luts.shape)} mode "
              f"{lb.mode}, backend={run.backend}, {BATCH} flows, launches "
              f"{run.launches}, == plain == numpy; "
              f"{flows_per_s(run.fn, run.x):.0f} flows/s, one predict "
              f"{time_ms(lambda: run.fn(run.x), reps=10):.4f} ms (device "
              f"{device_ms(lambda: run.fn(run.x))}), of which its kernel "
              f"launch {time_ms(lb_dm_kernels_only(run, dev)):.4f} ms; "
              f"{check_lb_one_kernel(model, run)}; launch plan "
              f"{lb_plan(BATCH, F, V, K, lb.mode)} ({card})")
    dm_runs = drive_dm(dev, BATCH)
    for model, run in dm_runs.items():
        print(f"[7 DM path] {model}-DM L: {run.res.mapped.resources().entries} "
              f"entries, backend={run.backend}, {BATCH} flows, launches "
              f"{run.launches}, labels == numpy == native"
              f"{' == plain' if model == 'bnn' else ''}, train "
              f"{run.res.train_seconds:.2f} s; "
              f"{flows_per_s(run.fn, run.x):.0f} flows/s, one predict "
              f"{time_ms(lambda: run.fn(run.x), reps=10):.4f} ms"
              + (f", of which its kernel launches "
                 f"{time_ms(lb_dm_kernels_only(run, dev)):.4f} ms"
                 if model == "bnn" else " (no kernel)") + f" ({card})")
    rows += lb_dm_kernel_rows(lb_runs, dm_runs, dev)
    for r in rows[-3:-1]:
        print(f"[6 lb_lookup {r['shape']['mode']}] kmeans-LB L shape "
              f"{r['shape']}: {r['ms']:.4f} ms (device {r['device_ms']}), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['n_bytes']} bytes, {r['n_ops']} ops), plain "
              f"{r['plain_ms']:.4f} ms, library (embedding_bag) "
              f"{r['library_ms']} ms (device {r['library_device_ms']}) "
              f"({card})")
    for f in rows[-1]["fused"]:
        print(f"[7 bnn fused layer {f['layer']}] {f['shape']['mode']}: "
              f"{f['ms']:.4f} ms (device {f['device_ms']}), bound "
              f"{f['bound_ms']:.4f} ms ({f['bound_by']}), plain "
              f"{f['plain_ms']:.4f} ms; counts mode {rows[-1]['ms']:.4f} ms "
              f"(device {rows[-1]['device_ms']}), bf16 matmul "
              f"{rows[-1]['library_ms']:.4f} ms (device "
              f"{rows[-1]['library_device_ms']}) ({card})")

    print(f"[8 paged_attention] {check_paged_attention(dev)}")
    pa_row = paged_attention_row(dev)
    for t in (pa_row, pa_row["skip"]):
        print(f"[8 paged_attention timing] decode shape {t['shape']}: "
              f"kernel {t['ms']:.4f} ms (device {t['device_ms']}), plain "
              f"{t['plain_ms']:.4f} ms, gather + SDPA {t['library_ms']:.4f} "
              f"ms (device {t['library_device_ms']}), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}) ({card})")
    from repro_torch.configs import get_config

    qwen = get_config("qwen2-1.5b")
    print(f"[8 linear] {check_linear(qwen, dev)}")
    print(f"[8 linear] {check_linear_groups(qwen, dev)}")
    linear_per = linear_timings(qwen, dev)
    for t in linear_per:
        print(f"[8 linear timing] {t['weight']} [{t['M']}, {t['K']}] x "
              f"[{t['K']}, {t['N']}], L2-cold over {t['copies']} copies: "
              f"kernel {t['ms']:.4f} ms (device {t['device_ms']}), cuBLAS "
              f"{t['library_ms']} ms (device {t['library_device_ms']}), "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) ({card})")
    lin_row = linear_step_row(qwen, linear_per, 0)
    for tag, r in (("C = 8", lin_row), ("C = 1", lin_row["c1"])):
        print(f"[8 linear step] {tag}, device ms a step's products "
              f"(phase 8's L2-cold launches summed): kernel "
              f"{r['device_ms']}, cuBLAS {r['library_device_ms']}, bound "
              f"{r['bound_ms']:.4f} ({card})")
    serve = drive_serve(dev, args.seed)
    cfg = serve.cfg
    print(f"[9 serve] qwen2-1.5b at full width and depth ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
          f"KV, hd {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_padded}), RANDOM weights from seed {args.seed} "
          f"(nothing downloaded), {SERVE}, rf-S gate on unsw, "
          f"{SERVE_REQUESTS} requests (prompts {PROMPT_LENS[0]}-"
          f"{PROMPT_LENS[1]} tokens, seed {args.seed}) x {SERVE_TOKENS} "
          f"tokens: {check_serve(serve)} ({card})")
    print(f"[9 serve profile] {profile_serve(serve, dev)} ({card})")
    print(f"[10 serve parity] {check_captured_attention(serve, dev)}")
    print(f"[10 serve parity] {check_teacher_forced(serve, dev)}")
    print(f"[10 serve parity] {check_shared_and_int8(serve, dev)}")
    d = drive_device(serve, dev)
    d_steps = d.cb.steps  # the first wave's
    print(f"[11 device batcher] {check_device_main(d, serve)} ({card})")
    tbt = device_batcher(serve, dev, chunk=1)
    device_wave(tbt, serve, dev)
    same_run("(b) prefill_chunk 1 vs the host batcher", tbt, serve.cb)
    print(f"[11 device batcher] (b) prefill_chunk 1 == phase 9's host "
          f"batcher bitwise: {len(serve.cb.done)} streams, drops "
          f"{serve.cb.drop_reasons}; {tbt.steps} steps with work (host: "
          f"{serve.cb.steps}), {tbt.steps_executed} run")
    eager = device_batcher(serve, dev, graph=False)
    eager_s = device_wave(eager, serve, dev)
    one = device_batcher(serve, dev, sync_every=1)
    device_wave(one, serve, dev)
    same_run("(c) graph vs eager", d.cb, eager)
    same_run("(c) sync_every 1 vs 16", d.cb, one)
    print(f"[11 device batcher] (c) graph == eager == sync_every 1, "
          f"bitwise ({len(d.cb.done)} streams; sync_every 1: "
          f"{one.steps_executed} steps run, {one.steps_wasted} wasted)")
    print(f"[11 device batcher] {check_chunked(d.cb, tbt, serve, dev)}")
    print(f"[11 device batcher] {check_no_sync(serve, dev)}")
    prof = profile_device(d.cb, serve, dev)
    n_tok = sum(len(t) for t in serve.cb.done.values())
    print(f"[11 device batcher] (f) profiler over a round of "
          f"{prof['rsteps']} steps and its gate call: {prof['counts']}, "
          f"no other kernel of the repo (over a whole run of "
          f"{prof['psteps']} "
          f"steps, {prof['events']} device events: {prof['wcounts']}, not "
          f"gated) ({card})")
    print(f"[11 device batcher timing] warm wave, graph: {prof['tokens']} "
          f"tokens in {prof['seconds']:.4f} s, "
          f"{prof['tokens'] / prof['seconds']:.1f} tokens/s, "
          f"{prof['ms_step']:.4f} ms per step run ({prof['steps']} steps); "
          f"device {prof['busy_ms_step']:.4f} ms a step (profiler: "
          f"{prof['by']}), idle "
          f"{prof['idle']:.3f} of the step; eager (first wave, no graph): "
          f"{sum(len(t) for t in eager.done.values()) / eager_s:.1f} "
          f"tokens/s, "
          f"{eager_s / eager.steps_executed * 1e3:.4f} ms per step run; "
          f"phase 9's host batcher: {n_tok / serve.seconds:.1f} tokens/s, "
          f"{serve.seconds / serve.cb.steps * 1e3:.4f} ms per step ({card})")
    spec = drive_spec(serve, d, dev)
    st = spec["stats"]
    print(f"[12 spec] spec_k {SPEC_K}, bigram draft from a pilot wave "
          f"({spec['draft'].meta['coverage']:.3f} of the vocabulary seen): "
          f"every greedy stream and drop bitwise phase 11's; drafted "
          f"{st['drafted']}, accepted {st['accepted']}, acceptance "
          f"{st['acceptance_rate']:.4f}; {spec['first_steps']} steps with "
          f"work (phase 11's first wave: {d_steps})")
    if st["accepted"] <= 0:
        fail("(12) no draft was accepted")
    no_sync = check_no_sync(serve, dev, "(12)", spec_k=SPEC_K,
                            draft=spec["draft"])
    print(f"[12 spec] {no_sync}")
    print(f"[12 spec timing] warm wave, graph: {spec['tokens']} tokens in "
          f"{spec['seconds']:.4f} s, {spec['tokens'] / spec['seconds']:.1f} "
          f"tokens/s, {spec['seconds'] / spec['steps'] * 1e3:.4f} ms per "
          f"step run ({spec['steps']} steps); phase 11's warm wave "
          f"{prof['tokens'] / prof['seconds']:.1f} tokens/s ({card})")
    print(f"[13 obs] {check_traced(serve, d, dev)} ({card})")
    print(f"[13 faults] {check_faults(serve, d, dev)}")
    pa_row["launches"] = serve.launches["paged_attention"]
    rows.append(pa_row)
    lin_row["launches"] = serve.launches["linear"]
    rows.append(lin_row)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
