"""Smoke run of the PyTorch port on one H100: build, check, drive, time.

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version on the card, bitwise,
   at the sweep shapes of the kernel tests plus edge cases;
3. main path: ``plant`` rf, encode-based, size L on unsw (not gate-sized,
   so ``torch_predict("auto")`` runs ``bucketize`` + ``ternary_match``)
   and predict 2^20 flows; labels equal the plain path on the card, and on
   the first 65,536 flows the numpy reference and the native forest;
4. fused path: the same for rf size M (gate-sized, so ``fused_eb``);
5. per-kernel times (CUDA events, median) beside the plain version's, the
   least time the card could take, and for ``bucketize`` one
   ``torch.searchsorted`` call as the library yardstick; flows/s of both
   predict paths;
6. LB path: ``plant`` svm, nb, kmeans, pca and ae, lookup-based, size L
   on unsw and predict 2^20 flows through ``auto``: one ``lb_lookup``
   launch per predict; labels (pca/ae: int32 sums bitwise, float outputs
   within 1e-5) equal the plain path on the card, and on the first 65,536
   flows the numpy reference;
7. DM path: bnn direct-map size L, trained on the card: two
   ``bnn_popcount_matmul`` launches per predict, labels equal the plain
   path, the numpy reference and the native model; dt and rf direct-map
   size L walk their trees in plain torch on the card, labels equal numpy
   and native.  Then ``lb_lookup`` (kmeans-LB L) and
   ``bnn_popcount_matmul`` (BNN-L layer 1) are timed like phase 5, with
   ``F.embedding_bag`` and a bf16 ``torch.matmul`` of the ±1 matrices as
   library yardsticks.

Its last three lines are the kernels JSON, the card's ``name, power.limit``
and ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

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
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s; the 32-bit
# CUDA-core rate (67 T/s, quoted for float32) stands for int32 operations.
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 67e12
SOURCE = "src/repro_torch/kernels/csrc/eb_kernels.cu"
LB_DM_SOURCE = "src/repro_torch/kernels/csrc/lb_dm_kernels.cu"
REPLACES = {
    "bucketize": "src/repro/kernels/bucketize.py:32",
    "ternary_match": "src/repro/kernels/ternary_match.py:53",
    "fused_eb": "src/repro/kernels/fused_eb.py:66",
    "lb_lookup": "src/repro/kernels/lb_lookup.py:39",
    "bnn_popcount_matmul": "src/repro/kernels/bnn_mlp.py:33",
}
LB_MODELS = ("svm", "nb", "kmeans", "pca", "ae")


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
    from repro_torch.core.tables import key_layout
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(42)
    n = 0
    # bucketize: test sweep, INT32_MAX against padding, thresholds beyond
    # one shared-memory tile (F*T > 12,288)
    cases = [(B, F, T) for B in (1, 7, 256, 1000)
             for F, T in ((1, 1), (5, 9), (8, 32))] + [(3000, 8, 2000)]
    for B, F, T in cases:
        vals = rng.integers(0, 2**16, (B, F)).astype(np.int32)
        thr = np.sort(rng.integers(0, 2**16, (F, T)), axis=1).astype(np.int32)
        thr[:, T // 2:] = INT32_MAX  # padded tail
        vals[0, 0] = INT32_MAX
        v, t = i32(vals, dev), i32(thr, dev)
        same(f"bucketize {B}x{F}x{T}", ops.bucketize(v, t),
             ref.bucketize_ref(v, t))
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
    torch.cuda.synchronize(dev)
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
        library_ms = None
        if name == "bucketize":
            args = (x, thr)
            kern, plain = ops.bucketize, ref.bucketize_ref
            n_bytes, n_ops = 2 * B * F * 4 + F * T * 4, B * F * T
            vt = x.T.contiguous()
            library_ms = time_ms(lambda: torch.searchsorted(thr, vt, right=True))
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
            "plain_ms": time_ms(lambda: plain(*args), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
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
        shape={"B": B, "F": F, "V": V, "K": K}))

    run = dm_runs["bnn"]
    bnn = run.res.mapped.predict_np.__self__
    w_np, n_in = bnn.packed.layers[0]
    w = torch.as_tensor(np.ascontiguousarray(w_np).view(np.int32), device=dev)
    shifts = torch.arange(bnn.in_bits, dtype=torch.int32, device=dev)
    bits = ((run.x[..., None] >> shifts) & 1).reshape(B, -1)
    x = ops.pack_bits(bits)
    N, W = w.shape
    x_pm = (bits * 2 - 1).to(torch.bfloat16)
    w_pm = torch.as_tensor(run.res.trained.binary_weights()[0].T,
                           dtype=torch.bfloat16, device=dev).contiguous()
    rows.append(dict(
        name="bnn_popcount_matmul", args=(x, w), kern=ops.bnn_popcount_matmul,
        plain=ref.bnn_popcount_matmul_ref, run=run, source=LB_DM_SOURCE,
        n_bytes=B * W * 4 + N * W * 4 + B * N * 4, n_ops=B * N * W * 4,
        library=lambda: torch.matmul(x_pm, w_pm.T),
        shape={"B": B, "W": W, "N": N, "n_in": n_in}))

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
            "plain_ms": time_ms(lambda: plain(*args), reps=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(r["library"]), "shape": r["shape"],
        })
    return out


def lb_dm_kernels_only(run: PathRun, dev) -> Callable:
    """The LB / DM-BNN predict's kernel launches alone, on the inputs that
    predict gives them (clipped codes; packed input and hidden bits)."""
    from repro_torch.kernels import ops

    model = run.res.mapped.predict_np.__self__
    if run.res.mapped.strategy == "lb":
        luts = torch.as_tensor(np.ascontiguousarray(model.luts), device=dev)
        codes = run.x.clamp(0, luts.shape[1] - 1)
        return lambda: ops.lb_lookup(codes, luts)
    shifts = torch.arange(model.in_bits, dtype=torch.int32, device=dev)
    h = ops.pack_bits(((run.x[..., None] >> shifts) & 1).reshape(
        run.x.shape[0], -1))
    args = []
    for w_np, n_in in model.packed.layers:
        w = torch.as_tensor(np.ascontiguousarray(w_np).view(np.int32),
                            device=dev)
        args.append((h, w))
        dot = 2 * (ops.bnn_popcount_matmul(h, w) - (32 * w.shape[1] - n_in)) - n_in
        h = ops.pack_bits(dot >= 0)
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import card_info, resolve_device
        from repro_torch.kernels import _build
    except ImportError as exc:
        fail(f"the repro_torch package is not beside this script ({exc})")
    dev = resolve_device("cuda")
    card = ", ".join(card_info())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

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
    for model, run in lb_runs.items():
        lb = run.res.mapped.predict_np.__self__
        print(f"[6 LB path] {model}-LB L: LUT {list(lb.luts.shape)} mode "
              f"{lb.mode}, backend={run.backend}, {BATCH} flows, launches "
              f"{run.launches}, == plain == numpy; "
              f"{flows_per_s(run.fn, run.x):.0f} flows/s, one predict "
              f"{time_ms(lambda: run.fn(run.x), reps=10):.4f} ms, of which "
              f"its kernel launch {time_ms(lb_dm_kernels_only(run, dev)):.4f}"
              f" ms ({card})")
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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
