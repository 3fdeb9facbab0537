"""Dry-run planner (mirrors ``repro.launch.dryrun``): plan every (arch x
shape x mesh) cell on meta tensors.

The JAX module lowers and compiles each cell on 512 fake XLA devices and
reads XLA's memory and cost analyses.  The port's counterpart of
``jax.eval_shape`` is the meta device: each cell's params, optimizer state,
batch or decode cache are meta tensors (shapes and dtypes, no data), so
nothing is allocated and no kernel runs (a kernel wrapper given a meta
tensor takes its plain version, or its operator's fake version: shapes
only).  The mesh is
``make_production_mesh(multi_pod=, chips=256 or 512)``, logical chips on
the resolved device; the sharding rules read only its axis names and
shape, and each leaf's spec is validated against the leaf's shape
(``NamedSharding.check``).  A cell reports:

* ``memory.argument_bytes``: one chip's bytes of the step's arguments, the
  quantity of XLA's ``memory_analysis().argument_size_in_bytes``: the
  float32 params (the JAX package's leaves: ``init_params(masters=True)``,
  in every cell as the JAX dry run's arguments; the port's serve path
  holds bf16 compute copies instead), for training the optimizer state
  (``m``, ``v``, ``count``, ``step``) and
  the batch, for decoding the decode cache and the tokens.  Each leaf
  counts its shard shape under the port's rules (``dist.sharding``): every
  dim over the product of its spec's axes' sizes.
* ``step_flops``: one step's FLOPs, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` over the port's step on the
  meta tensors (the products' operators carry FLOP formulas:
  ``kernels.linear``, ``kernels.moe``).  A training step's count does not
  depend on how its batch splits into microbatches (every counted
  operation is linear in a microbatch's rows), so it is counted over one
  microbatch of the whole batch, which dispatches several times fewer
  meta operations; ``microbatches`` is the plan's split.
  ``step_flops_per_chip`` is the count split evenly over the mesh.
* ``collectives``: a model of GSPMD's collectives, not an HLO count, one
  chip's output bytes of the two terms the sharding rules fix: the
  float32 gradients' reduction over the data axes (training, once a step)
  and the ``model`` axis's reductions of the outputs of the products whose
  contracted dim the rules shard over ``model`` (``wo`` / ``w_down`` /
  ``w_out`` rows, the MoE experts of ``w_down``), in bf16, once a forward
  (twice a training step: its ``"full"`` remat recomputes the forward).
  The JAX module parses the compiled HLO (``collective_bytes``); the port
  compiles no partitioned program, so it has no counterpart of that parse.
* ``fit``: on the card, whether the argument bytes fit the card's memory
  (``torch.cuda.get_device_properties(dev).total_memory``); on the CPU the
  bytes alone, no verdict.

Peak and temporary memory and the bytes accessed need a compiled or a real
run, and the plan reports neither.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k [--multi-pod] [--all] [--out out.json] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..arch import model as M
from ..arch.config import SHAPES, ArchConfig, ShapeConfig
from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..dist import sharding as SH
from ..train.step import TrainConfig, init_train_state, make_train_step
from ..tree import leaves
from .mesh import make_production_mesh

__all__ = ["cell_supported", "input_specs", "lower_cell", "analyze",
           "run_cell", "main"]

META = torch.device("meta")


# shapes skipped per spec: long_500k needs sub-quadratic attention
def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k skipped: pure full-attention arch (DESIGN §4)"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    B, S = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if shape.kind == "decode":
        return {"tokens": sds((B, 1), torch.int32)}
    batch = {"tokens": sds((B, S), torch.int32)}
    if cfg.family == "encdec":
        enc_len = min(S, cfg.frontend_seq or S)
        batch["frames"] = sds((B, enc_len, cfg.frontend_dim), torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = sds((B, cfg.frontend_seq, cfg.frontend_dim),
                               torch.float32)
    return batch


def _microbatches(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Grad-accumulation depth: keep per-device microbatch ~1-2 sequences."""
    dp_size = SH._axis_size(mesh, SH.data_axis(mesh))
    per_dev = max(1, shape.global_batch // dp_size)
    return max(1, min(per_dev, 8))


@dataclasses.dataclass
class Cell:
    """One planned cell: its mesh, the step's arguments as meta tensors with
    each leaf's spec (``(name, tree, spec_of)``: ``spec_of(leaf)`` takes a
    ``repro_torch.tree`` leaf), the float32 params, the tokens a chip
    holds, the forward passes a step makes, and the step itself."""
    mesh: SH.Mesh
    args: List[Tuple[str, Any, Callable]]
    params: Any
    tokens_per_chip: int
    passes: int
    step: Callable[[], Any]
    key: Tuple


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               device="cuda") -> Tuple[Cell, Dict[str, Any]]:
    """Plan one (arch, shape, mesh) cell on meta tensors; returns (cell,
    meta).

    ``overrides`` takes the CLI's knobs, ``moe_impl`` and ``q_block``.
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(why)
    overrides = dict(overrides or {})
    dev = resolve_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                chips=512 if multi_pod else 256, device=dev)
    dp_size = SH._axis_size(mesh, SH.data_axis(mesh))
    B, S = shape.global_batch, shape.seq_len
    moe_impl = overrides.get("moe_impl", "dense")
    q_block = overrides.get("q_block", 512)
    key = (arch, shape_name, tuple(sorted(overrides.items())))

    def param_spec(leaf):
        return SH.param_spec(leaf.key, leaf, mesh)

    def batch_spec(leaf):
        return SH.batch_pspec(mesh, leaf.shape[0], len(leaf.shape))

    def replicated(leaf):
        return SH.P()

    meta: Dict[str, Any] = {}
    if shape.kind == "train":
        tcfg = TrainConfig(microbatches=_microbatches(cfg, shape, mesh),
                           moe_impl=moe_impl, q_block=q_block)
        params, state = init_train_state(cfg, tcfg, 0, META)
        batch = input_specs(cfg, shape)
        args = [("params", params, param_spec),
                ("opt.m", state["opt"].m, param_spec),
                ("opt.v", state["opt"].v, param_spec),
                ("opt.count", state["opt"].count, replicated),
                ("step", state["step"], replicated),
                ("batch", batch, batch_spec)]
        # the count over one microbatch of the whole batch (module
        # docstring): the same FLOPs, fewer meta operations
        step_fn = make_train_step(cfg, dataclasses.replace(tcfg,
                                                           microbatches=1))

        def step():
            return step_fn(params, state, batch)

        passes = 2  # "full" remat recomputes the forward
        tokens = B * S
        meta = {"kind": "train", "microbatches": tcfg.microbatches}
    elif shape.kind == "prefill":
        params = M.init_params(cfg, 0, META, masters=True)
        batch = input_specs(cfg, shape)
        args = [("params", params, param_spec),
                ("batch", batch, batch_spec)]

        def step():
            with torch.no_grad():
                logits, _ = M.forward(params, batch, cfg, q_block=q_block,
                                      moe_impl=moe_impl)
            return logits[:, -1]

        passes, tokens = 1, B * S
        meta = {"kind": "prefill"}
    else:  # decode
        params = M.init_params(cfg, 0, META, masters=True)
        state = M.init_decode_state(cfg, B, S, device=META)
        tokens_in = input_specs(cfg, shape)
        args = [("params", params, param_spec),
                ("state", state,
                 lambda leaf: SH.cache_pspec(leaf.key, leaf, mesh, B)),
                ("tokens", tokens_in, batch_spec)]

        def step():
            with torch.no_grad():
                return M.decode_step(M.compute_params(params), state,
                                     tokens_in["tokens"], cfg)

        passes, tokens = 1, B
        meta = {"kind": "decode", "cache_len": S}
    if B % dp_size == 0:
        tokens //= dp_size
    meta.update(arch=arch, shape=shape_name, n_layers=cfg.n_layers,
                mesh="2x16x16" if multi_pod else "16x16")
    return Cell(mesh, args, params, tokens, passes, step, key), meta


def _leaf_bytes(mesh, leaf, spec) -> int:
    shard = SH.NamedSharding(mesh, spec).shard_shape(leaf.shape)
    return math.prod(shard) * leaf.parts[0].element_size()


def argument_bytes(cell: Cell) -> Dict[str, int]:
    """One chip's bytes of each argument (its leaves' shard shapes)."""
    out = {}
    for name, tree, spec_of in cell.args:
        out[name] = sum(_leaf_bytes(cell.mesh, leaf, spec_of(leaf))
                        for leaf in leaves(tree))
    return out


def collective_model(cell: Cell, kind: str) -> Dict[str, float]:
    """The two terms of one chip's collective output bytes that the rules
    fix (module docstring): a model of GSPMD's collectives, not a count."""
    mesh = cell.mesh
    dp = SH._axis_size(mesh, SH.data_axis(mesh))
    mp = int(mesh.shape.get(SH.MODEL_AXIS, 1))
    out: Dict[str, float] = {}
    if kind == "train" and dp > 1:
        out["grad-reduce-data"] = float(sum(
            _leaf_bytes(mesh, leaf, SH.param_spec(leaf.key, leaf, mesh))
            for leaf in leaves(cell.params)))
    if mp > 1:
        width = 0
        for leaf in leaves(cell.params):
            if leaf.key.split("/")[-1] not in SH._ROW_PARALLEL:
                continue
            spec = tuple(SH.param_spec(leaf.key, leaf, mesh))
            lead = 1 if leaf.stacked else 0
            if spec[lead] == SH.MODEL_AXIS:  # a contracted dim over model
                width += (leaf.shape[0] if leaf.stacked else 1) * \
                    leaf.shape[-1]
        if width:
            out["row-parallel-reduce-model"] = float(
                cell.passes * cell.tokens_per_chip * width * 2)
    return out


_FLOPS: Dict[Tuple, int] = {}


def step_flops(cell: Cell) -> int:
    """One step's FLOPs on the meta tensors.  The mesh does not change
    them, so a cell planned on both meshes is counted once."""
    if cell.key not in _FLOPS:
        with FlopCounterMode(display=False) as fc:
            cell.step()
        _FLOPS[cell.key] = int(fc.get_total_flops())
    return _FLOPS[cell.key]


def analyze(cell: Cell, meta: Dict[str, Any]) -> Dict[str, Any]:
    args = argument_bytes(cell)
    flops = step_flops(cell)
    coll = collective_model(cell, meta["kind"])
    info = {"step_flops": float(flops),
            "step_flops_per_chip": float(flops) / cell.mesh.size,
            "memory": {"argument_bytes": int(sum(args.values())),
                       "argument_bytes_by_name": args},
            "collectives": coll,
            "collective_bytes_total": float(sum(coll.values()))}
    dev = cell.mesh.device
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        info["fit"] = {"fits": info["memory"]["argument_bytes"] <= total,
                       "device_bytes": int(total),
                       "device": torch.cuda.get_device_name(dev)}
    return info


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides=None, verbose: bool = True,
             device="cuda") -> Dict[str, Any]:
    t0 = time.time()
    cell, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                            overrides=overrides, device=device)
    info = analyze(cell, meta)
    info.update(meta)
    info["plan_seconds"] = round(time.time() - t0, 2)
    if verbose:  # the dry-run contract: the bytes a chip, the costs
        print(f"[{arch} {shape_name}] argument bytes a chip: "
              f"{info['memory']['argument_bytes_by_name']} (no peak or "
              f"temporary memory: those need a compiled or real run)")
        print(f"[{arch} {shape_name}] step FLOPs {info['step_flops']:.4g} "
              f"(FlopCounterMode on meta tensors), "
              f"{info['step_flops_per_chip']:.4g} a chip (an even split "
              f"over {cell.mesh.size} chips); collectives a chip "
              f"{info['collectives']} (a model of GSPMD's, not an HLO "
              f"count)")
    return info


def _fit(info: Dict[str, Any]) -> str:
    fit = info.get("fit")
    if fit is None:
        return "fit=n/a (no card)"
    gib = 1 << 30
    return (f"fit={'yes' if fit['fits'] else 'NO'} "
            f"({info['memory']['argument_bytes'] / gib:.2f} of "
            f"{fit['device_bytes'] / gib:.2f} GiB)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--moe-impl", default="dense")
    ap.add_argument("--q-block", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the fit verdict against the card) "
                         "or cpu (the bytes alone)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    overrides = {"moe_impl": args.moe_impl, "q_block": args.q_block}
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        cells = [(args.arch.replace("-", "_"), args.shape)]

    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    results = []
    for arch, shape in cells:
        cfg = get_config(arch)
        ok, why = cell_supported(cfg, SHAPES[shape])
        if not ok:
            results.append({"arch": arch, "shape": shape, "skipped": why})
            print(f"SKIP  {arch:24s} {shape:12s} {why}")
            continue
        for mp in meshes:
            tag = "2x16x16" if mp else "16x16"
            try:
                info = run_cell(arch, shape, multi_pod=mp,
                                overrides=overrides, device=dev)
                results.append(info)
                print(f"OK    {arch:24s} {shape:12s} {tag:8s} "
                      f"flops={info['step_flops']:.3e} "
                      f"flops/chip={info['step_flops_per_chip']:.3e} "
                      f"args/chip={info['memory']['argument_bytes']:.4e} "
                      f"coll/chip={info['collective_bytes_total']:.3e} "
                      f"{_fit(info)} plan={info['plan_seconds']}s")
            except Exception as e:
                results.append({"arch": arch, "shape": shape, "mesh": tag,
                                "error": str(e)[:500]})
                print(f"FAIL  {arch:24s} {shape:12s} {tag:8s} {e}",
                      file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n{len(results)} cells, {n_fail} failures")
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
