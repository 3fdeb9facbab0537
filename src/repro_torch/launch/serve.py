"""Serving entry point of the port: requests through the Planter gate + LM
decode.

    # the device batcher (fused step, CUDA graph) over the paged KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --continuous --page-size 16 --requests 16 --tokens 8 \
        --prompt-len 12 --gate rf --sync-every 16 --prefill-chunk 8

    # the host-driven batcher: one step and one sync per token
    ... --batcher host

    # the same with the plain versions on the CPU
    ... --device cpu

The flags are the JAX package's (``repro.launch.serve``).  Ported: both
batchers over the paged cache (``--continuous --page-size N``, with
``--batcher device``, the default, taking ``--sync-every`` and
``--prefill-chunk``, or ``--batcher host``) with ``--pages``,
``--kv-int8``, ``--share-prefix`` (``--shared-prefix-len``),
``--prompt-len``, ``--temperature`` / ``--top-k`` / ``--top-p``,
``--gate`` / ``--gate-backend``, ``--attn-impl``, ``--deadline-s`` and
``--max-retries``.  Every other mode (the dense cache, ``--trace`` /
``--metrics-out`` / ``--fault-plan``, ``--spec-k``, the router and mesh,
``--snapshot-dir``) raises ``NotImplementedError`` naming its ROADMAP item.  Weights are
random-init from ``--seed`` with a ``torch.Generator`` (other numbers
than the JAX package's for the same seed).
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np

from ..arch import model as M
from ..configs import get_config, get_smoke_config
from ..core import PlanterConfig, plant
from ..data import load_dataset
from ..device import resolve_device
from ..nn import attn_backend as AB
from ..serve.engine import (NOT_PORTED, ContinuousBatcher,
                            DeviceContinuousBatcher, ServeConfig, ServeEngine)


def _not_ported(args) -> str:
    """The ROADMAP item of the first mode asked for that is not ported."""
    if args.router or args.mesh or args.rebalance_margin is not None:
        return NOT_PORTED["mesh"]
    if args.spec_k:
        return NOT_PORTED["spec"]
    if not args.continuous or not args.page_size:
        return NOT_PORTED["dense"]
    if args.trace or args.metrics_out or args.fault_plan:
        return NOT_PORTED["obs"]
    if args.snapshot_dir:
        return ("--snapshot-dir needs the checkpoint manager, not ported "
                "yet: ROADMAP queue A item 8")
    if args.jax_profile:
        return "--jax-profile profiles JAX; the port runs no JAX"
    return ""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gate", default="rf",
                    help="planter model for admission (or 'none')")
    ap.add_argument("--gate-backend", default="auto",
                    choices=["auto", "ref", "cuda", "cuda_fused"],
                    help="MappedModel.torch_predict backend (auto = the "
                         "fused_eb kernel for a gate-sized table on the "
                         "card, the plain version on the CPU)")
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching over the request "
                         "stream (the only serve mode ported)")
    ap.add_argument("--batcher", default="device",
                    choices=["device", "host"],
                    help="continuous-batching engine: the fused device "
                         "step or the host-driven loop")
    ap.add_argument("--sync-every", type=int, default=16,
                    help="device batcher: steps per host round trip")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: tokens per page (0 = the dense "
                         "ring cache, not ported)")
    ap.add_argument("--pages", type=int, default=0,
                    help="paged KV cache: physical page pool size (0 = "
                         "max_batch * cache_len/page_size)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="device batcher: prompt tokens per fused step")
    ap.add_argument("--share-prefix", action="store_true",
                    help="paged cache: share refcounted read-only prefix "
                         "pages (COW on the partial tail page)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="paged cache: int8 page pool with per-page scale "
                         "planes")
    ap.add_argument("--attn-impl", default="auto",
                    choices=list(AB.valid_impls()),
                    help="paged-attention backend: auto = the CUDA kernel "
                         "on the card, the plain version on the CPU")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="workload: prepend this many common prefix tokens "
                         "to every prompt (exercises --share-prefix)")
    ap.add_argument("--prompt-len", type=int, default=1,
                    help="max prompt length; prompts are drawn with "
                         "variable length in [1, prompt-len]")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding (not ported)")
    ap.add_argument("--draft", default="pilot", choices=["pilot", "prompts"],
                    help="draft corpus for --spec-k (not ported)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sampling: keep the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="sampling: nucleus filter (1.0 = off)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL serve mesh (not ported)")
    ap.add_argument("--router", action="store_true",
                    help="route across data-parallel shards (not ported)")
    ap.add_argument("--rebalance-margin", type=int, default=None,
                    help="router queue-depth slack (not ported)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="request-lifecycle trace (not ported)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="obs metrics snapshot (not ported)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline budget in seconds")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="queue-full retry budget")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault injection (not ported)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="SIGTERM snapshot / warm restart (not ported)")
    ap.add_argument("--jax-profile", default=None, metavar="DIR",
                    help="JAX profiler trace (not applicable to the port)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mesh and not args.router:
        args.router = True
    if args.router:
        args.continuous = True
    dev = resolve_device(args.device)
    why = _not_ported(args)
    if why:
        raise NotImplementedError(why)
    if (args.share_prefix or args.kv_int8) and not args.page_size:
        ap.error("--share-prefix/--kv-int8 need --page-size")
    if args.shared_prefix_len and not args.share_prefix:
        ap.error("--shared-prefix-len needs --share-prefix")
    if (args.top_k or args.top_p < 1.0) and args.temperature == 0.0:
        ap.error("--top-k/--top-p need --temperature > 0")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    params = M.init_params(cfg, args.seed, dev)

    gate = None
    ds = load_dataset("unsw", n=4000)
    if args.gate != "none":
        res = plant(PlanterConfig(model=args.gate, size="S", device=str(dev)),
                    ds.X_train, ds.y_train, ds.X_test)
        gate = res.mapped
        backend = (gate.select_backend(dev) if args.gate_backend == "auto"
                   else args.gate_backend)
        print(f"gate: {args.gate} parity={res.parity:.3f} "
              f"resources={gate.resources()} backend={backend}")

    scfg = ServeConfig(max_batch=args.batch, cache_len=64,
                       page_size=args.page_size, pages=args.pages,
                       share_prefix=args.share_prefix,
                       kv_int8=args.kv_int8, attn_impl=args.attn_impl,
                       temperature=args.temperature, top_k=args.top_k,
                       top_p=args.top_p)
    print(f"paged attention backend: {args.attn_impl} -> "
          f"{AB.resolve(args.attn_impl, dev)} on {dev}")

    feats = ds.X_test[np.arange(args.requests) % len(ds.X_test)]
    prefix = rng.integers(1, cfg.vocab_size, args.shared_prefix_len).tolist()
    prompts = [
        prefix + rng.integers(
            1, cfg.vocab_size,
            int(rng.integers(1, args.prompt_len + 1))).tolist()
        for _ in range(args.requests)]
    engine = ServeEngine(cfg, params, scfg, gate=gate,
                         gate_backend=args.gate_backend, device=dev)
    ft = dict(max_retries=args.max_retries, deadline_s=args.deadline_s)
    if args.batcher == "device":
        cb = DeviceContinuousBatcher(
            engine, eos_token=-1, max_tokens=args.tokens,
            sync_every=args.sync_every, prefill_chunk=args.prefill_chunk,
            **ft)
    else:
        cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=args.tokens,
                               **ft)
    # the host loop costs one step per prompt token
    budget = 100 * (args.tokens + args.prompt_len + args.shared_prefix_len)
    # with sharing, a first wave populates the prefix cache
    split = (min(args.batch, args.requests) if args.share_prefix
             else args.requests)
    t0 = time.perf_counter()
    for rid in range(split):
        cb.submit(rid, prompts[rid], features=feats[rid])
    cb.run(max_steps=budget)
    for rid in range(split, args.requests):
        cb.submit(rid, prompts[rid], features=feats[rid])
    done = cb.run(max_steps=budget)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in done.values())
    reasons = collections.Counter(cb.drop_reasons.values())
    steps = (f"{cb.steps} steps" if args.batcher == "host" else
             f"{cb.steps} steps with work of {cb.steps_executed} run, "
             f"{cb.steps_wasted} wasted")
    print(f"[{args.batcher}] served {len(done)} requests "
          f"(dropped {len(cb.dropped)}: {dict(reasons) or 'none'}) — "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, "
          f"{steps}, on {dev})")
    if args.share_prefix:
        print(f"  prefix sharing: {cb.pool.prefix_tokens_per_page():.2f} "
              f"live prefix tokens per pool page (1.0 = unshared)")
    return done


if __name__ == "__main__":
    main()
