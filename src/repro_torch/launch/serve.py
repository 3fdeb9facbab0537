"""Serving entry point of the port: requests through the Planter gate + LM
decode.

    # one fixed generate() batch over the dense ring cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --requests 64 --tokens 8 --gate rf

    # the device batcher over the dense ring cache (single-token prompts)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --continuous --requests 64 --tokens 8 --sync-every 16

    # the device batcher (fused step, CUDA graph) over the paged KV cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --continuous --page-size 16 --requests 16 --tokens 8 \
        --prompt-len 12 --gate rf --sync-every 16 --prefill-chunk 8

    # the host-driven batcher: one step and one sync per token
    ... --batcher host

    # the same with the plain versions on the CPU
    ... --device cpu

    # speculative decoding (a bigram draft trained on a pilot wave),
    # a traced run with its metrics, a fault plan
    ... --spec-k 3 --draft pilot
    ... --trace t.json --metrics-out m.jsonl
    ... --fault-plan "nan:1@2,exhaust:0:2@3"

    # the request router: one shard (--router, --mesh auto or 1x1), or
    # one shard a data slice of a DATAxMODEL mesh of logical chips
    ... --continuous --page-size 16 --router [--rebalance-margin 4]
    ... --continuous --page-size 16 --mesh 2x2

    # an MoE model (qwen2-moe-a2.7b, moonshot-v1-16b-a3b) in any mode
    ... --arch qwen2-moe-a2.7b --smoke --continuous --page-size 16

    # the VLM (text-only decode, as the JAX package's) in any mode; the
    # enc-dec model over the dense cache (zero cross planes, as there)
    ... --arch internvl2-2b --smoke --continuous --page-size 16
    ... --arch seamless-m4t-large-v2 --smoke --continuous

The flags are the JAX package's (``repro.launch.serve``).  Ported: the
fixed ``generate()`` batch (no ``--continuous``), and both batchers
(``--batcher device``, the default, taking ``--sync-every``, or
``--batcher host``) over the dense ring cache (``--continuous`` without
``--page-size``) and over the paged cache (``--page-size N``, with
``--pages``, ``--kv-int8``, ``--share-prefix`` (``--shared-prefix-len``),
``--prompt-len``, ``--prefill-chunk`` and ``--spec-k`` / ``--draft``),
with ``--temperature`` / ``--top-k`` / ``--top-p``, ``--gate`` /
``--gate-backend``, ``--attn-impl``, ``--deadline-s``, ``--max-retries``,
``--trace``, ``--metrics-out``, ``--fault-plan`` and ``--snapshot-dir``
(SIGTERM stops admission at the next wave boundary, drains in-flight work
and snapshots the un-served queue through ``ckpt.CheckpointManager``; a
later run with the same directory restores it first), and ``--router`` /
``--mesh`` / ``--rebalance-margin``: ``serve.router.ShardedServe``.
``--mesh DATAxMODEL`` is that many logical chips on the one device
(``launch.mesh.make_serve_mesh(spec, chips=DATA*MODEL)``, the port's
counterpart of the fake devices the JAX tests serve the same spec on):
``DATA`` shards, each placed on its ``1xMODEL`` slice, replicated as the
JAX launcher places them.  ``--mesh auto`` (the default of ``--router``)
is one data shard over every visible card: one shard on one card or on
the CPU; more than one card raises ``NotImplementedError`` (placement
over several cards, ROADMAP queue A item 16).  Every
``--arch`` of the JAX launcher serves: a VLM decodes text only and an
enc-dec model's decode keeps its ``cross`` planes zero, as the JAX
package's do (ROADMAP C.13, C.14); ``--page-size`` with an enc-dec or
recurrent model raises the JAX package's ``ValueError``.  Weights are
random-init from ``--seed`` with a ``torch.Generator`` (other numbers
than the JAX package's for the same seed).
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from ..arch import model as M
from ..ckpt import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..core import PlanterConfig, plant
from ..data import load_dataset
from ..device import device_count, resolve_device
from ..dist.sharding import Mesh
from ..dist.stragglers import PreemptionHandler
from ..nn import attn_backend as AB
from ..obs import Metrics, Tracer
from ..serve.engine import (NOT_PORTED, ContinuousBatcher,
                            DeviceContinuousBatcher, ServeConfig, ServeEngine)
from ..serve.faults import FaultPlan, preempt_snapshot, warm_restart
from ..serve.router import ShardedServe
from ..serve.spec import train_draft
from .mesh import make_serve_mesh


def _not_ported(args) -> str:
    """Why the mode asked for does not run in the port, or ''."""
    if args.jax_profile:
        return "--jax-profile profiles JAX; the port runs no JAX"
    return ""


def serve_mesh(spec: str, device: torch.device) -> Mesh:
    """The serve mesh of a ``DATAxMODEL`` spec, or ``auto``, on the one
    device the port serves on: a spec is ``DATA * MODEL`` logical chips
    there; ``auto`` is one data shard over every visible card, which on
    more than one card raises ``NotImplementedError`` (ROADMAP queue A
    item 16).  A malformed spec is a ``ValueError``."""
    if spec == "auto":
        cards = device_count(device)
        if cards > 1:
            raise NotImplementedError(f"--mesh auto spreads {cards} cards: "
                                      + NOT_PORTED["cards"])
        return make_serve_mesh("auto", device=device)
    d, _, m = spec.lower().partition("x")
    try:
        chips = max(1, int(d) * int(m))
    except ValueError:
        chips = 1  # make_serve_mesh names the malformed spec
    return make_serve_mesh(spec, chips=chips, device=device)


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
                         "stream instead of one fixed generate() batch")
    ap.add_argument("--batcher", default="device",
                    choices=["device", "host"],
                    help="continuous-batching engine: the fused device "
                         "step or the host-driven loop")
    ap.add_argument("--sync-every", type=int, default=16,
                    help="device batcher: steps per host round trip")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: tokens per page (0 = the dense "
                         "ring cache)")
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
                    help="speculative decoding: draft tokens a decoding "
                         "slot a step, from a table-mapped bigram draft, "
                         "verified in the same launch (device batcher)")
    ap.add_argument("--draft", default="pilot", choices=["pilot", "prompts"],
                    help="draft corpus for --spec-k: 'pilot' serves a "
                         "first greedy wave and trains on its streams, "
                         "'prompts' on the prompts alone")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sampling: keep the k highest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="sampling: nucleus filter (1.0 = off)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL serve mesh (that many logical chips on "
                         "the one device) or 'auto' (every visible card in "
                         "one data shard); implies --continuous --router")
    ap.add_argument("--router", action="store_true",
                    help="route requests across data-parallel shards "
                         "(ShardedServe; --mesh picks the mesh, default "
                         "auto)")
    ap.add_argument("--rebalance-margin", type=int, default=None,
                    help="router: queue-depth slack before a request "
                         "spills off its home shard (default: max_batch)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the request-lifecycle Chrome trace-event "
                         "JSON here (chrome://tracing, Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the obs metrics snapshot (JSONL) here")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline budget in seconds")
    ap.add_argument("--max-retries", type=int, default=1,
                    help="queue-full retry budget")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="deterministic fault injection at drain "
                         "boundaries, e.g. 'nan:1@2,exhaust:0:2@3' "
                         "(serve.faults.FaultPlan.parse)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="continuous mode: on SIGTERM stop admitting, drain "
                         "in-flight work and snapshot the un-served queue "
                         "here; a later run warm-restarts from it")
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
    mesh = serve_mesh(args.mesh or "auto", dev) if args.router else None
    if args.prompt_len > 1 and not args.page_size:
        ap.error("--prompt-len > 1 needs --page-size (paged KV cache)")
    if (args.share_prefix or args.kv_int8) and not args.page_size:
        ap.error("--share-prefix/--kv-int8 need --page-size")
    if args.shared_prefix_len and not args.share_prefix:
        ap.error("--shared-prefix-len needs --share-prefix")
    if (args.top_k or args.top_p < 1.0) and args.temperature == 0.0:
        ap.error("--top-k/--top-p need --temperature > 0")
    if args.spec_k:
        if not args.page_size:
            ap.error("--spec-k needs --page-size (drafts verify through "
                     "the chunked paged step)")
        if not args.continuous:
            ap.error("--spec-k needs --continuous")
        if args.batcher == "host":
            ap.error("--spec-k needs the device batcher")
        if args.trace:
            ap.error("--spec-k is incompatible with --trace (the schedule "
                     "replay assumes one token per step)")

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
    if not args.continuous:
        return _generate_batch(args, cfg, params, scfg, gate, feats, rng,
                               dev)
    prefix = rng.integers(1, cfg.vocab_size, args.shared_prefix_len).tolist()
    prompts = [
        prefix + rng.integers(
            1, cfg.vocab_size,
            int(rng.integers(1, args.prompt_len + 1))).tolist()
        for _ in range(args.requests)]
    engine = (None if args.router else
              ServeEngine(cfg, params, scfg, gate=gate,
                          gate_backend=args.gate_backend, device=dev))
    tracer = metrics = None
    if args.trace or args.metrics_out:
        metrics = Metrics()
        tracer = Tracer(metrics=metrics)
    injector = None
    if args.fault_plan:
        plan = FaultPlan.parse(args.fault_plan)
        injector = plan.injector()
        print(f"fault plan: {len(plan)} fault(s) armed ({args.fault_plan})")
    ft = dict(max_retries=args.max_retries, deadline_s=args.deadline_s,
              fault_injector=injector, tracer=tracer, metrics=metrics)
    # the host loop costs one step per prompt token
    budget = 100 * (args.tokens + args.prompt_len + args.shared_prefix_len)
    draft = None
    if args.spec_k:
        chains = [list(p) for p in prompts]
        # the router builds its engines itself: its draft takes the prompts
        if engine is not None and args.draft == "pilot":
            # a first greedy wave, served without speculation: the draft
            # imitates the streams the LM emits
            pilot = DeviceContinuousBatcher(
                engine, eos_token=-1, max_tokens=args.tokens,
                sync_every=args.sync_every, prefill_chunk=args.prefill_chunk)
            for rid in range(min(args.batch, args.requests)):
                pilot.submit(rid, prompts[rid], features=feats[rid])
            chains += [list(prompts[rid]) + list(toks)
                       for rid, toks in pilot.run(max_steps=budget).items()]
        draft = train_draft(chains, vocab_size=cfg.vocab_size)
        print(f"spec draft: bigram table over {cfg.vocab_size} tokens, "
              f"coverage {draft.meta.get('coverage', 0.0):.2f}, "
              f"{draft.accounting()}")
    if args.router:
        cb = ShardedServe(cfg, params, scfg, mesh,
                          gate=gate, gate_backend=args.gate_backend,
                          eos_token=-1, max_tokens=args.tokens,
                          sync_every=args.sync_every,
                          rebalance_margin=args.rebalance_margin,
                          prefill_chunk=args.prefill_chunk, spec_k=args.spec_k,
                          draft=draft, device=dev, **ft)
        print(f"router: {cb.n_shards} shard(s) over mesh "
              f"{dict(mesh.shape)} on {dev}")
    elif args.batcher == "device":
        cb = DeviceContinuousBatcher(
            engine, eos_token=-1, max_tokens=args.tokens,
            sync_every=args.sync_every, prefill_chunk=args.prefill_chunk,
            spec_k=args.spec_k, draft=draft, **ft)
    else:
        cb = ContinuousBatcher(engine, eos_token=-1, max_tokens=args.tokens,
                               **ft)
    handler = None
    if args.snapshot_dir:
        manager = CheckpointManager(args.snapshot_dir)
        restored = warm_restart(cb, manager)
        if restored:
            print(f"warm restart: {restored} un-served request(s) "
                  f"restored from {args.snapshot_dir}")
        # SIGTERM -> flag only; the serve loop below checks it at the next
        # wave boundary (stop admitting, drain in-flight, snapshot whatever
        # never reached a slot)
        handler = PreemptionHandler(
            lambda: preempt_snapshot(cb, manager)).install()
    # with sharing, a first wave populates the prefix cache
    split = (min(args.batch, args.requests) if args.share_prefix
             else args.requests)
    t0 = time.perf_counter()
    for rid in range(split):
        cb.submit(rid, prompts[rid], features=feats[rid])
    cb.run(max_steps=budget)
    if handler is None or not handler.preempted:
        # a pending SIGTERM stops admission at this wave boundary; in-flight
        # work still drains below
        for rid in range(split, args.requests):
            cb.submit(rid, prompts[rid], features=feats[rid])
    done = cb.run(max_steps=budget)
    if handler is not None:
        if handler.drain():
            print(f"preempted: un-served queue snapshotted to "
                  f"{args.snapshot_dir} (warm restart restores it)")
        handler.uninstall()
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in done.values())
    reasons = collections.Counter(cb.drop_reasons.values())
    shards = cb.batchers if args.router else [cb]
    steps = (f"{cb.steps} steps" if args.batcher == "host"
             and not args.router else
             f"{sum(b.steps for b in shards)} steps with work of "
             f"{sum(b.steps_executed for b in shards)} run, "
             f"{sum(b.steps_wasted for b in shards)} wasted")
    tag = "router" if args.router else args.batcher
    print(f"[{tag}] served {len(done)} requests "
          f"(dropped {len(cb.dropped)}: {dict(reasons) or 'none'}) — "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, "
          f"{steps}, on {dev})")
    if args.router:
        print(f"  per-shard served: {[len(a) for a in cb.assigned]}")
    if args.spec_k:
        drafted = sum(b._spec_prop for b in shards)
        accepted = sum(b._spec_acc for b in shards)
        rate = accepted / drafted if drafted else 0.0
        print(f"  speculative: k={args.spec_k}, drafted {drafted}, "
              f"accepted {accepted} (acceptance {rate:.2f})")
    if args.share_prefix:
        ratio = (cb.prefix_tokens_per_page() if args.router
                 else cb.pool.prefix_tokens_per_page())
        print(f"  prefix sharing: {ratio:.2f} live prefix tokens per pool "
              f"page (1.0 = unshared)")
    if tracer is not None:
        probs = tracer.validate()
        if probs:
            print(f"  TRACE LIFECYCLE VIOLATIONS: {probs}")
        for phase, pst in tracer.phase_percentiles().items():
            if pst["n"]:
                print(f"  {phase}: p50={pst['p50']:.2f} "
                      f"p99={pst['p99']:.2f} (n={pst['n']})")
        if args.trace:
            tracer.write_chrome_trace(args.trace)
            print(f"  chrome trace -> {args.trace}")
        if args.metrics_out:
            metrics.write_jsonl(args.metrics_out, kind="serve",
                                requests=args.requests,
                                tokens_per_s=n_tok / dt)
            print(f"  metrics -> {args.metrics_out}")
    return done


def _generate_batch(args, cfg, params, scfg, gate, feats, rng, dev):
    """The request stream as one fixed ``generate()`` batch over the dense
    cache: the gate's verdicts on every request, then ``--batch`` prompts
    of 4 tokens generated ``--tokens`` further with the gate fused."""
    engine = ServeEngine(cfg, params, scfg, gate=gate,
                         gate_backend=args.gate_backend, device=dev)
    keep = engine.admit(feats)
    print(f"admitted {keep.sum()}/{len(keep)} requests "
          f"(dropped {100 * (1 - keep.mean()):.1f}% as attack traffic)")
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, 4))
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.tokens,
                          features=feats[: args.batch])
    dt = time.perf_counter() - t0
    n_tok = out.size
    print(f"generated {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s "
          f"on {dev})")
    print("sample:", out[0][:8])
    if args.metrics_out:
        metrics = Metrics()
        metrics.write_jsonl(args.metrics_out, kind="serve-batch",
                            tokens_per_s=n_tok / dt)
        print(f"metrics -> {args.metrics_out}")
    return out


if __name__ == "__main__":
    main()
