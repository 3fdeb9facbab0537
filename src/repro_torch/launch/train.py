"""Training entry point of the port (mirrors ``repro.launch.train``).

Wires the substrate: token pipeline, train step (every forward product
through the ``linear`` kernel on the card), checkpoint manager (atomic,
retained, async), preemption handler, straggler monitor.

    # qwen2-1.5b at full width and depth on the card, random float32
    # masters from --seed: 20 steps, batch 8, seq 64, 2 microbatches
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b

    # the smoke config on the CPU (the plain versions), with checkpoints
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --device cpu --steps 50 --ckpt-dir /tmp/ckpt --resume auto

    # the recurrent family: xlstm-125m (examples/train_lm_torch.py)
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --batch 8 --seq 128 --lr 3e-3

The flags are the JAX package's, with ``--device`` (default ``cuda``),
``--layers`` (cut the config's depth, keeping its widths) and
``--torch-profile DIR`` (a ``torch.profiler`` trace written to DIR, the
counterpart of ``--jax-profile``, which is refused).  ``--elastic`` runs
the ``train.elastic.ElasticTrainer`` supervision loop: ``--fault-plan``
(a ``dist.elastic.TrainFaultPlan`` spec), ``--snapshot-dir`` (defaults to
``--ckpt-dir``; one of them is required), ``--workers`` (simulated hosts,
each ``--chips-per-host`` logical chips on the one device; default the
physical devices // chips per host), ``--model-parallel`` (the pinned
model axis) and ``--chips-per-host`` (default ``--model-parallel``):

    # on the card: 4 hosts of 2 chips, a straggler evicted, a SIGTERM
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --layers 2 --batch 8 --seq 128 --elastic --workers 4 \
        --model-parallel 2 --chips-per-host 2 --ckpt-every 3 \
        --fault-plan "slow:1:9.0:5@1,preempt@7" --snapshot-dir /tmp/snap

Weights are random-init from ``--seed`` with a ``torch.Generator``
(other numbers than the JAX package's for the same seed); the data stream
is the JAX package's, bit for bit.  The VLM and enc-dec configs raise
``ValueError``: their loss reads ``patches`` or ``frames``, which the
token stream does not carry (the JAX launcher dies on them too, ROADMAP
C.15).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..ckpt.manager import CheckpointManager, config_hash
from ..configs import get_config, get_smoke_config
from ..data.tokens import TokenPipeline, TokenPipelineConfig
from ..device import resolve_device
from ..dist.stragglers import PreemptionHandler, StragglerMonitor
from ..train import optimizer as OPT
from ..train.step import TrainConfig, init_train_state, make_train_step

# the input each frontend family's loss reads beside the tokens
FRONTEND_INPUTS = {"vlm": "patches", "encdec": "frames"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers, widths kept "
                         "(0 = the config's depth)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--moe-impl", default="dense")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default=None, help="'auto' or step number")
    ap.add_argument("--elastic", action="store_true",
                    help="run under the ElasticTrainer supervision loop: "
                         "straggler eviction -> remesh -> verified "
                         "checkpoint restore, SIGTERM warm restart")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="TrainFaultPlan spec for --elastic (e.g. "
                         "'slow:1:1.0@1,lost:2@8' or 'seed:0:4'); see "
                         "repro_torch.dist.elastic.TrainFaultPlan.parse")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="checkpoint directory for the elastic "
                         "supervision loop (defaults to --ckpt-dir; one "
                         "of the two is required with --elastic)")
    ap.add_argument("--workers", type=int, default=None,
                    help="simulated host count for --elastic, each "
                         "--chips-per-host logical chips on the one device "
                         "(default: devices // chips-per-host)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="pinned model-parallel degree for --elastic")
    ap.add_argument("--chips-per-host", type=int, default=None,
                    help="logical chips per simulated host (default: "
                         "--model-parallel)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write per-step spans as Chrome trace-event "
                         "JSON (chrome://tracing / Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="append a metrics snapshot per step (JSONL): "
                         "step-time histogram, loss gauge, straggler "
                         "medians, gradient compression ratio")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the steps "
                         "(CPU and CUDA activity) to DIR/trace.json")
    ap.add_argument("--jax-profile", default=None, metavar="DIR",
                    help="JAX profiler trace (not applicable to the port)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.jax_profile:
        raise NotImplementedError("--jax-profile profiles JAX; the port runs "
                                  "no JAX (use --torch-profile DIR)")
    if dev.type == "cuda":
        # the backward's bf16 products accumulate in float32, as XLA's
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in FRONTEND_INPUTS:
        raise ValueError(
            f"{cfg.name} ({cfg.family}) trains on batch["
            f"{FRONTEND_INPUTS[cfg.family]!r}], which the token pipeline "
            f"does not make; the JAX launcher dies on it with a KeyError "
            f"(ROADMAP C.15).  Train it through train.step.make_train_step "
            f"with that input in the batch")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    tcfg = TrainConfig(
        microbatches=args.microbatches, compress_grads=args.compress_grads,
        moe_impl=args.moe_impl, q_block=min(512, args.seq),
        adamw=OPT.AdamWConfig(lr=args.lr, warmup_steps=5,
                              total_steps=args.steps),
    )
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))

    if args.elastic:
        return _run_elastic(args, cfg, tcfg, pipe, dev)

    params, state = init_train_state(cfg, tcfg, args.seed, dev)

    mgr = None
    start_step = 0
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3, async_writes=True)
        if args.resume:
            step = (mgr.latest_step() if args.resume == "auto"
                    else int(args.resume))
            if step is not None:
                restored = mgr.restore(step, {"params": params,
                                              "state": state})
                params, state = restored["params"], restored["state"]
                start_step = step
                print(f"resumed from step {step}")

    train_step = make_train_step(cfg, tcfg)
    monitor = StragglerMonitor(n_workers=1)
    chash = config_hash((cfg, dataclasses.asdict(tcfg)[
        "microbatches"], args.seq, args.batch))

    tracer = metrics = None
    if args.trace or args.metrics_out:
        from ..obs import Metrics, Tracer
        metrics = Metrics()
        tracer = Tracer(metrics=metrics)
    if metrics is not None and tcfg.compress_grads:
        # shape-only arithmetic: the ratio is a property of the tree
        from ..dist.compress import compression_ratio
        metrics.gauge("train.compression_ratio").set(
            compression_ratio(params))
    profiler = None
    if args.torch_profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()

    def do_ckpt():
        if mgr is not None:
            s = int(state["step"])
            mgr.save(s, {"params": params, "state": state}, chash)

    handler = PreemptionHandler(do_ckpt).install()
    losses = []
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step).items()}
        params, state, loss = train_step(params, state, batch)
        loss = float(loss)
        dt = time.perf_counter() - t0
        monitor.record(0, dt)
        losses.append(loss)
        if tracer is not None:
            tracer.span(f"step {step}", t0, t0 + dt, step=step, loss=loss)
        if metrics is not None:
            metrics.histogram("train.step_ms").observe(dt * 1e3)
            metrics.gauge("train.loss").set(loss)
            metrics.counter("train.steps").inc()
            # straggler heartbeats (a single process reports worker 0)
            for w, med in monitor.medians().items():
                metrics.gauge(f"train.worker{w}.median_step_s").set(med)
            metrics.gauge("train.stragglers").set(
                len(monitor.stragglers()))
            if args.metrics_out:
                metrics.write_jsonl(args.metrics_out, kind="train",
                                    step=step)
        print(f"step {step:5d} loss {loss:8.4f} {dt*1e3:8.1f} ms",
              flush=True)
        if handler.preempted:
            # safe point: the step has returned, its updates are done
            handler.drain()
            saved = ("checkpoint saved" if mgr is not None
                     else "no --ckpt-dir, nothing saved")
            print(f"preempted at step {step}; {saved}, stopping")
            break
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            do_ckpt()
    if mgr is not None:
        if not handler.preempted:  # drain() already saved this step
            do_ckpt()
        mgr.wait()
    handler.uninstall()
    if profiler is not None:
        profiler.stop()
        os.makedirs(args.torch_profile, exist_ok=True)
        path = os.path.join(args.torch_profile, "trace.json")
        profiler.export_chrome_trace(path)
        print(f"torch profile -> {path}")
    if tracer is not None and args.trace:
        tracer.write_chrome_trace(args.trace)
        print(f"chrome trace -> {args.trace}")
    if metrics is not None:
        h = metrics.histogram("train.step_ms")
        if h.count:
            print(f"step time p50={h.percentile(50):.1f}ms "
                  f"p99={h.percentile(99):.1f}ms over {h.count} steps")
    if len(losses) >= 10:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


def _run_elastic(args, cfg, tcfg, pipe, dev):
    """--elastic: hand the loop to the ElasticTrainer supervision loop."""
    from ..dist.elastic import TrainFaultPlan, describe
    from ..train.elastic import ElasticTrainer

    snap = args.snapshot_dir or args.ckpt_dir
    if not snap:
        raise SystemExit(
            "--elastic needs --snapshot-dir (or --ckpt-dir): recovery "
            "restores from verified checkpoints")
    plan = (TrainFaultPlan.parse(args.fault_plan)
            if args.fault_plan else None)
    if plan is not None:
        for line in describe(plan):
            print(f"fault plan: {line}")

    tracer = metrics = None
    if args.trace or args.metrics_out:
        from ..obs import Metrics, Tracer
        metrics = Metrics()
        tracer = Tracer(metrics=metrics)

    # keep enough retained steps that a fallback past a corrupted latest
    # checkpoint always has somewhere to land
    mgr = CheckpointManager(snap, keep=max(8, 2 * args.ckpt_every))
    trainer = ElasticTrainer(
        cfg, tcfg, pipe, mgr, steps=args.steps,
        n_workers=args.workers, model_parallel=args.model_parallel,
        chips_per_host=args.chips_per_host, plan=plan,
        ckpt_every=args.ckpt_every, seed=args.seed,
        metrics=metrics, tracer=tracer, metrics_out=args.metrics_out,
        device=dev)
    result = trainer.run()

    for i, seg in enumerate(result.segments):
        print(f"segment {i} ({seg.cause}): steps {seg.start}.."
              f"{seg.start + seg.n_steps} on mesh "
              f"{seg.mesh_shape[0]}x{seg.mesh_shape[1]}")
    print(f"elastic run: {result.steps_completed}/"
          f"{result.configured_steps} steps, {result.executed_steps} "
          f"executed, workers {result.workers_start} -> "
          f"{len(result.workers_final)}"
          + (" (externally preempted)" if result.preempted_externally
             else ""))
    if tracer is not None and args.trace:
        tracer.write_chrome_trace(args.trace)
        print(f"chrome trace -> {args.trace}")
    losses = result.losses
    if len(losses) >= 10:
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
