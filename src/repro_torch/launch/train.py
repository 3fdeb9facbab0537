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
counterpart of ``--jax-profile``).  ``--elastic`` and the flags of its
supervision loop (``--fault-plan``, ``--snapshot-dir``, ``--workers``,
``--model-parallel``, ``--chips-per-host``) raise ``NotImplementedError``:
``ElasticTrainer`` is ROADMAP queue A item 10.  Weights are random-init
from ``--seed`` with a ``torch.Generator`` (other numbers than the JAX
package's for the same seed); the data stream is the JAX package's, bit
for bit.  The VLM and enc-dec configs raise ``ValueError``: their loss
reads ``patches`` or ``frames``, which the token stream does not carry
(the JAX launcher dies on them too, ROADMAP C.15).
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
ELASTIC = ("--elastic runs the ElasticTrainer supervision loop, not ported: "
           "ROADMAP queue A item 10")


def _not_ported(args) -> str:
    """What the first mode asked for that is not ported needs."""
    elastic = {"--elastic": args.elastic, "--fault-plan": args.fault_plan,
               "--snapshot-dir": args.snapshot_dir,
               "--workers": args.workers,
               "--model-parallel": args.model_parallel != 1,
               "--chips-per-host": args.chips_per_host}
    for flag, given in elastic.items():
        if given:
            return ELASTIC if flag == "--elastic" else (
                f"{flag} belongs to --elastic; {ELASTIC}")
    if args.jax_profile:
        return ("--jax-profile profiles JAX; the port runs no JAX (use "
                "--torch-profile DIR)")
    return ""


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
                    help="ElasticTrainer supervision loop (not ported)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="TrainFaultPlan for --elastic (not ported)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="checkpoint directory of --elastic (not ported)")
    ap.add_argument("--workers", type=int, default=None,
                    help="simulated host count for --elastic (not ported)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-parallel degree for --elastic (not ported)")
    ap.add_argument("--chips-per-host", type=int, default=None,
                    help="devices per simulated host (not ported)")
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
    why = _not_ported(args)
    if why:
        raise NotImplementedError(why)
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


if __name__ == "__main__":
    main()
