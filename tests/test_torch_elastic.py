"""Elastic training in the port against the JAX package, on the CPU: the
fault plans, the injector, the ``ElasticTrainer`` drill and
``launch.train --elastic``.

The JAX drill (``tests/test_elastic.py``'s: qwen2-1.5b smoke, 4 workers of
2 chips, model parallel 2, a straggler evicted, the latest checkpoint's
manifest corrupted, a host lost; the slowdown 600 virtual seconds, see
``SLOW``) runs once, in a subprocess with 8 fake XLA devices; it writes its result to a temporary directory.  The port
runs the same drill on the CPU meanwhile, from the same masters (the JAX
package's init from the same key, ``arch.convert``) over 8 logical
chips.  Tolerances, each with its reason:

* the plans, the segments (causes, starts, restored steps, chip ids,
  mesh shapes) and the final workers: equal;
* each step's loss: within 2e-3 relative of the JAX drill's, the bound
  ``tests/test_torch_train.py`` holds the training curve to (bf16 products
  rounded at other places by XLA and by torch move the updates);
* every recovered segment against the port's own ``replay``, and the port
  across meshes: bitwise (one device, one reduction order: ROADMAP C.18).
"""
import json
import os
import signal
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.arch import model as JM  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.dist import elastic as JE  # noqa: E402
from repro_torch.arch.convert import master_params_from_arrays  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig  # noqa: E402
from repro_torch.dist import elastic as TE  # noqa: E402
from repro_torch.obs import Metrics  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train.elastic import ElasticTrainer  # noqa: E402
from repro_torch.train.step import TrainConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2_1_5b"
# tests/test_elastic.py's plan with a longer virtual slowdown: a straggler
# strike needs the worker's median past 1.5 x the fleet's, so 9 virtual
# seconds hold only while two real steps take under 18 s, which a loaded
# test run (several workers, each with a full thread pool) can break.
# Virtual seconds are free (the JAX package's seeded plan says so too).
SLOW = "slow:1:600.0:5@1"
PLAN = SLOW + ", corrupt:manifest@6, lost:2@7"
LOSS_RTOL = 2e-3
SPECS = ["slow:1:2.5@3, lost:2@8, preempt@10, corrupt:manifest@9",
         "slow:0:1.0:7@2,corrupt@5", "corrupt:leaf@4,lost:3@2",
         "seed:7:4:4", "seed:3:8", "seed:0:3:2", PLAN, "preempt@4", ""]


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("spec", SPECS)
def test_parse_describe_and_json_equal_jax(spec):
    got, want = TE.TrainFaultPlan.parse(spec), JE.TrainFaultPlan.parse(spec)
    assert TE.plan_to_json(got) == JE.plan_to_json(want)
    assert TE.describe(got) == JE.describe(want)
    assert len(got) == len(want)


@pytest.mark.parametrize("n_workers", [3, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_seeded_equals_jax(seed, n_workers):
    for ckpt_every in (2, 4):
        for kinds in ({}, {"slow": False}, {"preempt": False,
                                            "corrupt": False}):
            got = TE.TrainFaultPlan.seeded(seed, n_workers=n_workers,
                                           ckpt_every=ckpt_every, **kinds)
            want = JE.TrainFaultPlan.seeded(seed, n_workers=n_workers,
                                            ckpt_every=ckpt_every, **kinds)
            assert TE.plan_to_json(got) == JE.plan_to_json(want)
            assert TE.describe(got) == JE.describe(want)


def test_parse_rejects_garbage():
    for mod in (TE, JE):
        with pytest.raises(ValueError, match="needs @<step>"):
            mod.TrainFaultPlan.parse("lost:1")
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.TrainFaultPlan.parse("explode@3")
        with pytest.raises(ValueError, match="must be one of"):
            mod.TrainFaultPlan.parse("corrupt:sneeze@3")
        with pytest.raises(TypeError):
            mod.TrainFaultPlan(["not a fault"])
        with pytest.raises(ValueError, match=">= 3 workers"):
            mod.TrainFaultPlan.seeded(0, n_workers=2)


def test_injector_one_shot_and_windowed():
    """``tests/test_elastic.py``'s injector checks, both packages answering
    the same at every query."""
    spec = "slow:1:2.0:3@2, lost:2@5, preempt@7, corrupt@4"
    a = TE.TrainFaultPlan.parse(spec).injector()
    b = JE.TrainFaultPlan.parse(spec).injector()
    for w, step in ((1, 1), (0, 2), (1, 2), (1, 4), (1, 5)):
        assert a.slow_delay(w, step) == b.slow_delay(w, step)
    assert a.slow_delay(1, 2) == 0.0  # retired after step 5's query
    assert [c.what for c in a.ckpt_corruptions(4)] == ["arrays"]
    assert not a.ckpt_corruptions(4)
    assert a.host_losses(5) == [2] and a.host_losses(5) == []
    assert a.preempt_due(7) and not a.preempt_due(7)
    assert a.pending() == [] and len(a.fired) == 4
    late = TE.TrainFaultInjector(TE.TrainFaultPlan.parse("lost:1@3,"
                                                         "preempt@3"))
    assert late.host_losses(6) == [1] and late.preempt_due(6)


def test_corrupt_checkpoint_is_caught(tmp_path):
    """Each kind of damage makes ``verify`` fail and ``latest_valid_step``
    fall back."""
    for what in TE.CORRUPT_KINDS:
        d = tmp_path / what
        mgr = CheckpointManager(str(d), keep=0)
        for s in (1, 2):
            mgr.save(s, {"a": torch.arange(4.0), "b": torch.ones(3)})
        TE.corrupt_checkpoint(str(d), 2, what)
        assert mgr.verify(2) and mgr.latest_valid_step() == 1, what


def test_fault_module_imports_neither_jax_nor_torch():
    """``tests/test_elastic.py``'s import-clean check, on the port's copy:
    loaded by file path in a fresh interpreter."""
    code = textwrap.dedent("""
        import importlib.util, sys
        spec = importlib.util.spec_from_file_location(
            "elastic_standalone", "src/repro_torch/dist/elastic.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "torch", "numpy")]
        assert not leaked, leaked
        assert len(mod.TrainFaultPlan.seeded(0, n_workers=4)) == 4
        print("CLEAN")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "CLEAN" in r.stdout


# ------------------------------------------------- the drill, JAX vs port
JAX_DRILL = textwrap.dedent("""
    import json, sys, tempfile
    from repro.ckpt.manager import CheckpointManager
    from repro.configs import get_smoke_config
    from repro.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro.dist.elastic import TrainFaultPlan
    from repro.train import optimizer as OPT
    from repro.train.elastic import ElasticTrainer
    from repro.train.step import TrainConfig

    out = sys.argv[1]
    cfg = get_smoke_config("qwen2_1_5b")
    tcfg = TrainConfig(microbatches=2, q_block=32,
                       adamw=OPT.AdamWConfig(lr=2e-3, warmup_steps=3,
                                             total_steps=12))
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0))
    mgr = CheckpointManager(tempfile.mkdtemp(), keep=0)
    trainer = ElasticTrainer(
        cfg, tcfg, pipe, mgr, steps=12, n_workers=4, model_parallel=2,
        chips_per_host=2, plan=TrainFaultPlan.parse(sys.argv[2]),
        min_strikes=3, ckpt_every=3, seed=0)
    r = trainer.run()  # from PRNGKey(0)'s masters, as the port's drill
    seg = r.segments[1]
    # the straggler segment's steps again on the 4x2 mesh of all 8
    # devices: the JAX package's drift between two meshes (ROADMAP C.18)
    other = trainer.replay(seg.ckpt_step, list(range(8)), [4, 2],
                           seg.n_steps)
    json.dump({"segments": [dict(cause=s.cause, start=s.start,
                                 ckpt_step=s.ckpt_step,
                                 device_ids=s.device_ids,
                                 mesh_shape=s.mesh_shape, losses=s.losses)
                            for s in r.segments],
               "workers_final": r.workers_final,
               "steps_completed": r.steps_completed,
               "replay_4x2": other}, open(out + "/result.json", "w"))
""")


def _drill_parts(device="cpu"):
    cfg = get_smoke_config(ARCH)
    tcfg = TrainConfig(microbatches=2, q_block=32, adamw=TOPT.AdamWConfig(
        lr=2e-3, warmup_steps=3, total_steps=12))
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=0))
    return cfg, tcfg, pipe


@pytest.fixture(scope="module")
def drills():
    """(the JAX drill's result, the port's result, the port's replays of
    the recovered segments, the port's straggler segment replayed on the
    4x2 mesh, the port's metrics).  The JAX drill runs in its subprocess
    while the port runs its own from the same masters (the JAX package's
    ``init_params`` from ``PRNGKey(0)``, as the JAX trainer makes them)."""
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        proc = subprocess.Popen([sys.executable, "-c", JAX_DRILL, out, PLAN],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=ROOT)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # leave the cores to the JAX drill
        try:
            cfg, tcfg, pipe = _drill_parts()
            jp = JM.init_params(jax_smoke(ARCH), jax.random.PRNGKey(0))
            params = master_params_from_arrays(jax.tree.map(np.asarray, jp),
                                               cfg, "cpu")
            state = {"opt": TOPT.init(params, tcfg.adamw),
                     "step": torch.zeros((), dtype=torch.int32)}
            metrics = Metrics()
            with tempfile.TemporaryDirectory() as ck:
                trainer = ElasticTrainer(
                    cfg, tcfg, pipe, CheckpointManager(ck, keep=0),
                    steps=12, n_workers=4, model_parallel=2,
                    chips_per_host=2, plan=TE.TrainFaultPlan.parse(PLAN),
                    min_strikes=3, ckpt_every=3, seed=0, metrics=metrics,
                    log=None, device="cpu")
                got = trainer.run(params, state)
                replays = [trainer.replay(s.ckpt_step, s.device_ids,
                                          s.mesh_shape, s.n_steps)
                           for s in got.segments if s.ckpt_step is not None]
                seg = got.segments[1]
                wide = trainer.replay(seg.ckpt_step, list(range(8)), [4, 2],
                                      seg.n_steps)
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
            torch.set_num_threads(threads)
        assert proc.returncode == 0, err[-4000:]
        want = json.loads(Path(out, "result.json").read_text())
        yield want, got, replays, wide, metrics


def test_elastic_drill_matches_jax(drills):
    """Segments, chip ids, mesh shapes and final workers equal the JAX
    drill's; each step's loss within LOSS_RTOL of the JAX loss."""
    want, got, _, _, metrics = drills
    assert got.completed and got.steps_completed == 12
    assert got.workers_start == 4 and got.workers_final == want[
        "workers_final"] == [0, 3]
    assert [(s.cause, s.start, s.ckpt_step, s.device_ids, s.mesh_shape)
            for s in got.segments] == [
        (s["cause"], s["start"], s["ckpt_step"], s["device_ids"],
         s["mesh_shape"]) for s in want["segments"]]
    assert [s.cause for s in got.segments] == ["init", "straggler",
                                               "host-loss"]
    for seg, ref in zip(got.segments, want["segments"]):
        rel = np.abs(np.array(seg.losses) - ref["losses"]) / np.abs(
            ref["losses"])
        assert rel.max() <= LOSS_RTOL, (seg.cause, seg.losses, ref["losses"])
    counters = metrics.snapshot()["counters"]
    assert counters["train.straggler_evicted"] == 1
    assert counters["train.remesh"] == 2
    assert counters["train.ckpt_fallback"] == 1
    assert counters["train.ckpt_corrupted"] == 1
    assert counters["train.host_lost"] == 1


def test_recovered_segments_replay_bitwise(drills):
    """Every recovered segment's losses are its ``replay``'s bit for
    bit (the recovery invariant)."""
    _, got, replays, _, _ = drills
    recovered = [s for s in got.segments if s.ckpt_step is not None]
    assert len(recovered) == len(replays) == 2
    for seg, ref in zip(recovered, replays):
        assert ref == seg.losses, (seg.cause, ref, seg.losses)


def test_losses_do_not_depend_on_the_mesh(drills):
    """ROADMAP C.18: the straggler segment's steps replayed on the 4x2
    mesh of all 8 chips give its 2x2 losses bitwise in the port; the JAX
    package's GSPMD reductions may differ between meshes (held here to the
    drill's tolerance only)."""
    want, got, _, wide, _ = drills
    assert wide == got.segments[1].losses
    jw, j2 = np.array(want["replay_4x2"]), np.array(
        want["segments"][1]["losses"])
    assert np.abs(jw - j2).max() <= LOSS_RTOL * np.abs(j2).max()


# -------------------------------------------------------------- signals
class _SigtermAt:
    """The drill's pipeline, sending this process a real SIGTERM while
    making step ``at``'s batch (mid-step, as a cluster's notice lands)."""

    def __init__(self, pipe, at: int):
        self.pipe, self.at = pipe, at

    def batch_at(self, step):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.pipe.batch_at(step)


def test_real_sigterm_drains_and_stops(tmp_path):
    """A real SIGTERM with no plan: the installed handler only flags it;
    the loop drains a checkpoint at the next boundary and stops, and the
    checkpoint restores the run's state bitwise."""
    cfg, tcfg, pipe = _drill_parts()
    mgr = CheckpointManager(str(tmp_path), keep=0)
    trainer = ElasticTrainer(cfg, tcfg, _SigtermAt(pipe, 2), mgr, steps=6,
                             n_workers=2, log=None, device="cpu")
    prev = signal.getsignal(signal.SIGTERM)
    res = trainer.run()
    assert signal.getsignal(signal.SIGTERM) == prev  # uninstalled
    assert res.preempted_externally and not res.completed
    assert res.steps_completed == 3 and mgr.latest_step() == 3
    assert [s.cause for s in res.segments] == ["init"]
    assert trainer.replay(3, [0, 1], [2, 1], 2) == trainer.replay(
        3, [1], [1, 1], 2)


def test_injected_preempt_warm_restarts(tmp_path):
    """``preempt@4``: a SIGTERM at the boundary after step 4, a drained
    checkpoint at 5, a warm restart on the same mesh from it, every step
    completed once, and the restarted segment its replay's bitwise."""
    cfg, tcfg, pipe = _drill_parts()
    metrics = Metrics()
    trainer = ElasticTrainer(
        cfg, tcfg, pipe, CheckpointManager(str(tmp_path), keep=0), steps=8,
        n_workers=4, model_parallel=2, chips_per_host=2,
        plan=TE.TrainFaultPlan.parse("preempt@4"), ckpt_every=3,
        metrics=metrics, log=None, device="cpu")
    res = trainer.run()
    assert res.completed and res.executed_steps == 8
    assert [(s.cause, s.start, s.ckpt_step) for s in res.segments] == [
        ("init", 0, None), ("preempt", 5, 5)]
    assert res.segments[1].mesh_shape == res.segments[0].mesh_shape
    assert metrics.snapshot()["counters"]["train.preempt_restart"] == 1
    seg = res.segments[1]
    assert trainer.replay(5, seg.device_ids, seg.mesh_shape, 3) == seg.losses


# -------------------------------------------------------------- launcher
def test_launch_train_elastic_cli(tmp_path, capsys):
    """``tests/test_elastic.py``'s acceptance run on the port: ``--elastic``
    completes its steps under a plan that evicts a worker, and the
    elastic events are in ``--metrics-out``."""
    from repro_torch.launch import train

    snap, mout = tmp_path / "snap", tmp_path / "metrics.jsonl"
    losses = train.main([
        "--smoke", "--device", "cpu", "--elastic", "--steps", "10",
        "--seq", "32", "--batch", "8", "--workers", "4",
        "--model-parallel", "2", "--chips-per-host", "2", "--ckpt-every",
        "3", "--fault-plan", SLOW, "--snapshot-dir", str(snap),
        "--metrics-out", str(mout)])
    assert len(losses) == 10
    out = capsys.readouterr().out
    assert "fault plan: slow worker 1 +600.00s steps [1, 6)" in out
    assert "segment 1 (straggler): steps 4..10 on mesh 2x2" in out
    assert "elastic run: 10/10 steps, 10 executed, workers 4 -> 3" in out
    lines = [json.loads(ln) for ln in mout.read_text().splitlines()
             if ln.strip()]
    assert len(lines) >= 10
    last = lines[-1]
    assert last["kind"] == "train-elastic"
    assert last["counters"]["train.straggler_evicted"] >= 1, last
    assert last["counters"]["train.remesh"] >= 1, last
    assert "train.step_ms" in last["histograms"], last


def test_elastic_rejects_missing_snapshot_dir():
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="snapshot-dir"):
        train.main(["--smoke", "--device", "cpu", "--elastic", "--steps",
                    "2"])


def test_elastic_needs_workers_for_a_host_of_two_chips():
    """Without ``--workers`` the fleet is the physical devices // chips
    per host, as in the JAX package: one CPU device holds no host of 2."""
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="n_workers=0"):
        train.main(["--smoke", "--device", "cpu", "--elastic", "--steps",
                    "2", "--model-parallel", "2", "--snapshot-dir",
                    tempfile.mkdtemp()])
