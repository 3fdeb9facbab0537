"""Fault handling in the port's batchers against the JAX package, on the
CPU: deadlines (admission and drain boundary), poison quarantine through
the injector's ``CorruptTokens``, queue-full retries with drain-boundary
backoff, and injected pool exhaustion (``PoolExhaust``).

Mirrors the paged host and device cases of ``tests/test_faults.py``.  Each
scenario runs through the JAX package's batcher and the port's with the
same plan and the same injected clock: terminal states, drop reasons,
drop and drain stamps and the page pool's counts are equal, and the
streams no fault touched equal the port's own fault-free run, bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.obs import Tracer as JaxTracer  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import faults as TF  # noqa: E402
from test_torch_serve import CFG, both  # noqa: E402,F401

MAX_TOKENS = 3


def _prompts(n, seed=0, lo=1, hi=6):
    """``tests/test_faults.py``'s prompts."""
    rng = np.random.default_rng(seed)
    return {rid: [int(t) for t in rng.integers(1, 97, rng.integers(lo, hi))]
            for rid in range(n)}


def _ticker():
    t = [0.0]

    def clock():  # one tick per read: drains advance the deadline clock
        t[0] += 1.0
        return t[0]

    return clock


def _pair(both, host, scfg_kw, plan=None, tracer=False, **kw):
    """(JAX batcher, injector), (port batcher, injector) over the same
    paged config, each with its own injector of ``plan`` (fault class
    names and arguments) and its own ticking clock; the device batchers
    take 2 steps a round and chunks of 3."""
    jp, tp, _, _ = both
    scfg = {**dict(max_batch=4, cache_len=32, page_size=8), **scfg_kw}
    out = []
    for mod, F in ((JE, JF), (TE, TF)):
        clock = _ticker()
        if mod is JE:
            eng = JE.ServeEngine(jax_smoke("qwen2-1.5b"), jp,
                                 JE.ServeConfig(attn_impl="jnp", **scfg))
        else:
            eng = TE.ServeEngine(CFG, tp, TE.ServeConfig(**scfg),
                                 device="cpu")
        inj = (F.FaultPlan([getattr(F, k)(**a) for k, a in plan]).injector()
               if plan else None)
        args = {**dict(eos_token=-1, max_tokens=MAX_TOKENS,
                       fault_injector=inj, clock=clock), **kw}
        if tracer:
            args["tracer"] = (JaxTracer if mod is JE else Tracer)(clock=clock)
        if host:
            cb = mod.ContinuousBatcher(eng, **args)
        else:
            args = {**dict(sync_every=2, prefill_chunk=3), **args}
            cb = mod.DeviceContinuousBatcher(eng, **args)
        out.append((cb, inj))
    return out


def _same_terminal_states(j, t) -> None:
    assert sorted(t.done) == sorted(j.done)
    assert {r: len(v) for r, v in t.done.items()} == {
        r: len(v) for r, v in j.done.items()}
    assert t.dropped == j.dropped and t.drop_reasons == j.drop_reasons
    assert t.dropped_at == j.dropped_at and t.done_at == j.done_at
    assert t._drains == j._drains
    np.testing.assert_array_equal(t.pool.ref, j.pool.ref)


def test_host_deadline_admission_and_midflight(both):
    """An expired queue head never takes a slot; a live slot over budget
    is evicted at the next drain boundary; a zero budget drops at
    submit."""
    (jcb, _), (tcb, _) = _pair(both, True, dict(max_batch=2))
    for cb in (jcb, tcb):
        assert cb.submit("live", 5)
        assert cb.submit("expired", 6, deadline_s=1.0)
        assert cb.submit("victim", 7, deadline_s=3.0)
        cb.run(max_steps=1)
        cb.run(max_steps=50)
        assert not cb.submit("zero", 8, deadline_s=0.0)
    assert tcb.drop_reasons == {"expired": "deadline", "victim": "deadline",
                                "zero": "deadline"}
    assert len(tcb.done["live"]) == MAX_TOKENS
    _same_terminal_states(jcb, tcb)


def test_host_quarantine_exact_slot(both):
    """A corrupted sample quarantines exactly its slot; the other streams
    equal the port's fault-free run."""
    plan = [("CorruptTokens", dict(slot=0, at_drain=0))]
    (jcb, jinj), (tcb, tinj) = _pair(both, True, dict(max_batch=2), plan)
    (_, _), (ref, _) = _pair(both, True, dict(max_batch=2))
    for cb in (jcb, tcb, ref):
        for rid in range(3):
            cb.submit(rid, rid + 5)
        cb.run(max_steps=60)
    assert tcb.drop_reasons == {0: "quarantined"}
    assert tinj.fired and len(tinj.fired) == len(jinj.fired)
    for rid in (1, 2):
        assert tcb.done[rid] == ref.done[rid]
    _same_terminal_states(jcb, tcb)


def test_host_queue_full_retry_backoff(both):
    """With a retry budget a full queue defers (drain-boundary backoff);
    with none it drops ``queue-full``."""
    (jcb, _), (tcb, _) = _pair(both, True, dict(max_batch=1), max_queue=1,
                               max_retries=3, retry_backoff=1)
    for cb in (jcb, tcb):
        for rid in range(3):
            assert cb.submit(rid, rid + 1)
        assert len(cb._retry_q) == 2
        cb.run(max_steps=100)
    assert sorted(tcb.done) == [0, 1, 2] and not tcb.dropped
    _same_terminal_states(jcb, tcb)
    (jst, _), (tst, _) = _pair(both, True, dict(max_batch=1), max_queue=1)
    for cb in (jst, tst):
        assert cb.submit(0, 1)
        assert not cb.submit(1, 2)
    assert tst.drop_reasons == jst.drop_reasons == {1: "queue-full"}


def test_host_pool_exhaustion_blocks_then_recovers(both):
    """An exhaustion pins every free page, so admission blocks; when the
    hold releases the queue drains, nothing dropped, nothing leaked."""
    plan = [("PoolExhaust", dict(at_drain=1, hold_drains=3))]
    (jcb, _), (tcb, tinj) = _pair(both, True, dict(max_batch=2, pages=6),
                                  plan)
    prompts = _prompts(4, seed=3)
    for cb in (jcb, tcb):
        for rid, p in prompts.items():
            cb.submit(rid, p)
        cb.run(max_steps=200)
    assert sorted(tcb.done) == sorted(prompts) and not tcb.dropped
    assert tinj.fired and not tcb._exh_holds
    acct = tcb.pool.page_accounting()
    assert acct["leaked"] == 0 and acct["live"] == 0
    _same_terminal_states(jcb, tcb)


@pytest.mark.parametrize("traced", [False, True])
def test_device_deadline_and_quarantine_pool_clean(both, traced):
    """Device batcher: a deadline expiry and a corrupted sample each evict
    exactly their slot at a drain boundary; the other streams equal the
    port's fault-free run; the pool balances.  Traced, the replay folds
    the host evictions in and its events equal the JAX package's."""
    prompts = _prompts(4, seed=1)
    plan = [("CorruptTokens", dict(slot=1, at_drain=1))]
    (jcb, _), (tcb, tinj) = _pair(both, False, {}, plan, tracer=traced,
                                  max_tokens=6)
    (_, _), (ref, _) = _pair(both, False, {}, max_tokens=6)
    for rid, p in prompts.items():
        ref.submit(rid, p)
    ref.run(max_steps=400)
    for cb in (jcb, tcb):
        for rid, p in prompts.items():
            cb.submit(rid, p, deadline_s=2.0 if rid == 0 else None)
        cb.run(max_steps=400)
    # the tracer reads the clock too, so a traced run's deadline falls at
    # another boundary and another request holds slot 1 then
    assert tcb.drop_reasons[0] == "deadline" and tinj.fired
    assert sorted(tcb.drop_reasons.values()) == ["deadline", "quarantined"]
    assert len(tcb.done) == 2
    for rid in tcb.done:
        assert tcb.done[rid] == ref.done[rid]
    live = [c["tbl"] for c in tcb._carry if c is not None]
    assert tcb.pool.page_accounting(live)["leaked"] == 0
    _same_terminal_states(jcb, tcb)
    if traced:
        assert ([dataclasses.asdict(r) for r in tcb.tracer.requests.values()]
                == [dataclasses.asdict(r)
                    for r in jcb.tracer.requests.values()])
        assert tcb.tracer.validate() == []


def test_device_retry_backoff_drain_boundaries(both):
    """Deferred queue-full submissions come due by drain count: an empty
    ``run()`` advances the boundary; an exhausted budget drops
    ``queue-full``."""
    (jcb, _), (tcb, _) = _pair(both, False, dict(max_batch=2), max_queue=2,
                               max_retries=2, retry_backoff=1)
    for cb in (jcb, tcb):
        for rid in range(5):
            assert cb.submit(rid, rid + 1)
        assert len(cb._retry_q) == 3
        for _ in range(8):
            cb.run(max_steps=40)
            if len(cb.done) + len(cb.dropped) == 5:
                break
    assert sorted(tcb.done) + sorted(tcb.dropped) == sorted(range(5))
    assert all(tcb.drop_reasons[r] == "queue-full" for r in tcb.dropped)
    _same_terminal_states(jcb, tcb)


def test_device_pool_exhaustion_blocks_then_recovers(both):
    """Device batcher: an injected exhaustion holds every free page at a
    drain boundary; the holds release after ``hold_drains`` boundaries (or
    at the end of the run), and everything is served, the pool clean."""
    plan = [("PoolExhaust", dict(at_drain=1, hold_drains=3))]
    (jcb, _), (tcb, tinj) = _pair(both, False, dict(max_batch=2, pages=6),
                                  plan)
    prompts = _prompts(4, seed=3)
    for cb in (jcb, tcb):
        for rid, p in prompts.items():
            cb.submit(rid, p)
        for _ in range(4):
            cb.run(max_steps=200)
    assert sorted(tcb.done) == sorted(prompts) and not tcb.dropped
    assert tinj.fired and not tcb._exh_holds
    acct = tcb.pool.page_accounting()
    assert acct["leaked"] == 0 and acct["live"] == 0
    _same_terminal_states(jcb, tcb)


def test_device_traced_pool_exhaust_refused(both):
    """A traced run with a pending exhaustion raises, as in the JAX
    package: the replay cannot model phantom holds."""
    plan = [("PoolExhaust", dict(at_drain=0, hold_drains=1))]
    (_, _), (tcb, _) = _pair(both, False, {}, plan, tracer=True)
    tcb.submit(0, [1, 2, 3])
    with pytest.raises(ValueError, match="pool-exhaust"):
        tcb.run(max_steps=10)


def test_launcher_fault_plan_on_cpu(capsys):
    from repro_torch.launch import serve

    for batcher in ("device", "host"):
        done = serve.main(["--smoke", "--device", "cpu", "--continuous",
                           "--batcher", batcher, "--page-size", "16",
                           "--requests", "6", "--tokens", "3",
                           "--prompt-len", "5", "--fault-plan",
                           "nan:1@1,exhaust:0:2@2"])
        out = capsys.readouterr().out
        assert "fault plan: 2 fault(s) armed" in out
        assert len(done) > 0 and "served" in out


# --------------------------------------------------- preemption + warm start
def test_preempt_snapshot_warm_restart(both, tmp_path, capsys):
    """Mirror of ``tests/test_faults.py`` ``test_preempt_snapshot_warm_
    restart`` through the port's checkpoint manager: the un-served queue is
    drained into a snapshot and a fresh batcher serves exactly those
    requests.  The JAX package's ``warm_restart`` reads the port's
    snapshot too, and the launcher's ``--snapshot-dir`` restores it."""
    from repro.ckpt.manager import CheckpointManager as JaxManager
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import serve

    jp, tp, _, _ = both
    scfg = TE.ServeConfig(max_batch=2, cache_len=32)

    def batcher():
        return TE.ContinuousBatcher(TE.ServeEngine(CFG, tp, scfg,
                                                   device="cpu"),
                                    eos_token=-1, max_tokens=MAX_TOKENS)

    manager = CheckpointManager(str(tmp_path))
    cb = batcher()
    for rid in range(4):
        cb.submit(rid, rid + 9, deadline_s=300.0 if rid == 0 else None)
    assert TF.preempt_snapshot(cb, manager) == 4
    assert not cb.queue  # drained: the dying process serves nothing more

    fresh = batcher()
    assert TF.warm_restart(fresh, manager) == 4
    assert 0 in fresh.deadline  # remaining budget restored, not dropped
    done = fresh.run(max_steps=60)
    assert sorted(done) == list(range(4))
    assert TF.warm_restart(batcher(),
                           CheckpointManager(str(tmp_path / "none"))) == 0

    jcb = JE.ContinuousBatcher(
        JE.ServeEngine(jax_smoke("qwen2-1.5b"), jp,
                       JE.ServeConfig(max_batch=2, cache_len=32)),
        eos_token=-1, max_tokens=MAX_TOKENS)
    assert JF.warm_restart(jcb, JaxManager(str(tmp_path))) == 4
    assert len(jcb.queue) == 4

    serve.main(["--smoke", "--device", "cpu", "--continuous", "--requests",
                "2", "--tokens", "2", "--gate", "none", "--snapshot-dir",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert f"warm restart: 4 un-served request(s) restored from " \
           f"{tmp_path}" in out
    # the launcher's own ids 0 and 1 are among the restored ones
    assert "served 4 requests (dropped 0" in out
