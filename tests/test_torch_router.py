"""The port's mesh-less request router (``repro_torch.serve.router``) on the
CPU: against the JAX package's ``ShardedServe(mesh=None, n_shards=...)``
on the same inputs, and against the port's own lone batchers.

Mirrors the mesh-less parts of ``tests/test_router.py`` and the router
faults of ``tests/test_faults.py``.  Against JAX: HRW weights and homes
bitwise, and the requests served (``done``'s keys), ``dropped``,
``drop_reasons``, ``failover_log``, ``retries`` and the shards' assignment
lists equal; served streams equal up to their first JAX near tie (the
rule of ``test_torch_serve.py``: the two packages' bf16 roundings differ,
so a greedy token may flip where the JAX top-2 margin is within twice the
logit tolerance).  The port against itself: bitwise.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve import router as JR  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import faults as TF  # noqa: E402
from repro_torch.serve import router as TR  # noqa: E402
from test_torch_serve import (CFG, DS, _jax_margins,  # noqa: E402,F401
                              _prefix_prompts, both)

MAX_TOKENS = 3
DENSE = dict(max_batch=4, cache_len=32)
PAGED = dict(max_batch=4, cache_len=32, page_size=8)


def _prompts(n, seed=0, lo=1, hi=6):
    """``tests/test_faults.py``'s prompts."""
    rng = np.random.default_rng(seed)
    return {rid: [int(t) for t in rng.integers(1, 97, rng.integers(lo, hi))]
            for rid in range(n)}


def _routers(both, scfg, gate=False, plan=None, **kw):
    """(JAX router, port router) on the same config, gate and fault plan
    (each with its own injector)."""
    jp, tp, jg, tg = both
    kw = dict(dict(eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2), **kw)
    jr = JR.ShardedServe(jax_smoke("qwen2-1.5b"), jp,
                         JE.ServeConfig(**scfg, attn_impl="jnp"), None,
                         gate=jg if gate else None,
                         fault_injector=(JF.FaultPlan(plan(JF)).injector()
                                         if plan else None), **kw)
    tr = TR.ShardedServe(CFG, tp, TE.ServeConfig(**scfg), None,
                         gate=tg if gate else None, device="cpu",
                         fault_injector=(TF.FaultPlan(plan(TF)).injector()
                                         if plan else None), **kw)
    return jr, tr


def _same_outcome(jr, tr, done_j, done_t):
    assert sorted(done_t) == sorted(done_j)
    assert tr.dropped == jr.dropped
    assert tr.drop_reasons == jr.drop_reasons
    assert tr.failover_log == jr.failover_log
    assert tr.retries == jr.retries
    assert tr.assigned == jr.assigned
    assert tr.alive == jr.alive


def _same_streams(both, prompts, done_j, done_t):
    """Each port stream equal to the JAX one up to its first near tie."""
    jp = both[0]
    compared = 0
    for rid, (margin, bound) in _jax_margins(
            jp, jax_smoke("qwen2-1.5b"), prompts, done_j, False).items():
        near = np.nonzero(margin <= bound)[0]
        upto = int(near[0]) if len(near) else len(done_j[rid])
        assert done_t[rid][:upto] == done_j[rid][:upto], (rid, upto)
        assert len(done_t[rid]) == len(done_j[rid])
        compared += upto
    assert compared > 0


# ------------------------------------------------------------- hashing
def test_hrw_weights_and_homes_equal_jax():
    """``_hrw_weight``, ``rendezvous_shard`` over every non-empty set of up
    to 4 shards and ``stable_shard`` over 1-4 shards, for 10,000 request
    ids (ints, strings and tuples), bitwise the JAX package's."""
    ids = ([i for i in range(4000)] + [f"req-{i}" for i in range(3000)]
           + [("wave", i) for i in range(3000)])
    sets = [s for n in range(1, 5) for s in itertools.combinations(range(4), n)]
    for rid in ids:
        key = repr(rid).encode()
        assert [TR._hrw_weight(key, s) for s in range(4)] == \
            [JR._hrw_weight(key, s) for s in range(4)]
        for shards in sets:
            assert TR.rendezvous_shard(rid, shards) == \
                JR.rendezvous_shard(rid, shards)
        for n in range(1, 5):
            assert TR.stable_shard(rid, n) == JR.stable_shard(rid, n)
    with pytest.raises(ValueError, match="empty"):
        TR.rendezvous_shard(0, [])


def test_stable_shard_deterministic():
    assert TR.stable_shard("req-42", 8) == TR.stable_shard("req-42", 8)
    assert TR.stable_shard(("a", 1), 4) == TR.stable_shard(("a", 1), 4)
    assert {TR.stable_shard(i, 4) for i in range(64)} == {0, 1, 2, 3}


def test_rendezvous_remaps_only_the_dead_shards_keys():
    """Removing a shard moves only the keys it was home to."""
    full = {i: TR.rendezvous_shard(i, range(4)) for i in range(2000)}
    for dead in range(4):
        alive = [s for s in range(4) if s != dead]
        for i, home in full.items():
            if home != dead:
                assert TR.rendezvous_shard(i, alive) == home


# -------------------------------------------------------- faults vs JAX
def test_router_failover_replays_lost_requests(both):
    """``ShardCrash(shard=1, at_drain=1)``: the crashed shard's queued and
    in-flight requests re-route to the survivor and replay from their
    prompts; JAX and the port agree on every terminal state, the failover
    log and the hops; every port stream is bitwise a fault-free lone port
    batcher's, and equal to JAX's up to its first near tie."""
    prompts = _prompts(10, seed=2)
    jr, tr = _routers(both, PAGED, prefill_chunk=3, n_shards=2,
                      max_retries=2,
                      plan=lambda F: [F.ShardCrash(shard=1, at_drain=1)])
    for rid, p in prompts.items():
        jr.submit(rid, p)
        tr.submit(rid, p)
    done_j = jr.run(max_steps=400, drain_chunk=2)
    done_t = tr.run(max_steps=400, drain_chunk=2)
    _same_outcome(jr, tr, done_j, done_t)
    assert tr.failover_log[0][:2] == (1, "crash-injected")
    assert not tr.alive[1] and tr.alive[0] and tr.retries
    assert len(done_t) + len(tr.dropped) == len(prompts)
    assert not set(done_t) & set(tr.dropped)
    ref = TE.DeviceContinuousBatcher(
        TE.ServeEngine(CFG, both[1], TE.ServeConfig(**PAGED), device="cpu"),
        eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2, prefill_chunk=3)
    for rid, p in prompts.items():
        ref.submit(rid, p)
    ref_done = ref.run(max_steps=400)
    for rid, stream in done_t.items():
        assert stream == ref_done[rid]
    _same_streams(both, prompts, done_j, done_t)


def test_router_failover_exhausted_retries_drop(both):
    """Every shard dead at drain 0: each request drops ``shard-failed``,
    in both packages alike."""
    jr, tr = _routers(both, DENSE, n_shards=2, max_retries=2,
                      plan=lambda F: [F.ShardCrash(shard=0, at_drain=0),
                                      F.ShardCrash(shard=1, at_drain=0)])
    for rid in range(6):
        jr.submit(rid, rid + 1)
        tr.submit(rid, rid + 1)
    done_j = jr.run(max_steps=100, drain_chunk=2)
    done_t = tr.run(max_steps=100, drain_chunk=2)
    _same_outcome(jr, tr, done_j, done_t)
    assert not done_t and sorted(tr.dropped) == list(range(6))
    assert all(tr.drop_reasons[r] == "shard-failed" for r in tr.dropped)
    assert set(tr.dropped_at) == set(range(6))


def test_router_straggler_eviction(both):
    """A shard slowed by 30 s (virtually) at every drain is evicted after
    two flagged rounds and its work fails over; the survivor is never
    evicted; JAX and the port alike."""
    jr, tr = _routers(both, dict(max_batch=2, cache_len=32), n_shards=2,
                      max_tokens=8, max_retries=2, straggler_strikes=2,
                      plan=lambda F: [F.SlowShard(shard=1, delay_s=30.0,
                                                  at_drain=d)
                                      for d in range(8)])
    for rid in range(8):
        jr.submit(rid, rid + 1)
        tr.submit(rid, rid + 1)
    done_j = jr.run(max_steps=400, drain_chunk=2)
    done_t = tr.run(max_steps=400, drain_chunk=2)
    _same_outcome(jr, tr, done_j, done_t)
    assert any(reason == "straggler" for _, reason, _ in tr.failover_log)
    assert not tr.alive[1] and tr.alive[0]
    assert len(done_t) + len(tr.dropped) == 8


def test_router_deadline_threads_through(both):
    """A zero budget drops at admission; the rest of the wave is served."""
    jr, tr = _routers(both, DENSE, n_shards=2)
    for r in (jr, tr):
        assert not r.submit("late", 3, deadline_s=0.0)
        assert r.drop_reasons["late"] == "deadline"
        assert r.submit("ok", 4, deadline_s=60.0)
    done_j, done_t = jr.run(max_steps=100), tr.run(max_steps=100)
    _same_outcome(jr, tr, done_j, done_t)
    assert "ok" in done_t and "late" in tr.dropped


# ------------------------------------------------- routing vs JAX / self
def _gated_wave(r, n=10, seed=0):
    rng = np.random.default_rng(seed)
    toks = {}
    for rid in range(n):
        toks[rid] = int(rng.integers(1, 100))
        r.submit(rid, toks[rid], features=DS.X_test[rid])
    return toks


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_gated_router_routes_as_jax(both, n_shards):
    """The gated wave through 1-3 mesh-less shards: the one gate call's
    drops, the HRW homes (``assigned``, FIFO within each shard) and the
    served set equal the JAX router's."""
    jr, tr = _routers(both, DENSE, gate=True, n_shards=n_shards)
    toks = _gated_wave(jr)
    _gated_wave(tr)
    done_j, done_t = jr.run(max_steps=200), tr.run(max_steps=200)
    _same_outcome(jr, tr, done_j, done_t)
    admitted = [r for r in toks if r not in tr.dropped]
    assert sorted(done_t) == sorted(admitted) and tr.dropped
    for rids in tr.assigned:
        assert rids == sorted(rids)  # FIFO within the shard


def test_single_shard_router_bit_parity(both):
    """One shard: the router's streams and drops are the lone host
    batcher's and the lone device batcher's, bitwise."""
    _, tp, _, tg = both

    def engine():
        return TE.ServeEngine(CFG, tp, TE.ServeConfig(**DENSE), gate=tg,
                              device="cpu")

    host = TE.ContinuousBatcher(engine(), eos_token=-1, max_tokens=MAX_TOKENS)
    _gated_wave(host)
    done_h = host.run(max_steps=200)
    _, router = _routers(both, DENSE, gate=True)
    _gated_wave(router)
    assert router.run(max_steps=200) == done_h
    assert sorted(router.dropped) == sorted(host.dropped)
    assert router.drop_reasons == host.drop_reasons


@pytest.mark.parametrize("paged", [False, True])
def test_multi_shard_fifo_and_per_shard_parity(both, paged):
    """Two shards: FIFO within each shard, and each shard's streams equal
    a lone device batcher fed the same requests in the same order."""
    _, tp, _, tg = both
    scfg = PAGED if paged else DENSE
    chunk = dict(prefill_chunk=4) if paged else {}
    _, router = _routers(both, scfg, gate=True, n_shards=2, **chunk)
    rng = np.random.default_rng(2)
    prompts = {rid: ([int(t) for t in rng.integers(1, 97, rng.integers(1, 8))]
                     if paged else [int(rng.integers(1, 100))])
               for rid in range(10)}
    for rid, p in prompts.items():
        router.submit(rid, p, features=DS.X_test[rid])
    done = router.run(max_steps=400)
    admitted = [r for r in prompts if r not in router.dropped]
    assert sorted(done) == sorted(admitted)
    assert sum(len(a) for a in router.assigned) == len(admitted)
    assert all(router.assigned)
    for rids in router.assigned:
        assert rids == sorted(rids)
        ref = TE.DeviceContinuousBatcher(
            TE.ServeEngine(CFG, tp, TE.ServeConfig(**scfg), gate=tg,
                           device="cpu"),
            eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2, **chunk)
        for rid in rids:
            ref.submit(rid, prompts[rid], features=DS.X_test[rid])
        ref_done = ref.run(max_steps=400)
        for rid in rids:
            assert done[rid] == ref_done[rid]


def test_interleaved_drain_identical(both):
    """``drain_chunk`` interleaves the shards through bounded resumable
    runs; the merged done mask is the full drains'."""
    _, a = _routers(both, DENSE, gate=True, n_shards=2)
    _, b = _routers(both, DENSE, gate=True, n_shards=2)
    _gated_wave(a)
    _gated_wave(b)
    assert a.run(max_steps=200) == b.run(max_steps=200, drain_chunk=2)


def test_shared_prefix_router_parity(both):
    """Prefix sharing through a two-shard router: both waves (trie cold,
    then warm) bitwise the unshared router's, the same routing, and the
    fleet-wide sharing ratio above 1."""
    prompts = dict(enumerate(_prefix_prompts(n=10, seed=6)))

    def make(share):
        return _routers(both, dict(PAGED, share_prefix=share), gate=True,
                        n_shards=2, prefill_chunk=4)[1]

    plain, shared = make(False), make(True)
    done = {}
    for name, r in (("plain", plain), ("shared", shared)):
        for w in ("a", "b"):
            for rid, p in prompts.items():
                r.submit((w, rid), p, features=DS.X_test[rid])
            done[(name, w)] = dict(r.run(max_steps=500))
    assert done[("plain", "b")] == done[("shared", "b")]
    assert done[("plain", "a")] == done[("shared", "a")]
    assert shared.assigned == plain.assigned
    assert shared.prefix_tokens_per_page() > 1.0
    assert plain.prefix_tokens_per_page() == 1.0


def test_rebalance_spills_to_shallowest(both):
    """Zero depth slack levels four shards' queues, as in JAX."""
    jr, tr = _routers(both, DENSE, n_shards=4, rebalance_margin=0)
    for r in (jr, tr):
        for rid in range(16):
            r.submit(rid, rid + 1)
        r._route()
    depths = tr.queue_depths()
    assert max(depths) - min(depths) <= 1 and sum(depths) == 16
    assert depths == jr.queue_depths() and tr.assigned == jr.assigned


# ------------------------------------------------------------ admission
def test_router_submit_validates_prompts(both):
    """Oversized or multi-token-on-dense prompts fail at submit."""
    _, router = _routers(both, DENSE, gate=True)
    with pytest.raises(ValueError, match="paged"):
        router.submit(0, [1, 2, 3])
    _, router_p = _routers(both, PAGED, gate=True, max_tokens=4)
    with pytest.raises(ValueError, match="pages"):
        router_p.submit(0, list(range(1, 31)))  # 30 + 4 > a 32-token slot
    assert router_p.submit(1, list(range(1, 9)))


def test_router_empty_prompt_rejected(both):
    """An empty prompt fails at submit with its drop reason recorded, as
    in JAX."""
    jr, tr = _routers(both, DENSE, gate=True)
    for r in (jr, tr):
        with pytest.raises(ValueError, match="empty prompt"):
            r.submit("e", [])
        r.run(max_steps=10)
        assert r.drop_reasons["e"] == "empty-prompt"
        assert "e" in r.dropped and not r.pending
