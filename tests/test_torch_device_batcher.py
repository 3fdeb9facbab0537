"""The port's device batcher (``DeviceContinuousBatcher``, paged mode) on
the CPU: against the JAX package's, and against the port's own host
batcher and itself.

Smoke config ``qwen2-1.5b-smoke``; the JAX package's random-init weights
are carried across with ``arch.convert.params_from_arrays`` (see
``test_torch_serve.py``).  Against JAX: drops, drop reasons and every
page-pool decision bitwise, each stream equal up to its first JAX near tie
(top-2 margin within twice ``LOGIT_TOL`` of the logits' largest
magnitude).  The port against itself (the host batcher, chunk widths,
``sync_every``, resumed runs, prefix sharing): bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.nn import attention as TA  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from test_torch_serve import (DS, _engine, _jax_margins,  # noqa: E402,F401
                              _prefix_prompts, _prompts, _serve, both)

MAX_TOKENS = 4


def _device(both, chunk=4, sync_every=3, engine_kw=None, **kw):
    return TE.DeviceContinuousBatcher(
        _engine(both, **(engine_kw or {})), eos_token=kw.pop("eos", -1),
        max_tokens=kw.pop("max_tokens", MAX_TOKENS), sync_every=sync_every,
        prefill_chunk=chunk, **kw)


def _host(both, engine_kw=None, **kw):
    return TE.ContinuousBatcher(_engine(both, **(engine_kw or {})),
                                eos_token=kw.pop("eos", -1),
                                max_tokens=kw.pop("max_tokens", MAX_TOKENS),
                                **kw)


def _drain(cb, max_steps=3, rounds=300):
    """Bounded ``run()`` calls until nothing is left in flight."""
    for _ in range(rounds):
        cb.run(max_steps=max_steps)
        if not cb.queue and all(c is None for c in cb._carry):
            break
    return cb.done


# ------------------------------------------------------------ vs JAX
@pytest.mark.parametrize("share", [False, True])
def test_device_batcher_matches_jax_end_to_end(both, share):
    """JAX ``DeviceContinuousBatcher(paged, attn_impl="jnp")`` vs the
    port's, 8 requests with gate features, chunk 4, three steps a round
    (with sharing, 8 requests on a common 12-token prefix: in-wave cold
    sharing, copy-on-write tails): drops, drop reasons, ``pool.ref``,
    ``pool.stats`` and the cached pages bitwise; each stream equal to the
    JAX package's up to its first position whose JAX top-2 margin is
    within twice the logit tolerance."""
    jp, _, jg, _ = both
    jcfg = jax_smoke("qwen2-1.5b")
    prompts = _prefix_prompts() if share else _prompts()
    je = JE.ServeEngine(jcfg, jp, JE.ServeConfig(
        max_batch=4, cache_len=32, page_size=8, attn_impl="jnp",
        share_prefix=share), gate=jg)
    jcb = JE.DeviceContinuousBatcher(je, eos_token=-1, max_tokens=MAX_TOKENS,
                                     sync_every=3, prefill_chunk=4)
    tcb = _device(both, engine_kw=dict(share_prefix=share))
    dj, dt = _serve(jcb, prompts), _serve(tcb, prompts)
    assert tcb.dropped == jcb.dropped and tcb.drop_reasons == jcb.drop_reasons
    assert sorted(dt) == sorted(dj) and len(dj) >= 4
    np.testing.assert_array_equal(tcb.pool.ref, jcb.pool.ref)
    assert tcb.pool.stats == jcb.pool.stats
    assert tcb.pool.cached_pages() == jcb.pool.cached_pages()
    assert tcb._drains == jcb._drains
    if share:
        assert tcb.pool.stats["shared_tokens"] > 0
    compared = 0
    for rid, (margin, bound) in _jax_margins(jp, jcfg, prompts, dj,
                                             False).items():
        near = np.nonzero(margin <= bound)[0]
        upto = int(near[0]) if len(near) else len(dj[rid])
        assert dt[rid][:upto] == dj[rid][:upto], (rid, upto)
        assert len(dt[rid]) == len(dj[rid])
        compared += upto
    assert compared > 0


# --------------------------------------------------- port vs itself
@pytest.mark.parametrize("sampled", [False, True])
def test_device_equals_host_token_by_token(both, sampled):
    """``prefill_chunk=1``: the device batcher runs the host batcher's
    schedule: the same streams, drops, steps and refcounts, greedy and
    sampled (temperature, top-k and top-p)."""
    kw = dict(temperature=2.0, top_k=40, top_p=0.95) if sampled else {}
    prompts = _prompts(n=10)
    host = _host(both, engine_kw=kw)
    dev = _device(both, chunk=1, engine_kw=kw)
    done_h, done_d = _serve(host, prompts), _serve(dev, prompts)
    assert done_d == done_h and len(done_h) >= 4
    assert dev.dropped == host.dropped
    assert dev.drop_reasons == host.drop_reasons
    assert dev.steps == host.steps
    assert dev.steps_executed - dev.steps_wasted == dev.steps
    np.testing.assert_array_equal(dev.pool.ref, host.pool.ref)


@pytest.mark.parametrize("chunk", [3, 4, 8])
def test_chunked_prefill_equals_token_by_token(both, chunk):
    prompts = _prompts(n=10, max_len=20)
    ref = _serve(_device(both, chunk=1), prompts)
    dev = _device(both, chunk=chunk)
    assert _serve(dev, prompts) == ref
    assert any(len(p) > chunk for p in prompts)


@pytest.mark.parametrize("sync_every", [3, 16])
def test_sync_every_is_invariant(both, sync_every):
    """Streams, drops and steps with work do not depend on the round
    length; the steps run past the work are counted as wasted."""
    prompts = _prompts(n=10)
    one, many = _device(both, sync_every=1), _device(both,
                                                     sync_every=sync_every)
    assert _serve(one, prompts) == _serve(many, prompts)
    assert one.dropped == many.dropped and one.steps == many.steps
    assert one.steps_wasted == 0
    assert 0 <= many.steps_wasted < sync_every


def test_bounded_runs_resume_to_the_single_run(both):
    """``max_steps``-bounded runs carry in-flight slots (position, prompt,
    block table, partial stream) and re-enqueue un-admitted entries; the
    resumed schedule equals one uninterrupted run."""
    prompts = _prompts(n=10)
    ref = _device(both)
    done_ref = _serve(ref, prompts)
    dev = _device(both, sync_every=2)
    for rid, p in enumerate(prompts):
        dev.submit(rid, p, features=DS.X_test[rid])
    assert _drain(dev) == done_ref
    assert dev.dropped == ref.dropped and dev.steps == ref.steps
    np.testing.assert_array_equal(dev.pool.ref, ref.pool.ref)


def test_in_step_gate_eviction(both):
    """``pregate=False``: the fused gate's in-step verdict evicts the
    rejected requests before any token is recorded, in queue order, and
    their pages return to the pool."""
    eng = _engine(both)
    dev = TE.DeviceContinuousBatcher(eng, eos_token=-1, max_tokens=4,
                                     pregate=False, sync_every=4,
                                     prefill_chunk=4)
    _serve(dev, _prompts(n=10))
    keep = eng.admit(DS.X_test[:10])
    assert dev.dropped == np.where(~keep)[0].tolist()
    assert set(dev.drop_reasons.values()) == {"gate-reject"}
    assert sorted(dev.done) == np.where(keep)[0].tolist()
    assert dev._pfree.all()


def test_pool_oversubscription_stays_fifo(both):
    """A pool of 4 pages (two slots' demand) for 4 slots admits FIFO as
    pages free up, loses nothing and matches the host loop on the same
    pool."""
    prompts = _prompts(n=6)
    host = _host(both, engine_kw=dict(pages=4))
    dev = _device(both, engine_kw=dict(pages=4))
    done_h, done_d = _serve(host, prompts), _serve(dev, prompts)
    assert done_d == done_h
    assert sorted(done_d) == [r for r in range(6) if r not in dev.dropped]
    assert dev._pfree.all()


def test_eos_eviction_frees_pages(both):
    prompts = _prompts(n=8, max_len=6)
    probe = _serve(_device(both, max_tokens=6), prompts)
    eos = next(int(v[1]) for v in probe.values() if len(v) > 1)
    host = _host(both, eos=eos, max_tokens=6)
    dev = _device(both, eos=eos, max_tokens=6, sync_every=4)
    done_h, done_d = _serve(host, prompts), _serve(dev, prompts)
    assert done_d == done_h
    assert any(len(v) < 6 for v in done_d.values())
    assert dev._pfree.all() and (host.pool.ref == 0).all()


def test_share_prefix_two_waves_equal_unshared(both):
    """Wave 1 shares in-wave and fills the trie at drain; wave 2 shares
    the cached prefix (copy-on-write tails): both waves bitwise equal to
    an unshared batcher, and every held page is a cached one."""
    prompts = _prefix_prompts()
    plain = _device(both)
    shared = _device(both, engine_kw=dict(share_prefix=True))
    for wave in ("a", "b"):
        for rid, p in enumerate(prompts):
            plain.submit((wave, rid), p, features=DS.X_test[rid])
            shared.submit((wave, rid), p, features=DS.X_test[rid])
        assert dict(shared.run(600)) == dict(plain.run(600)), wave
    assert shared.pool.stats["shared_tokens"] > 0
    assert shared.pool.stats["cow_events"] > 0
    held = np.where(shared.pool.ref > 0)[0]
    assert set(held.tolist()) == shared.pool.cached_pages()


def test_share_prefix_bounded_runs_resume(both):
    prompts = _prefix_prompts(seed=5)
    ref = _device(both, engine_kw=dict(share_prefix=True))
    done_ref = _serve(ref, prompts)
    dev = _device(both, sync_every=2, engine_kw=dict(share_prefix=True))
    for rid, p in enumerate(prompts):
        dev.submit(rid, p, features=DS.X_test[rid])
    assert _drain(dev) == done_ref
    assert dev.dropped == ref.dropped and (dev.pool.ref >= 0).all()


def _cold_prompts():
    return [[5] * 17 + [i] for i in range(4)]  # two full pages shared


def test_in_wave_cold_sharing(both):
    """One wave, a cold pool: identical full-page prefixes share from
    wave 0 (readers wait on the writer's position), bitwise equal to the
    unshared pool, and every page drains clean."""
    def run(share):
        cb = _device(both, engine_kw=dict(pages=24, share_prefix=share))
        for rid, p in enumerate(_cold_prompts()):
            cb.submit(rid, p)
        return cb, dict(cb.run(max_steps=400))

    un, done_un = run(False)
    sh, done_sh = run(True)
    assert done_sh == done_un and len(done_un) == 4
    assert sh.pool.stats["shared_tokens"] > 0
    acct = sh.pool.page_accounting()
    assert acct["leaked"] == 0 and acct["live"] == 0


def test_in_wave_writer_death_replans_the_readers(both):
    """The wave's prefix writer passes admission, then its deadline
    evicts it at the first drain boundary, mid-prefill: its readers,
    waiting on it, idle the step out, are re-enqueued and re-planned cold,
    and finish with the streams of a run without it; nothing leaks."""
    prompts = _cold_prompts()
    ref = _device(both, engine_kw=dict(pages=24, share_prefix=False))
    for rid in (1, 2, 3):
        ref.submit(rid, prompts[rid])
    done_ref = dict(ref.run(max_steps=400))
    t = [0.0]

    def clock():  # one tick per call: submit 1, admission 2, drain 3
        t[0] += 1.0
        return t[0]

    cb = _device(both, sync_every=1, clock=clock,
                 engine_kw=dict(pages=24, share_prefix=True))
    cb.submit(0, prompts[0], deadline_s=1.5)
    for rid in (1, 2, 3):
        cb.submit(rid, prompts[rid])
    done = dict(cb.run(max_steps=400))
    assert cb.drop_reasons == {0: "deadline"}
    assert done == done_ref
    acct = cb.pool.page_accounting()
    assert acct["leaked"] == 0 and acct["live"] == 0


def test_deadline_and_queue_full_drops(both):
    """Admission-side and drain-side deadlines, queue-full drops and a
    retried queue-full entry: the other streams are unchanged, and the
    evicted slot frees its pages."""
    prompts = _prompts(n=6)
    ref = _serve(_device(both, engine_kw=dict(share_prefix=True)), prompts,
                 feats=False)
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    cb = _device(both, sync_every=1, max_queue=5, max_retries=0,
                 clock=clock, engine_kw=dict(share_prefix=True))
    assert cb.submit("late", [1, 2], deadline_s=0) is False
    cb.submit(0, prompts[0], deadline_s=2.5)  # admitted, then evicted
    for rid in range(1, 6):
        cb.submit(rid, prompts[rid])
    done = cb.run(max_steps=200)
    assert cb.drop_reasons == {"late": "deadline", 5: "queue-full",
                               0: "deadline"}
    assert done == {r: ref[r] for r in range(1, 5)}
    assert (cb.pool.ref == 0).sum() + cb.pool.n_cached == cb.pool.n
    retry = _device(both, max_queue=1, max_retries=2)
    for rid in range(2):
        retry.submit(rid, prompts[rid])
    assert len(retry._retry_q) == 1
    for _ in range(6):
        retry.run(max_steps=50)
    assert sorted(retry.done) == [0, 1] and not retry.dropped


def _snapshot(fs):
    """Every state tensor without its spare row, and the pools."""
    Nq, R = fs.Nq, fs.R
    N = fs.b.engine.scfg.n_pages
    spare = dict(pref=N, wdone=Nq)
    return {k: (v[: spare.get(k, R if k.startswith("out_") else len(v))]
                if v.dim() else v).clone()
            for k, v in fs.st.items() if k not in ("alive", "more")}, [
        p.clone() for p in fs.b._pages.pools()]


@pytest.mark.parametrize("share,kv_int8", [(False, False), (True, True)])
def test_no_work_step_is_the_identity(both, share, kv_int8):
    """With no active slot and nothing admissible, the fused step changes
    no state tensor (spare rows aside) and no pool, latches ``alive``
    False and does not count as a step with work, whatever stale slot
    state the buffers hold (here: a run stopped mid-flight)."""
    cb = _device(both, sync_every=1,
                 engine_kw=dict(share_prefix=share, kv_int8=kv_int8))
    for rid, p in enumerate(_prefix_prompts()):
        cb.submit(rid, p, features=DS.X_test[rid])
    cb.run(max_steps=3)
    (fs,) = cb._steps.values()
    fs.st["free"].fill_(True)
    fs.q["n"].copy_(fs.st["head"])
    before, pools = _snapshot(fs)
    assert before["pos"].any() and before["n_work"] > 0
    fs.st["alive"].fill_(True)
    fs.step()
    after, pools_after = _snapshot(fs)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    for a, b in zip(pools, pools_after):
        assert torch.equal(a, b)
    assert not fs.st["alive"]


# ---------------------------------------------------------- the write
def _nonzero_write(pool, ids, off, rows, n_pages):
    """The pool write as it was: filter the kept rows with ``nonzero``."""
    keep = torch.nonzero((ids >= 0) & (ids < n_pages)).squeeze(1)
    pool.index_put_((ids[keep].long(), off[keep].long()), rows[keep])


@pytest.mark.parametrize("case", ["mixed", "none_kept", "all_kept"])
@pytest.mark.parametrize("quantized", [False, True])
def test_sync_free_pool_write_equals_the_filtered_write(case, quantized):
    """``write_rows`` + ``_paged_write`` (no ``nonzero``: a dropped row
    repeats a kept row's write) leave the pools bitwise as the filtered
    write does, with rows dropped past the pool and below zero, with
    every row dropped and with none."""
    rng = np.random.default_rng(len(case) + quantized)
    N, page, KV, hd, B, C = 5, 4, 2, 8, 3, 4
    cells = rng.permutation(N * page)[: B * C]
    ids, off = cells // page, cells % page
    if case == "mixed":
        ids[[1, 5, 6]] = [N, N + 3, -1]
    elif case == "none_kept":
        ids[:] = N
    ids = torch.as_tensor(ids.reshape(B, C).astype(np.int32))
    off = torch.as_tensor(off.reshape(B, C).astype(np.int32))
    k = torch.as_tensor(rng.normal(0, 1, (B, C, KV, hd)),
                        dtype=torch.bfloat16)
    v = torch.as_tensor(rng.normal(0, 1, (B, C, KV, hd)),
                        dtype=torch.bfloat16)
    dt = torch.int8 if quantized else torch.bfloat16
    shapes = [(N, page, KV, hd)] * 2 + ([(N, page, KV, 1)] * 2
                                        if quantized else [])
    init = [torch.as_tensor(rng.normal(0, 1, s)).to(
        dt if s[-1] == hd else torch.float32) for s in shapes]
    kv = TA.PagedKV(*[t.clone() for t in init])
    TA._paged_write(kv.with_view(None, None, ids, off,
                                 TA.write_rows(ids, off, N, page)), k, v)
    want = [t.clone() for t in init]
    fid, foff = ids.reshape(-1), off.reshape(-1)
    rows = [k.reshape(-1, KV, hd), v.reshape(-1, KV, hd)]
    if quantized:
        (kq, ks), (vq, vs) = map(TA.quantize_kv_int8, rows)
        rows = [kq, vq, ks, vs]
    for pool, r in zip(want, rows):
        _nonzero_write(pool, fid, foff, r, N)
    for got, exp in zip(kv.pools(), want):
        assert torch.equal(got, exp)
    if case == "none_kept":
        assert all(torch.equal(a, b) for a, b in zip(kv.pools(), init))
