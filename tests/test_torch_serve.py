"""The port's paged serve path against the JAX package, on the CPU.

Smoke config ``qwen2-1.5b-smoke``; the JAX package's random-init weights
are carried across with ``arch.convert.params_from_arrays``, so both
packages compute the same function on the same numpy inputs.

Tolerances: at every position the float32 logits of the two packages lie
within ``LOGIT_TOL`` (3%) of the JAX logits' largest magnitude there: the
bf16 roundings of the two frameworks land in other places, and a one-ulp
bf16 difference early in the step grows through the layers.  Greedy tokens
are therefore equal wherever the JAX top-2 margin exceeds twice that bound,
and a served stream equals the JAX package's up to its first position with
a smaller margin.  Admission verdicts, drop reasons and page-pool
decisions, and the port against itself (prefix sharing, chunked vs
token-by-token), are bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import PlanterConfig as JaxPlanterConfig  # noqa: E402
from repro.core import plant as jax_plant  # noqa: E402
from repro.data import load_dataset  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve.pages import PagePool as JaxPagePool  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.arch.convert import params_from_arrays  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import PlanterConfig, plant  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.pages import PagePool  # noqa: E402

LOGIT_TOL = 0.03
DS = load_dataset("unsw", n=2000)
CFG = get_smoke_config("qwen2-1.5b")


@pytest.fixture(scope="module")
def both():
    """(JAX params, port params, JAX gate, port gate) on the smoke config."""
    jp = JM.init_params(jax_smoke("qwen2-1.5b"), jax.random.PRNGKey(0))
    tp = params_from_arrays(jax.tree.map(np.asarray, jp), CFG, "cpu")
    jg = jax_plant(JaxPlanterConfig(model="rf", size="S"), DS.X_train,
                   DS.y_train, DS.X_test).mapped
    tg = plant(PlanterConfig(model="rf", size="S", device="cpu"), DS.X_train,
               DS.y_train, DS.X_test).mapped
    return jp, tp, jg, tg


def _prompts(n=8, seed=0, max_len=8):
    """The JAX package's serve-test workload (``tests/test_serve.py``)."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 97, rng.integers(1, max_len))]
            for _ in range(n)]


def _prefix_prompts(n=8, seed=3, prefix_len=12, tail_max=6):
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, 97, prefix_len)]
    return [prefix + [int(t) for t in
                      rng.integers(1, 97, rng.integers(1, tail_max))]
            for _ in range(n)]


def _engine(both, gate=True, batch=4, cache_len=32, page_size=8, **kw):
    _, tp, _, tg = both
    scfg = TE.ServeConfig(max_batch=batch, cache_len=cache_len,
                          page_size=page_size, **kw)
    return TE.ServeEngine(CFG, tp, scfg, gate=tg if gate else None,
                          device="cpu")


def _serve(cb, prompts, feats=True, max_steps=600):
    for rid, p in enumerate(prompts):
        cb.submit(rid, p, features=DS.X_test[rid] if feats else None)
    return cb.run(max_steps=max_steps)


# ------------------------------------------------------------------ model
def _near_tie_bound(logits: np.ndarray) -> np.ndarray:
    """Per position (last axis = vocab): twice the logit tolerance, the
    top-2 margin under which a greedy token may flip."""
    return 2 * LOGIT_TOL * np.abs(logits).max(-1)


def _top2_margin(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_decode_step_matches_jax(both, C, kv_dtype):
    """Teacher-forced steps, every valid chunk position (``all_positions``):
    at each, ``max|logits - JAX| <= LOGIT_TOL * max|JAX logits|``, and the
    greedy tokens are equal wherever the JAX top-2 margin exceeds twice
    that bound."""
    jp, tp, _, _ = both
    jcfg = jax_smoke("qwen2-1.5b")
    jkv = JM.init_paged_kv(jcfg, 8, 8, kv_dtype=kv_dtype)
    tkv = TM.init_paged_kv(CFG, 8, 8, kv_dtype=kv_dtype, device="cpu")
    tbl = np.arange(8, dtype=np.int32).reshape(2, 4)
    toks = np.random.default_rng(C).integers(1, 97, (2, 20)).astype(np.int32)
    step = jax.jit(lambda p, kv, tb, pos, t, n: JM.paged_decode_step(
        p, kv, tb, pos, t, n, jcfg, all_positions=True))
    lj_rows, lt_rows = [], []
    for t0 in range(0, 20, C):
        pos = np.full((2,), t0, np.int32)
        n = np.array([C, max(1, C - 1)], np.int32)  # slot 1 pads its chunk
        lj, jkv = step(jp, jkv, jnp.asarray(tbl), jnp.asarray(pos),
                       jnp.asarray(toks[:, t0:t0 + C]), jnp.asarray(n))
        lt, tkv = TM.paged_decode_step(
            tp, tkv, torch.as_tensor(tbl), torch.as_tensor(pos),
            torch.as_tensor(toks[:, t0:t0 + C]), torch.as_tensor(n), CFG,
            all_positions=True)
        lj = np.asarray(lj)
        assert lt.dtype == torch.float32 and lt.shape == lj.shape
        for b in range(2):  # the valid chunk positions only
            lj_rows.append(lj[b, : n[b]])
            lt_rows.append(lt[b, : n[b]].numpy())
    lj, lt = np.concatenate(lj_rows), np.concatenate(lt_rows)
    assert len(lj) == 40 - (20 // C if C > 1 else 0)
    diff = np.abs(lt - lj).max(-1)
    assert (diff <= LOGIT_TOL * np.abs(lj).max(-1)).all(), diff.max()
    clear = _top2_margin(lj) > _near_tie_bound(lj)
    np.testing.assert_array_equal(lt.argmax(-1)[clear], lj.argmax(-1)[clear])


def test_all_positions_row_equals_the_narrowed_logits(both):
    _, tp, _, _ = both
    tbl = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    toks = torch.as_tensor(np.random.default_rng(1).integers(1, 97, (2, 5)),
                           dtype=torch.int32)
    n = torch.tensor([5, 3], dtype=torch.int32)
    pos = torch.tensor([0, 2], dtype=torch.int32)
    def step(**kw):
        return TM.paged_decode_step(tp, TM.init_paged_kv(CFG, 8, 8, "bf16",
                                                         "cpu"),
                                    tbl, pos, toks, n, CFG, **kw)[0]

    la, ln = step(all_positions=True), step()
    assert torch.equal(la[0, 4], ln[0]) and torch.equal(la[1, 2], ln[1])
    g = step(sample_greedy=True)
    assert g.dtype == torch.int32 and torch.equal(g, ln.argmax(-1).int())


def test_params_from_arrays_are_the_jax_compute_copies(both):
    jp, tp, _, _ = both
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["head"].dtype == torch.bfloat16
    assert tp["layers"][1]["ln1"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["layers"][1]["mlp"]["w_up"].float().numpy(),
        np.asarray(jp["layers"]["mlp"]["w_up"][1].astype(jnp.bfloat16)
                   .astype(jnp.float32)))
    np.testing.assert_array_equal(
        tp["head"].float().numpy(),
        np.asarray(jp["head"].astype(jnp.bfloat16).astype(jnp.float32)))


def test_port_init_params_shapes_and_seed(monkeypatch):
    a = TM.init_params(CFG, 3, "cpu")
    b = TM.init_params(CFG, 3, "cpu")
    assert len(a["layers"]) == CFG.n_layers
    assert a["embed"].shape == (CFG.vocab_padded, CFG.d_model)
    assert a["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert torch.equal(a["head"], b["head"])
    assert not torch.equal(a["head"], TM.init_params(CFG, 4, "cpu")["head"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TM.init_params(CFG),
                 lambda: TM.init_paged_kv(CFG, 4, 4)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ------------------------------------------------------------ the slice
def _jax_margins(jp, jcfg, prompts, done, kv_int8):
    """Teacher-force the JAX package's served streams through its own
    model in one chunked call: per request, (top-2 margin, near-tie
    bound) at each position that predicts a generated token."""
    rids = sorted(done)
    seqs = [list(prompts[r]) + list(done[r]) for r in rids]
    B, L, page = len(seqs), max(len(x) for x in seqs), 8
    n_ps = -(-L // page)
    toks = np.zeros((B, L), np.int32)
    for b, x in enumerate(seqs):
        toks[b, : len(x)] = x
    kv = JM.init_paged_kv(jcfg, B * n_ps, page,
                          kv_dtype="int8" if kv_int8 else "bf16")
    logits, _ = JM.paged_decode_step(
        jp, kv, jnp.arange(B * n_ps, dtype=jnp.int32).reshape(B, n_ps),
        jnp.zeros((B,), jnp.int32), jnp.asarray(toks),
        jnp.asarray([len(x) for x in seqs], jnp.int32), jcfg,
        all_positions=True)
    logits = np.asarray(logits)
    out = {}
    for b, r in enumerate(rids):
        P = len(prompts[r])
        lg = logits[b, P - 1: P - 1 + len(done[r])]
        assert (lg.argmax(-1) == np.asarray(done[r])).all()  # its stream
        out[r] = (_top2_margin(lg), _near_tie_bound(lg))
    return out


@pytest.mark.parametrize("kv_int8", [False, True])
def test_host_batcher_matches_jax_end_to_end(both, kv_int8):
    """JAX ``ServeEngine(paged, attn_impl="jnp")`` + ``ContinuousBatcher``
    vs the port's, 8 requests with gate features: admission verdicts, drop
    reasons and the page pool's decisions bitwise; each stream equal to the
    JAX package's up to its first position whose JAX top-2 margin is
    within twice the logit tolerance (the margins from the JAX model re-run
    teacher-forced).  On this workload 12 of the 24 tokens of the 6 admitted
    requests come before their request's first such near tie and are
    compared, with bf16 and with int8 pools."""
    jp, tp, jg, tg = both
    jcfg = jax_smoke("qwen2-1.5b")
    prompts = _prompts()
    je = JE.ServeEngine(jcfg, jp, JE.ServeConfig(
        max_batch=4, cache_len=32, page_size=8, attn_impl="jnp",
        kv_int8=kv_int8), gate=jg)
    jcb = JE.ContinuousBatcher(je, eos_token=-1, max_tokens=4)
    tcb = TE.ContinuousBatcher(_engine(both, kv_int8=kv_int8), eos_token=-1,
                               max_tokens=4)
    dj, dt = _serve(jcb, prompts), _serve(tcb, prompts)
    np.testing.assert_array_equal(tcb.engine.admit(DS.X_test[:256]),
                                  je.admit(DS.X_test[:256]))
    assert tcb.dropped == jcb.dropped and tcb.drop_reasons == jcb.drop_reasons
    assert sorted(dt) == sorted(dj) and len(dj) >= 4
    np.testing.assert_array_equal(tcb.pool.ref, jcb.pool.ref)
    assert tcb.pool.stats == jcb.pool.stats
    assert tcb.pool.cached_pages() == jcb.pool.cached_pages()
    assert tcb.max_live == jcb.max_live and tcb._drains == jcb._drains
    compared = 0
    for rid, (margin, bound) in _jax_margins(jp, jcfg, prompts, dj,
                                             kv_int8).items():
        near = np.nonzero(margin <= bound)[0]
        upto = int(near[0]) if len(near) else len(dj[rid])
        assert dt[rid][:upto] == dj[rid][:upto], (rid, upto)
        assert len(dt[rid]) == len(dj[rid])
        compared += upto
    assert sum(len(t) for t in dj.values()) == 24 and compared == 12, compared


def test_share_prefix_streams_equal_unshared(both):
    prompts = _prefix_prompts()
    plain = TE.ContinuousBatcher(_engine(both), eos_token=-1, max_tokens=4)
    shared = TE.ContinuousBatcher(_engine(both, share_prefix=True),
                                  eos_token=-1, max_tokens=4)
    done_p, done_s = _serve(plain, prompts), _serve(shared, prompts)
    assert done_s == done_p and len(done_p) > 0
    assert shared.pool.stats["shared_tokens"] > 0
    assert shared.pool.stats["cow_events"] > 0
    held = np.where(shared.pool.ref > 0)[0]
    assert set(held.tolist()) == shared.pool.cached_pages()


def test_int8_share_prefix_streams_equal_unshared(both):
    prompts = _prefix_prompts(seed=7)
    plain = TE.ContinuousBatcher(_engine(both, kv_int8=True), eos_token=-1,
                                 max_tokens=4)
    shared = TE.ContinuousBatcher(_engine(both, kv_int8=True,
                                          share_prefix=True),
                                  eos_token=-1, max_tokens=4)
    for wave in ("a", "b"):
        for rid, p in enumerate(prompts):
            plain.submit((wave, rid), p)
            shared.submit((wave, rid), p)
        assert dict(shared.run(600)) == dict(plain.run(600))
    assert shared.pool.stats["shared_tokens"] > 0


def test_engine_chunked_prefill_equals_token_by_token(both):
    """``step_paged`` with C = 4 gives the greedy tokens (and the pools)
    of four C = 1 steps, bitwise: the JAX package's own gate."""
    e1, e4 = _engine(both, gate=False), _engine(both, gate=False)
    B, n_ps = 4, e1.scfg.pages_per_slot
    tbl = np.arange(B * n_ps, dtype=np.int32).reshape(B, n_ps)
    toks = np.random.default_rng(2).integers(1, 250, (B, 16)).astype(np.int32)
    n4 = np.array([4, 4, 3, 4], np.int32)
    for t0 in range(0, 16, 4):
        pos = np.full(B, t0, np.int32)
        g4 = e4.step_paged(toks[:, t0:t0 + 4], tbl, pos, n4)
        for j in range(4):
            g1 = e1.step_paged(toks[:, t0 + j:t0 + j + 1], tbl, pos + j,
                               (j < n4).astype(np.int32))
            for b in np.where(n4 == j + 1)[0]:
                assert g1[b] == g4[b], (t0, j, b)
    for a, b in zip(e1.paged_kv.pools(), e4.paged_kv.pools()):
        assert torch.equal(a, b)


def test_sampled_streams_are_a_function_of_the_request(both):
    """temperature > 0: streams depend on (seed, token index) only, not on
    the batch size; they differ from greedy."""
    prompts = _prompts(seed=4)
    kw = dict(temperature=2.0, top_k=40)
    runs = [_serve(TE.ContinuousBatcher(_engine(both, gate=False, batch=b,
                                                **kw),
                                        eos_token=-1, max_tokens=4),
                   prompts, feats=False) for b in (2, 4)]
    assert runs[0] == runs[1]
    greedy = _serve(TE.ContinuousBatcher(_engine(both, gate=False),
                                         eos_token=-1, max_tokens=4),
                    prompts, feats=False)
    assert runs[0] != greedy


def test_padded_vocab_argmax_quarantines_only_its_slot():
    """A greedy token in the padded vocab columns (vocab 200 padded to 256,
    random-init like the JAX package's) quarantines exactly its request,
    as the JAX batcher does; the others are served and no page is
    stranded."""
    import dataclasses

    cfg = dataclasses.replace(CFG, vocab_size=200)
    assert cfg.vocab_padded == 256
    engine = TE.ServeEngine(cfg, TM.init_params(cfg, 0, "cpu"),
                            TE.ServeConfig(max_batch=4, cache_len=32,
                                           page_size=8), device="cpu")
    cb = TE.ContinuousBatcher(engine, eos_token=-1, max_tokens=6)
    done = _serve(cb, _prompts(n=12, seed=5), feats=False)
    quarantined = [r for r, why in cb.drop_reasons.items()
                   if why == "quarantined"]
    assert quarantined and len(done) + len(quarantined) == 12
    assert all(max(t) < 200 and len(t) == 6 for t in done.values())
    assert (cb.pool.ref == 0).all()


def test_deadline_and_queue_full_drops(both):
    cb = TE.ContinuousBatcher(_engine(both, gate=False), eos_token=-1,
                              max_tokens=4, max_queue=2)
    assert cb.submit("late", [1, 2], deadline_s=0) is False
    for rid in range(3):
        cb.submit(rid, [5, 6, 7])
    assert cb.drop_reasons == {"late": "deadline", 2: "queue-full"}
    assert sorted(cb.run(200)) == [0, 1]
    with pytest.raises(ValueError, match="empty prompt"):
        cb.submit("empty", [])
    assert cb.drop_reasons["empty"] == "empty-prompt"


# ------------------------------------------------------------------ pool
@pytest.mark.parametrize("seed", range(6))
def test_page_pool_equals_the_jax_pool(seed):
    """The copied allocator makes the JAX package's decisions: the same
    random reserve/release interleaving gives the same tables, refcounts,
    trie and stats, and keeps the refcount invariant."""
    rng = np.random.default_rng(seed)
    pools = [P(12, 4, share_prefix=True) for P in (PagePool, JaxPagePool)]
    live = [[], []]
    for p in pools:
        p.begin_wave()
    for _ in range(60):
        op = int(rng.integers(0, 3))
        if op <= 1 or not live[0]:
            prompt = [int(t) for t in rng.integers(0, 5,
                                                   int(rng.integers(1, 14)))]
            res = [p.reserve(prompt, 3) for p in pools]
            assert (res[0] is None) == (res[1] is None)
            if res[0] is not None:
                assert res[0].tbl == res[1].tbl and res[0].cow == res[1].cow
                for i in range(2):
                    live[i].append((res[i], prompt))
        else:
            k = int(rng.integers(0, len(live[0])))
            for i, p in enumerate(pools):
                p.release(*live[i].pop(k))
        if rng.random() < 0.2:
            for p in pools:
                p.begin_wave()
        np.testing.assert_array_equal(pools[0].ref, pools[1].ref)
        counts = np.zeros(12, np.int64)
        for res, _ in live[0]:
            np.add.at(counts, np.asarray(res.tbl, np.int64), 1)
        for pid in pools[0].cached_pages():
            counts[pid] += 1
        np.testing.assert_array_equal(counts, pools[0].ref)
    assert pools[0].cached_pages() == pools[1].cached_pages()
    assert pools[0].stats == pools[1].stats
    for i, p in enumerate(pools):
        for ent in live[i]:
            p.release(*ent)
    assert pools[0].free_count() + pools[0].n_cached == 12


def test_page_demand_and_validation_match_jax():
    for args in ((16, 1, 32), (16, 17, 15), (8, 64, 0)):
        assert TE.page_demand(TE.ServeConfig(page_size=args[0],
                                             cache_len=256), *args[1:]) == \
            JE.page_demand(JE.ServeConfig(page_size=args[0], cache_len=256),
                           *args[1:])
    scfg = TE.ServeConfig(page_size=8, cache_len=32)
    with pytest.raises(ValueError, match="pages"):
        TE.validate_prompt(scfg, list(range(30)), 8)
    assert TE.validate_prompt(scfg, 7, 4) == [7]
    assert TE._default_seed(("a", 3)) == JE._default_seed(("a", 3))


def test_serve_config_validates_attn_impl():
    assert TE.ServeConfig(attn_impl="cuda").attn_impl == "cuda"
    for bad in ("jnp", "pallas", "triton"):
        with pytest.raises(ValueError, match="attn_impl"):
            TE.ServeConfig(attn_impl=bad)
    with pytest.raises(ValueError, match="temperature"):
        TE.ServeConfig(top_k=5)


# --------------------------------------------------------------- launcher
def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--smoke", "--device", "cpu", "--continuous",
                       "--batcher", "host", "--page-size", "16",
                       "--requests", "6", "--tokens", "3", "--prompt-len",
                       "5", "--kv-int8", "--share-prefix",
                       "--shared-prefix-len", "16"])
    out = capsys.readouterr().out
    assert "auto -> torch on cpu" in out and "[host] served" in out
    assert len(done) > 0 and all(len(t) == 3 for t in done.values())


def test_launcher_serves_the_device_batcher_on_cpu(capsys):
    """``--continuous --page-size 16`` (``--batcher device``, the default)
    serves through the fused step, with prefix sharing."""
    from repro_torch.launch import serve

    done = serve.main(["--smoke", "--device", "cpu", "--continuous",
                       "--page-size", "16", "--requests", "6", "--tokens",
                       "3", "--prompt-len", "12", "--share-prefix",
                       "--shared-prefix-len", "16", "--sync-every", "4",
                       "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "[device] served" in out and "wasted" in out
    assert len(done) > 0 and all(len(t) == 3 for t in done.values())


def test_launcher_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--continuous", "--batcher", "host",
                    "--page-size", "16"])



@pytest.mark.parametrize("argv,item", [
    (["--mesh", "auto"], "item 16"), (["--router"], "item 16")])
def test_launcher_modes_not_ported_raise(argv, item, monkeypatch):
    """A serve mesh over more than one physical card (``--mesh auto``, the
    default of ``--router``, with four cards visible) waits for ROADMAP
    queue A item 16 (placement over several cards), before anything is
    built."""
    from repro_torch.launch import serve

    monkeypatch.setattr(serve, "device_count", lambda dev: 4)
    with pytest.raises(NotImplementedError, match=item):
        serve.main(["--smoke", "--device", "cpu", *argv])


@pytest.mark.parametrize("cards,want", [(1, 1), (4, None)])
def test_auto_mesh_spreads_every_visible_card(monkeypatch, cards, want):
    """``--mesh auto`` is one data shard over every visible device, as
    the JAX ``make_serve_mesh``: one shard of one chip on one device, and
    more than one card needs placement over several cards (item 16); a
    malformed spec is a ValueError."""
    from repro_torch.launch import serve

    cpu = torch.device("cpu")
    monkeypatch.setattr(serve, "device_count", lambda dev: cards)
    if want is None:
        with pytest.raises(NotImplementedError, match="item 16"):
            serve.serve_mesh("auto", cpu)
    else:
        mesh = serve.serve_mesh("auto", cpu)
        assert dict(mesh.shape) == {"data": want, "model": 1}
    for bad in ("two-by-four", "0x2", "2x"):
        with pytest.raises(ValueError, match="DATAxMODEL"):
            serve.serve_mesh(bad, cpu)


@pytest.mark.parametrize("argv", [
    ["--router"], ["--mesh", "1x1"], ["--mesh", "auto"],
    ["--router", "--rebalance-margin", "2"]])
def test_launcher_routes_on_one_device(argv, capsys):
    """``--router`` and a one-device ``--mesh`` serve through the mesh-less
    router, one shard, as the JAX launcher's ``auto`` mesh on one device;
    the same streams as the lone device batcher."""
    from repro_torch.launch import serve

    common = ["--smoke", "--device", "cpu", "--requests", "8", "--tokens",
              "3", "--page-size", "16", "--prompt-len", "12"]
    routed = serve.main(common + argv)
    out = capsys.readouterr().out
    assert "router: 1 shard(s)" in out and "[router] served" in out
    assert routed == serve.main(common + ["--continuous"])


@pytest.mark.parametrize("argv,tag", [
    ([], "generated 32 tokens"),
    (["--continuous"], "[device] served"),
    (["--continuous", "--batcher", "host"], "[host] served")])
def test_launcher_serves_the_dense_modes_on_cpu(argv, tag, capsys):
    """The launcher's default (one fixed ``generate()`` batch) and
    ``--continuous`` without ``--page-size`` (both batchers) serve over
    the dense ring cache."""
    from repro_torch.launch import serve

    out = serve.main(["--smoke", "--device", "cpu", "--requests", "12",
                      "--tokens", "4", *argv])
    text = capsys.readouterr().out
    assert tag in text
    if argv:
        assert len(out) > 0 and all(len(t) == 4 for t in out.values())
    else:
        assert out.shape == (8, 4)


def test_launcher_refuses_paged_only_flags_on_the_dense_cache():
    from repro_torch.launch import serve

    for argv in (["--prompt-len", "4"], ["--spec-k", "2"]):
        with pytest.raises(SystemExit):
            serve.main(["--smoke", "--device", "cpu", "--continuous", *argv])


def test_not_ported_paths_raise(both):
    _, tp, _, _ = both
    dense = TE.ServeEngine(CFG, tp, TE.ServeConfig(max_batch=2), device="cpu")
    for call in (lambda: dense.paged_kv,
                 lambda: dense.step_paged(np.zeros((2, 1)), np.zeros((2, 1)),
                                          np.zeros(2), np.ones(2))):
        with pytest.raises(ValueError, match="page_size"):
            call()
    from repro_torch.configs import get_config
    with pytest.raises(ValueError, match="dense attention stacks only"):
        TM.init_paged_kv(get_config("xlstm-125m"), 4, 4)
