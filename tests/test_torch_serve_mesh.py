"""Serving over a mesh of logical chips on the CPU: the port's
``ServeEngine(mesh=, tp_params=)``, ``DeviceContinuousBatcher(mesh=)``,
``ShardedServe(mesh)`` over data submeshes and ``launch.serve --mesh``.

The port against itself, bitwise: an engine or a batcher on a mesh serves
what the unplaced one serves, and a router on a ``DATAxMODEL`` mesh serves
what the mesh-less router with ``n_shards = DATA`` serves, with or without
``tp_params`` (ROADMAP C.19: on one device a placement holds each leaf
whole).  The mesh tests of ``tests/test_router.py`` are mirrored on 2x2
logical chips.

Against the JAX package, under the near-tie rule of ``test_torch_serve.py``
(a served stream equals the JAX one up to its first position whose JAX
top-2 margin is within twice the logit tolerance): in process, the JAX
mesh-less router with ``n_shards = 2``; in one subprocess with four fake
XLA devices, the JAX router on a 2x2 mesh, replicated and with
``tp_params=True``, whose streams are compared up to their first near tie
and, for the TP run, up to its first departure from the JAX replicated
run (its row-parallel psums reassociate).  The outcome is equal:
``assigned``, ``dropped``, ``drop_reasons`` and the served requests.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import router as JR  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import data_submeshes, make_serve_mesh  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import router as TR  # noqa: E402
from test_torch_serve import (CFG, DS, _near_tie_bound,  # noqa: E402,F401
                              _prefix_prompts, _top2_margin, both)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_TOKENS = 3
DENSE = dict(max_batch=4, cache_len=32)
PAGED = dict(max_batch=4, cache_len=32, page_size=8)


def _mesh(spec="2x2"):
    d, _, m = spec.partition("x")
    return make_serve_mesh(spec, chips=int(d) * int(m), device="cpu")


def _router(both, scfg, mesh=None, gate=True, **kw):
    _, tp, _, tg = both
    kw = dict(dict(eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2), **kw)
    return TR.ShardedServe(CFG, tp, TE.ServeConfig(**scfg), mesh,
                           gate=tg if gate else None, device="cpu", **kw)


def _batcher(both, scfg, mesh=None, tp_params=False, **kw):
    _, tp, _, tg = both
    eng = TE.ServeEngine(CFG, tp, TE.ServeConfig(**scfg), gate=tg,
                         mesh=mesh, tp_params=tp_params, device="cpu")
    return TE.DeviceContinuousBatcher(eng, eos_token=-1,
                                      max_tokens=MAX_TOKENS, sync_every=2,
                                      **kw)


def _paged_prompts(n=10, seed=2):
    rng = np.random.default_rng(seed)
    return {rid: [int(t) for t in rng.integers(1, 97, rng.integers(1, 8))]
            for rid in range(n)}


def _dense_prompts(n=10, seed=0):
    rng = np.random.default_rng(seed)
    return {rid: [int(rng.integers(1, 100))] for rid in range(n)}


def _serve(cb, prompts, max_steps=400):
    for rid, p in prompts.items():
        cb.submit(rid, p, features=DS.X_test[rid])
    return cb.run(max_steps=max_steps)


def _per_shard_parity(both, router, prompts, scfg, done, **kw):
    """FIFO within each shard, and each shard's streams a fresh lone
    device batcher's, fed that shard's requests in order."""
    admitted = [r for r in prompts if r not in router.dropped]
    assert sorted(done) == sorted(admitted)
    assert sum(len(a) for a in router.assigned) == len(admitted)
    for rids in router.assigned:
        assert rids == sorted(rids)
        ref = _batcher(both, scfg, **kw)
        ref_done = _serve(ref, {r: prompts[r] for r in rids})
        for rid in rids:
            assert done[rid] == ref_done[rid]


# ------------------------------------------------------------- the mesh
def test_mesh_helpers():
    """``tests/test_router.py::test_mesh_helpers`` on logical chips: a
    malformed spec is a ValueError, too few chips a RuntimeError, ``auto``
    one shard over every device, and a 2x2 mesh two 1x2 slices."""
    with pytest.raises(ValueError):
        make_serve_mesh("not-a-mesh", device="cpu")
    with pytest.raises(RuntimeError):
        make_serve_mesh("3x2", chips=4, device="cpu")
    subs = data_submeshes(make_serve_mesh("auto", device="cpu"))
    assert len(subs) == 1 and int(subs[0].shape["model"]) == 1
    subs = data_submeshes(_mesh())
    assert [s.device_ids() for s in subs] == [[0, 1], [2, 3]]
    assert all(dict(s.shape) == {"data": 1, "model": 2} for s in subs)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tp_params", [False, True])
def test_engine_on_a_mesh_is_bitwise_unplaced(both, paged, tp_params):
    """An engine on a 1x2 slice, replicated or with ``tp_params``, holds
    the same params tensors, and its host-driven step gives the unplaced
    engine's bits (logits, or the paged step's tokens)."""
    _, tp, _, tg = both
    scfg = TE.ServeConfig(**(PAGED if paged else DENSE))
    sub = data_submeshes(_mesh())[0]
    plain = TE.ServeEngine(CFG, tp, scfg, gate=tg, device="cpu")
    placed = TE.ServeEngine(CFG, tp, scfg, gate=tg, mesh=sub,
                            tp_params=tp_params, device="cpu")
    assert placed.mesh is sub and placed.tp_params == tp_params
    assert placed.params["layers"][0]["mixer"]["wq"] is \
        tp["layers"][0]["mixer"]["wq"]
    rng = np.random.default_rng(5)
    for _ in range(3):
        if paged:
            toks = rng.integers(1, 97, (4, 4)).astype(np.int32)
            tbl = np.arange(16, dtype=np.int32).reshape(4, 4)
            pos = np.zeros(4, np.int32)
            n = np.array([4, 3, 2, 1], np.int32)
            assert np.array_equal(plain.step_paged(toks, tbl, pos, n),
                                  placed.step_paged(toks, tbl, pos, n))
        else:
            toks = rng.integers(1, 97, (4, 1)).astype(np.int32)
            a, la = plain.step(toks, DS.X_test[:4])
            b, lb = placed.step(toks, DS.X_test[:4])
            assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_mesh_on_another_device_raises(both):
    """A placement moves no tensor: a mesh whose chips live elsewhere is
    refused by the engine, the batcher and the router."""
    _, tp, _, _ = both
    elsewhere = SH.Mesh(np.arange(4).reshape(2, 2), ("data", "model"),
                        "meta")
    scfg = TE.ServeConfig(**PAGED)
    with pytest.raises(ValueError, match="mesh"):
        TE.ServeEngine(CFG, tp, scfg, mesh=elsewhere, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        TE.DeviceContinuousBatcher(
            TE.ServeEngine(CFG, tp, scfg, device="cpu"), mesh=elsewhere)
    with pytest.raises(ValueError, match="mesh"):
        TR.ShardedServe(CFG, tp, scfg, elsewhere, device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_device_batcher_on_a_mesh_is_bitwise_unplaced(both, paged):
    """The device batcher takes its engine's mesh (or one given to it, here
    the whole 2x2 mesh over an unplaced engine): the same streams and
    drops as the unplaced batcher, bitwise."""
    scfg = PAGED if paged else DENSE
    chunk = dict(prefill_chunk=4) if paged else {}
    prompts = _paged_prompts() if paged else _dense_prompts()
    sub = data_submeshes(_mesh())[1]
    plain = _batcher(both, scfg, **chunk)
    own = _batcher(both, scfg, mesh=sub, tp_params=True, **chunk)
    given = _batcher(both, scfg, **chunk)
    given = TE.DeviceContinuousBatcher(given.engine, eos_token=-1,
                                       max_tokens=MAX_TOKENS, sync_every=2,
                                       mesh=_mesh(), **chunk)
    assert own.mesh is sub and given.mesh.size == 4
    done = _serve(plain, prompts)
    assert done and plain.dropped
    for cb in (own, given):
        assert _serve(cb, prompts) == done
        assert cb.dropped == plain.dropped
        assert cb.drop_reasons == plain.drop_reasons


# ------------------------------------------- tests/test_router.py on 2x2
def test_multi_shard_fifo_and_per_shard_parity(both):
    """``test_router.py:82``: FIFO within each shard, each shard's streams a
    lone device batcher's."""
    router = _router(both, DENSE, _mesh())
    prompts = _dense_prompts()
    done = _serve(router, prompts, 200)
    assert router.n_shards == 2 and all(router.assigned)
    _per_shard_parity(both, router, prompts, DENSE, done)


def test_interleaved_drain_identical(both):
    """``test_router.py:110``: ``drain_chunk`` interleaves the shards; the
    merged done mask is the full drains'."""
    a, b = _router(both, DENSE, _mesh()), _router(both, DENSE, _mesh())
    prompts = _dense_prompts()
    for r in (a, b):
        for rid, p in prompts.items():
            r.submit(rid, p, features=DS.X_test[rid])
    assert a.run(max_steps=200) == b.run(max_steps=200, drain_chunk=2)


def test_paged_vs_dense_parity_on_mesh(both):
    """``test_router.py:153``: one wave of single-token prompts, paged
    decode on the mesh is each shard's dense device batcher, bitwise."""
    router = _router(both, PAGED, _mesh())
    toks = {rid: [rid + 3] for rid in range(4)}
    done = _serve(router, toks, 200)
    for rids in router.assigned:
        ref = _batcher(both, DENSE)
        ref_done = _serve(ref, {r: toks[r] for r in rids}, 200)
        for rid in rids:
            assert done[rid] == ref_done[rid]


def test_paged_multi_shard_per_shard_parity(both):
    """``test_router.py:181``: chunked prefill through a 2x2 mesh; FIFO and
    per-shard parity with a lone paged device batcher."""
    router = _router(both, PAGED, _mesh(), prefill_chunk=4)
    prompts = _paged_prompts()
    done = _serve(router, prompts)
    _per_shard_parity(both, router, prompts, PAGED, done, prefill_chunk=4)


def test_shared_prefix_router_parity_multi_shard(both):
    """``test_router.py:270``: prefix sharing on the 2x2 mesh, both waves
    bitwise the unshared router's, the same routing, ratio above 1."""
    prompts = dict(enumerate(_prefix_prompts(n=10, seed=6)))
    plain = _router(both, dict(PAGED, share_prefix=False), _mesh(),
                    prefill_chunk=4)
    shared = _router(both, dict(PAGED, share_prefix=True), _mesh(),
                     prefill_chunk=4)
    done = {}
    for name, r in (("plain", plain), ("shared", shared)):
        for w in ("a", "b"):
            for rid, p in prompts.items():
                r.submit((w, rid), p, features=DS.X_test[rid])
            done[(name, w)] = dict(r.run(max_steps=500))
    assert done[("plain", "a")] == done[("shared", "a")]
    assert done[("plain", "b")] == done[("shared", "b")]
    assert shared.assigned == plain.assigned
    assert shared.prefix_tokens_per_page() > 1.0


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tp_params", [False, True])
def test_mesh_router_is_the_meshless_router(both, paged, tp_params):
    """A router on the 2x2 mesh (two 1x2 slices), replicated or with
    ``tp_params``, is the mesh-less router with two shards bit for bit:
    streams, routing, drops."""
    scfg = PAGED if paged else DENSE
    chunk = dict(prefill_chunk=4) if paged else {}
    prompts = _paged_prompts() if paged else _dense_prompts()
    meshed = _router(both, scfg, _mesh(), tp_params=tp_params, **chunk)
    plain = _router(both, scfg, n_shards=2, **chunk)
    assert meshed.mesh.size == 4 and len(meshed.submeshes) == 2
    assert all(e.tp_params == tp_params for e in meshed.engines)
    assert _serve(meshed, prompts) == _serve(plain, prompts)
    assert meshed.assigned == plain.assigned
    assert meshed.dropped == plain.dropped
    assert meshed.drop_reasons == plain.drop_reasons


def test_launcher_serves_a_mesh_of_logical_chips(capsys):
    """``launch.serve --mesh 2x2``: two shards over four logical chips,
    each a 1x2 slice, every request served once (the streams are the
    mesh-less router's: ``test_mesh_router_is_the_meshless_router``)."""
    from repro_torch.launch import serve

    done = serve.main(["--smoke", "--device", "cpu", "--requests", "8",
                       "--tokens", "3", "--page-size", "16", "--prompt-len",
                       "12", "--gate", "none", "--mesh", "2x2"])
    out = capsys.readouterr().out
    assert "router: 2 shard(s) over mesh {'data': 2, 'model': 2}" in out
    assert "[router] served 8 requests" in out
    assert sorted(done) == list(range(8))
    assert all(len(t) == 3 for t in done.values())


# ------------------------------------------------------------ vs JAX
def _near_tie_upto(jp, prompts, done):
    """Per request, the stream's length before its first JAX near tie
    (teacher-forced through the JAX model, one chunked call), checking the
    JAX argmax is the stream up to there."""
    jcfg = jax_smoke("qwen2-1.5b")
    rids = sorted(done)
    seqs = [list(prompts[r]) + list(done[r]) for r in rids]
    B, L, page = len(seqs), max(len(x) for x in seqs), 8
    n_ps = -(-L // page)
    toks = np.zeros((B, L), np.int32)
    for b, x in enumerate(seqs):
        toks[b, : len(x)] = x
    logits, _ = JM.paged_decode_step(
        jp, JM.init_paged_kv(jcfg, B * n_ps, page),
        jnp.arange(B * n_ps, dtype=jnp.int32).reshape(B, n_ps),
        jnp.zeros((B,), jnp.int32), jnp.asarray(toks),
        jnp.asarray([len(x) for x in seqs], jnp.int32), jcfg,
        all_positions=True)
    logits = np.asarray(logits)
    out = {}
    for b, r in enumerate(rids):
        P = len(prompts[r])
        lg = logits[b, P - 1: P - 1 + len(done[r])]
        near = np.nonzero(_top2_margin(lg) <= _near_tie_bound(lg))[0]
        upto = int(near[0]) if len(near) else len(done[r])
        assert (lg.argmax(-1)[:upto] == np.asarray(done[r][:upto])).all()
        out[r] = upto
    return out


def test_mesh_router_matches_jax_meshless_router(both):
    """In process: the port's 2x2 mesh router against the JAX mesh-less
    router with two shards: routing, drops and the served set equal, each
    stream up to its first JAX near tie."""
    jp, _, jg, _ = both
    prompts = _paged_prompts()
    jr = JR.ShardedServe(jax_smoke("qwen2-1.5b"), jp,
                         JE.ServeConfig(**PAGED, attn_impl="jnp"), None,
                         n_shards=2, gate=jg, eos_token=-1,
                         max_tokens=MAX_TOKENS, sync_every=2,
                         prefill_chunk=4)
    tr = _router(both, PAGED, _mesh(), prefill_chunk=4)
    done_j, done_t = _serve(jr, prompts), _serve(tr, prompts)
    assert sorted(done_t) == sorted(done_j)
    assert tr.assigned == jr.assigned and tr.dropped == jr.dropped
    assert tr.drop_reasons == jr.drop_reasons
    compared = 0
    for rid, upto in _near_tie_upto(jp, prompts, done_j).items():
        assert done_t[rid][:upto] == done_j[rid][:upto], (rid, upto)
        compared += upto
    assert compared > 0


_JAX_MESH_ROUTER = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from repro.arch import model as JM
    from repro.configs import get_smoke_config
    from repro.core import PlanterConfig, plant
    from repro.data import load_dataset
    from repro.launch.mesh import make_serve_mesh
    from repro.serve import engine as JE, router as JR

    assert jax.device_count() == 4
    DS = load_dataset("unsw", n=2000)
    cfg = get_smoke_config("qwen2-1.5b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    jg = plant(PlanterConfig(model="rf", size="S"), DS.X_train, DS.y_train,
               DS.X_test).mapped
    prompts = {int(k): v for k, v in json.loads(sys.argv[1]).items()}
    out = {}
    for tp in (False, True):
        r = JR.ShardedServe(
            cfg, jp, JE.ServeConfig(max_batch=4, cache_len=32, page_size=8,
                                    attn_impl="jnp"),
            make_serve_mesh("2x2"), gate=jg, eos_token=-1, max_tokens=3,
            sync_every=2, prefill_chunk=4, tp_params=tp)
        for rid, p in prompts.items():
            r.submit(rid, p, features=DS.X_test[rid])
        done = r.run(max_steps=400)
        out["tp" if tp else "rep"] = dict(
            done={str(k): [int(t) for t in v] for k, v in done.items()},
            assigned=r.assigned, dropped=r.dropped,
            reasons={str(k): v for k, v in r.drop_reasons.items()})
    print("ROUTER", json.dumps(out))
""")


def test_mesh_router_matches_jax_mesh_router(both):
    """One subprocess with four fake XLA devices runs the JAX router on a
    2x2 mesh, replicated and with ``tp_params``; the port's on 2x2 logical
    chips: equal routing, drops and served set; each stream up to its
    first JAX near tie, and the JAX TP streams also only up to their first
    departure from the JAX replicated run; the port's TP streams are its
    replicated streams bitwise (C.19)."""
    jp = both[0]
    prompts = _paged_prompts()
    r = subprocess.run(
        [sys.executable, "-c", _JAX_MESH_ROUTER, json.dumps(prompts)],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("ROUTER ")][-1]
    jax_runs = json.loads(line[len("ROUTER "):])
    rep = {int(k): v for k, v in jax_runs["rep"]["done"].items()}
    upto = _near_tie_upto(jp, prompts, rep)
    port = {}
    for mode in ("rep", "tp"):
        j = jax_runs[mode]
        tr = _router(both, PAGED, _mesh(), prefill_chunk=4,
                     tp_params=mode == "tp")
        done_t = port[mode] = _serve(tr, prompts)
        done_j = {int(k): v for k, v in j["done"].items()}
        assert sorted(done_t) == sorted(done_j)
        assert tr.assigned == j["assigned"] and tr.dropped == j["dropped"]
        assert tr.drop_reasons == {int(k): v for k, v in j["reasons"].items()}
        for rid, n in upto.items():
            if mode == "tp":  # up to the JAX TP run's first departure
                same = [a == b for a, b in zip(done_j[rid], rep[rid])]
                n = min(n, same.index(False) if False in same else n)
            assert done_t[rid][:n] == done_j[rid][:n], (mode, rid, n)
        assert sum(upto.values()) > 0
    assert port["tp"] == port["rep"]
