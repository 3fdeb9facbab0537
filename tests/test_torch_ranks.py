"""Serving over ranks on the CPU: ``torch.distributed`` gloo worlds of 2
and 4 ranks, each rank a process of its own.

The port against itself, bitwise: over a ``1 x m`` mesh of ranks
(``dist.sharding.RankMesh``) with the params replicated and the KV cache
split over ``model`` (each rank writes its rows, then gathers each
layer's cache in rank order), ``generate()``, the host batcher, the
device batcher (eager on the CPU, chunk 4 and chunk 1), the paged cache
(bf16 and int8) and the dense ring past its wrap, and a one-shard
``ShardedServe`` serve the mesh-less port's streams, drops and reasons,
for the qwen2-1.5b and qwen2-moe-a2.7b smoke configs with pages of 8 (so
that 4 ranks divide them); every rank serves the same.  Each rank holds the ``shard_shape``
of the logical-chip mesh's ``NamedSharding`` of every pool, ring and
param leaf, 1/m of the pool's bytes.  The refusals (``tp_params``, data
shards, deadlines and the recurrent families over ranks, a malformed
spec, a mesh on another device) run in the 2-rank world.

Against the JAX package: its router on a ``1x2`` mesh of fake XLA
devices (a subprocess) against the 2-rank router, under the near-tie rule
of ``test_torch_serve.py``.  Then the launcher: ``--ranks 2`` prints the
1x2 mesh and the mesh-less run's streams.

Both worlds and the JAX subprocess start together; every world and
subprocess has a timeout, so a rank out of lockstep fails the test.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from test_torch_serve import CFG, both  # noqa: E402,F401
from test_torch_serve_mesh import _near_tie_upto, _paged_prompts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 300  # seconds a world may take in all

# The serve paths, the placement and the refusals, run by each rank (a
# ``python -c`` process that imports the port alone) and, mesh-less, by
# the test itself.
WORKER = textwrap.dedent("""
    import os, pickle, sys, traceback
    import numpy as np
    import torch
    from repro_torch.arch import model as TM
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import load_dataset
    from repro_torch.dist import sharding as SH
    from repro_torch.serve import engine as TE
    from repro_torch.serve import router as TR
    from repro_torch.tree import leaves

    DS = load_dataset("unsw", n=2000)
    CFG = get_smoke_config("qwen2-1.5b")
    MOE = get_smoke_config("qwen2-moe-a2.7b")
    MAX_TOKENS = 3
    DENSE_TOKENS = 6  # 10 requests of 6 tokens pass the ring's 16 cells
    PAGED = dict(max_batch=4, cache_len=32, page_size=8)
    DENSE = dict(max_batch=4, cache_len=16)
    GEN_TOKENS = 16  # generate(): 4 prompt + 16 tokens past a ring of 16
    RANK_TIMEOUT = 120  # seconds a rank waits in a collective


    def paged_prompts(n=10, seed=2):
        rng = np.random.default_rng(seed)
        return {rid: [int(t) for t in rng.integers(1, 97, rng.integers(1, 8))]
                for rid in range(n)}


    def dense_prompts(n=10, seed=0):
        rng = np.random.default_rng(seed)
        return {rid: [int(rng.integers(1, 100))] for rid in range(n)}


    def serve(cb, prompts, max_steps=400):
        for rid, p in prompts.items():
            cb.submit(rid, p, features=DS.X_test[rid])
        done = cb.run(max_steps=max_steps)
        return dict(done=dict(done), dropped=list(cb.dropped),
                    reasons=dict(cb.drop_reasons))


    def streams(cfg, params, gate, mesh):
        \"\"\"Every serve path of the slice on ``mesh`` (None: mesh-less).\"\"\"
        out = {}
        eng = TE.ServeEngine(cfg, params, TE.ServeConfig(**DENSE), gate=gate,
                             mesh=mesh, device="cpu")
        prompts = np.random.default_rng(0).integers(1, 97, (4, 4))
        out["generate"] = eng.generate(prompts, GEN_TOKENS,
                                       features=DS.X_test[:4]).tolist()
        for kind, scfg, prompts, tokens in (
                ("paged", PAGED, paged_prompts(), MAX_TOKENS),
                ("dense", DENSE, dense_prompts(), DENSE_TOKENS)):
            def engine():
                return TE.ServeEngine(cfg, params, TE.ServeConfig(**scfg),
                                      gate=gate, mesh=mesh, device="cpu")

            out[f"host {kind}"] = serve(TE.ContinuousBatcher(
                engine(), eos_token=-1, max_tokens=tokens), prompts)
            for chunk in ((1, 4) if kind == "paged" else (1,)):
                out[f"device {kind} chunk {chunk}"] = serve(
                    TE.DeviceContinuousBatcher(
                        engine(), eos_token=-1, max_tokens=tokens,
                        sync_every=2, prefill_chunk=chunk), prompts)
        # the int8 pool: its scale planes written and gathered as the K/V
        out["device paged int8"] = serve(TE.DeviceContinuousBatcher(
            TE.ServeEngine(cfg, params, TE.ServeConfig(**PAGED, kv_int8=True),
                           gate=gate, mesh=mesh, device="cpu"),
            eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2,
            prefill_chunk=4), paged_prompts())
        r = TR.ShardedServe(cfg, params, TE.ServeConfig(**PAGED), mesh,
                            gate=gate, eos_token=-1, max_tokens=MAX_TOKENS,
                            sync_every=2, prefill_chunk=4, device="cpu")
        out["router"] = serve(r, paged_prompts())
        out["router"]["assigned"] = r.assigned
        return out


    def shapes(params, mesh):
        \"\"\"This rank's pool, int8 pool, ring and param leaves' shapes, and
        the pool's bytes.\"\"\"
        eng = TE.ServeEngine(CFG, params, TE.ServeConfig(**PAGED), mesh=mesh,
                             device="cpu")
        q8 = TE.ServeEngine(CFG, params,
                            TE.ServeConfig(**PAGED, kv_int8=True), mesh=mesh,
                            device="cpu")
        st = TE.ServeEngine(CFG, params, TE.ServeConfig(**DENSE), mesh=mesh,
                            device="cpu").state
        mine = [p for leaf in leaves(eng.params) for p in leaf.parts]
        given = [p for leaf in leaves(params) for p in leaf.parts]
        return dict(
            pool=[tuple(t.shape) for t in eng.paged_kv.pools()],
            int8=[tuple(t.shape) for t in q8.paged_kv.pools()],
            pool_bytes=sum(t.nbytes for t in eng.paged_kv.pools()),
            ring=[tuple(t.shape) for t in st["kv"]],
            pos=tuple(st["pos"].shape),
            params=[tuple(p.shape) for p in mine],
            same_params=len(mine) == len(given)
            and all(a is b for a, b in zip(mine, given)))


    def refusals(params, mesh):
        \"\"\"What a 2-rank world refuses: each case's exception and message.\"\"\"
        from repro_torch.launch.mesh import data_submeshes, make_serve_mesh

        scfg = TE.ServeConfig(**PAGED)
        rec = get_smoke_config("xlstm-125m")
        data2 = SH.RankMesh(np.arange(2).reshape(2, 1), ("data", "model"))
        cases = {
            "tp_params": lambda: TE.ServeEngine(
                CFG, params, scfg, mesh=mesh, tp_params=True, device="cpu"),
            "data engine": lambda: TE.ServeEngine(
                CFG, params, scfg, mesh=data2, device="cpu"),
            "data router": lambda: TR.ShardedServe(
                CFG, params, scfg, make_serve_mesh("2x1"), device="cpu"),
            "data submeshes": lambda: data_submeshes(data2),
            "deadline": lambda: TE.DeviceContinuousBatcher(
                TE.ServeEngine(CFG, params, scfg, mesh=mesh, device="cpu"),
                deadline_s=1.0),
            "recurrent": lambda: TE.ServeEngine(
                rec, TM.init_params(rec, 0, "cpu"), TE.ServeConfig(**DENSE),
                mesh=mesh, device="cpu"),
            "malformed": lambda: make_serve_mesh("two-by-one"),
            "another device": lambda: SH.RankMesh(
                np.arange(2).reshape(1, 2), ("data", "model"), "meta"),
        }
        out = {}
        for name, fn in cases.items():
            try:
                fn()
                out[name] = ("no error", "")
            except Exception as e:  # the refusal is the result
                out[name] = (type(e).__name__, str(e))
        return out


    def gate():
        from repro_torch.core import PlanterConfig, plant

        return plant(PlanterConfig(model="rf", size="S", device="cpu"),
                     DS.X_train, DS.y_train, DS.X_test).mapped


    def rank_main(rank, world, store, params_path, out_path):
        \"\"\"One rank of a gloo world on the CPU: every path over the
        ``1 x world`` mesh of ranks, its results pickled to ``out_path``.\"\"\"
        try:
            torch.set_num_threads(1)
            from repro_torch.dist import comm
            from repro_torch.launch.mesh import make_serve_mesh

            comm.init("cpu", rank=rank, world_size=world, local_rank=rank,
                      local_world_size=world, init_method=f"file://{store}",
                      timeout_s=RANK_TIMEOUT, verbose=False)
            mesh = make_serve_mesh("auto")
            g = gate()
            dense = torch.load(params_path)
            res = dict(mesh=dict(mesh.shape), coords=mesh.coords,
                       shapes=shapes(dense, mesh),
                       dense=streams(CFG, dense, g, mesh),
                       moe=streams(MOE, TM.init_params(MOE, 0, "cpu"), g,
                                   mesh))
            if world == 2:
                res["refusals"] = refusals(dense, mesh)
            comm.shutdown()
        except BaseException:
            res = dict(error=traceback.format_exc())
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
""")
W = {}
exec(WORKER, W)  # the mesh-less runs and the constants
PAGED, DENSE = W["PAGED"], W["DENSE"]


def _start_world(world, tmp, params_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    code = WORKER + "\nrank_main(int(sys.argv[1]), int(sys.argv[2]), " \
        "*sys.argv[3:])\n"
    procs = []
    for r in range(world):
        out = tmp / f"world{world}_rank{r}.pkl"
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world),
             str(tmp / f"store{world}"), str(params_path), str(out)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out))
    return procs


def _join_world(procs):
    results = []
    try:
        for r, (p, path) in enumerate(procs):
            log, _ = p.communicate(timeout=WORLD_TIMEOUT)
            assert path.exists(), f"rank {r} wrote nothing: {log[-3000:]}"
            res = pickle.loads(path.read_bytes())
            assert "error" not in res, f"rank {r}:\n{res['error']}"
            assert p.returncode == 0, (r, p.returncode, log[-3000:])
            results.append(res)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


_JAX_ROUTER = textwrap.dedent("""
    import json, sys
    import jax
    from repro.arch import model as JM
    from repro.configs import get_smoke_config
    from repro.core import PlanterConfig, plant
    from repro.data import load_dataset
    from repro.launch.mesh import make_serve_mesh
    from repro.serve import engine as JE, router as JR

    assert jax.device_count() == 2
    DS = load_dataset("unsw", n=2000)
    cfg = get_smoke_config("qwen2-1.5b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    jg = plant(PlanterConfig(model="rf", size="S"), DS.X_train, DS.y_train,
               DS.X_test).mapped
    prompts = {int(k): v for k, v in json.loads(sys.argv[1]).items()}
    r = JR.ShardedServe(
        cfg, jp, JE.ServeConfig(max_batch=4, cache_len=32, page_size=8,
                                attn_impl="jnp"),
        make_serve_mesh("1x2"), gate=jg, eos_token=-1, max_tokens=3,
        sync_every=2, prefill_chunk=4)
    for rid, p in prompts.items():
        r.submit(rid, p, features=DS.X_test[rid])
    done = r.run(max_steps=400)
    print("ROUTER", json.dumps(dict(
        done={str(k): [int(t) for t in v] for k, v in done.items()},
        assigned=r.assigned, dropped=r.dropped,
        reasons={str(k): v for k, v in r.drop_reasons.items()})))
""")


@pytest.fixture(scope="module")
def worlds(both, tmp_path_factory):
    """The 2- and 4-rank worlds' results, the JAX 1x2 router's output and
    the mesh-less port's streams, all started together."""
    _, tp, _, tg = both
    tmp = tmp_path_factory.mktemp("ranks")
    params_path = tmp / "params.pt"
    torch.save(tp, params_path)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_ROUTER, json.dumps(_paged_prompts())],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=2"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    started = {m: _start_world(m, tmp, params_path) for m in (2, 4)}
    try:
        meshless = dict(dense=W["streams"](CFG, tp, tg, None),
                        moe=W["streams"](W["MOE"], TM.init_params(
                            W["MOE"], 0, "cpu"), tg, None))
        results = {m: _join_world(started[m]) for m in (2, 4)}
        out, err = jax_run.communicate(timeout=WORLD_TIMEOUT)
    finally:
        for procs in started.values():
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    assert jax_run.returncode == 0, out + err
    line = [x for x in out.splitlines() if x.startswith("ROUTER ")][-1]
    return dict(results=results, meshless=meshless,
                jax=json.loads(line[len("ROUTER "):]))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_ranks_serve_the_meshless_streams_bitwise(worlds, m, family):
    """Every path over ``1 x m`` ranks, on every rank, is the mesh-less
    port's: the same streams, drops, reasons and routing, bitwise."""
    want = worlds["meshless"][family]
    assert set(want) == {"generate", "host paged", "device paged chunk 1",
                         "device paged chunk 4", "device paged int8",
                         "host dense", "device dense chunk 1", "router"}
    for rank, res in enumerate(worlds["results"][m]):
        assert res["mesh"] == {"data": 1, "model": m}
        assert res["coords"] == {"data": 0, "model": rank}
        for path, got in res[family].items():
            assert got == want[path], (family, m, rank, path)
    # the cases reach what they claim: served streams, a gate drop, the
    # chunked and token-by-token runs alike
    assert want["host paged"]["done"] and want["host paged"]["dropped"]
    assert want["device paged chunk 4"]["done"] == \
        want["device paged chunk 1"]["done"]
    assert want["device paged int8"]["done"]
    assert len(want["generate"][0]) == W["GEN_TOKENS"]


@pytest.mark.parametrize("m", [2, 4])
def test_each_rank_holds_its_shard(worlds, m):
    """Each rank's pool, int8 pool, ring and param leaves have the
    ``shard_shape`` of the logical-chip mesh's ``NamedSharding`` by the
    same rules (``tests/test_torch_dryrun.py`` holds that shape to the
    JAX shardings); a rank holds 1/m of the pool's bytes and the very
    params tensors it was given (replicated)."""
    logical = SH.Mesh(np.arange(m).reshape(1, m), ("data", "model"), "cpu")
    L, KV, hd = CFG.n_layers, CFG.n_kv_heads, CFG.head_dim_
    n_pages = PAGED["max_batch"] * PAGED["cache_len"] // PAGED["page_size"]
    pool = (L, n_pages, PAGED["page_size"], KV, hd)
    scale = pool[:-1] + (1,)
    ring = (L, DENSE["max_batch"], DENSE["cache_len"], KV, hd)

    def shard(shape, spec):
        return SH.NamedSharding(logical, spec).shard_shape(shape)

    meta = torch.empty(pool, device="meta")
    pspec = SH.paged_cache_pspec(meta, logical)
    rspec = SH.cache_pspec("kv/0", torch.empty(ring, device="meta"), logical,
                           DENSE["max_batch"])
    assert pspec[2] == "model" and rspec[2] == "model"
    full_bytes = 2 * int(np.prod(pool)) * 2
    for res in worlds["results"][m]:
        sh = res["shapes"]
        assert sh["pool"] == [shard(pool, pspec)] * 2
        assert sh["int8"] == [shard(pool, pspec)] * 2 + \
            [shard(scale, pspec)] * 2
        assert sh["ring"] == [shard(ring, rspec)] * 2 and sh["pos"] == ()
        assert sh["pool_bytes"] * m == full_bytes
        assert sh["same_params"] and sh["params"]
        assert all(p == shard(p, SH.P()) for p in sh["params"])


@pytest.mark.parametrize("case,exc,match", [
    ("tp_params", "NotImplementedError", "item 16"),
    ("data engine", "NotImplementedError", "item 16"),
    ("data router", "NotImplementedError", "item 16"),
    ("data submeshes", "NotImplementedError", "item 16"),
    ("deadline", "NotImplementedError", "item 16"),
    ("recurrent", "NotImplementedError", "item 16"),
    ("malformed", "ValueError", "DATAxMODEL"),
    ("another device", "ValueError", "another rank's device")])
def test_ranks_refuse_what_is_not_ported(worlds, case, exc, match):
    """Over ranks, ``tp_params``, data shards, deadlines and the recurrent
    families raise ``NotImplementedError`` naming item 16; a malformed spec
    and a mesh naming another device raise ``ValueError``; on both ranks
    alike."""
    for res in worlds["results"][2]:
        got, msg = res["refusals"][case]
        assert got == exc and match in msg, (case, got, msg)


def test_two_rank_router_matches_the_jax_router(worlds, both):
    """The JAX router on a 1x2 mesh of fake devices (replicated) against
    the port's 2-rank router: routing, drops and the served set equal,
    each stream up to its first JAX near tie."""
    jp = both[0]
    j = worlds["jax"]
    prompts = _paged_prompts()
    done_j = {int(k): v for k, v in j["done"].items()}
    for res in worlds["results"][2]:
        got = res["dense"]["router"]
        assert sorted(got["done"]) == sorted(done_j)
        assert got["assigned"] == j["assigned"]
        assert got["dropped"] == j["dropped"]
        assert got["reasons"] == {int(k): v for k, v in j["reasons"].items()}
        compared = 0
        for rid, upto in _near_tie_upto(jp, prompts, done_j).items():
            assert got["done"][rid][:upto] == done_j[rid][:upto], (rid, upto)
            compared += upto
        assert compared > 0


def test_launcher_serves_over_ranks():
    """``launch.serve --ranks 2`` on the CPU: a gloo world of 2, the 1x2
    mesh, and the mesh-less ``--router`` run's streams (their CRC32)."""
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
            "--device", "cpu", "--router", "--page-size", "8",
            "--requests", "16"]
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    runs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for cmd in (base + ["--ranks", "2"], base)]
    outs = []
    for p in runs:
        try:
            out, err = p.communicate(timeout=WORLD_TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        assert p.returncode == 0, out + err
        outs.append(out.splitlines())
    ranked, meshless = outs
    assert "ranks: a world of 2 over gloo (the ranks run on the CPU); rank 0 "\
        "on cpu" in ranked
    assert "router: 1 shard(s) over mesh {'data': 1, 'model': 2} on cpu" \
        in ranked
    crc = [[x for x in o if x.strip().startswith("streams: crc32")]
           for o in outs]
    assert len(crc[0]) == 1 and crc[0] == crc[1]
    served = [[x for x in o if x.startswith("[router] served")][0]
              .split(" — ")[0] for o in outs]
    assert served[0] == served[1]
    assert sum(x.startswith("router:") for x in ranked) == 1  # rank 0 alone
