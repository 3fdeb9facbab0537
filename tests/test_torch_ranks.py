"""Serving over ranks on the CPU: ``torch.distributed`` gloo worlds of 2
and 4 ranks, each rank a process of its own.

The port against itself, bitwise: over a ``1 x m`` mesh of ranks
(``dist.sharding.RankMesh``) with the params replicated and the KV cache
split over ``model`` (each rank writes its rows, then gathers each
layer's cache in rank order), ``generate()``, the host batcher, the
device batcher (eager on the CPU, chunk 4 and chunk 1), the paged cache
(bf16 and int8) and the dense ring past its wrap, a one-shard
``ShardedServe`` and, for the dense config, speculative decoding, a
shared prefix, a fault plan and a traced run serve the mesh-less port's
streams, drops and reasons,
for the qwen2-1.5b and qwen2-moe-a2.7b smoke configs with pages of 8 (so
that 4 ranks divide them); every rank serves the same.  Each rank holds
the ``shard_shape`` of the logical-chip mesh's ``NamedSharding`` of
every pool, ring and param leaf, 1/m of the pool's bytes.  Two data
slices of ranks (``2x1`` in the 2-rank world, ``2x2`` in the 4-rank one)
behind the router serve the mesh-less router's with two shards, also
under a crash and a straggler; deadlines over the ``1x2`` mesh follow
rank 0's clock whatever the other rank's reads.  The refusals
(``tp_params`` and the recurrent families over ranks, a malformed spec,
a mesh on another device) and what now builds run in the 2-rank world.

Against the JAX package: its router on ``1x2`` and ``2x2`` meshes of
fake XLA devices (a subprocess) against the 2-rank router and the 2x2
rank router, under the near-tie rule of ``test_torch_serve.py``.  Then
the launcher: ``--ranks 2`` prints the 1x2 mesh and the mesh-less run's
streams.

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
    import collections, os, pickle, sys, traceback
    import numpy as np
    import torch
    from repro_torch.arch import model as TM
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import load_dataset
    from repro_torch.dist import sharding as SH
    from repro_torch.obs import Metrics, Tracer
    from repro_torch.serve import engine as TE
    from repro_torch.serve import router as TR
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.spec import train_draft
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
    DEVICE_DEADLINE = 12.0  # ticks of the Ticks clock
    HOST_DEADLINE = 25.0


    def paged_prompts(n=10, seed=2):
        rng = np.random.default_rng(seed)
        return {rid: [int(t) for t in rng.integers(1, 97, rng.integers(1, 8))]
                for rid in range(n)}


    def dense_prompts(n=10, seed=0):
        rng = np.random.default_rng(seed)
        return {rid: [int(rng.integers(1, 100))] for rid in range(n)}


    def prefixed_prompts(n=8, seed=3):
        \"\"\"``paged_prompts`` behind one 16-token prefix (two full pages).\"\"\"
        prefix = [int(t) for t in np.random.default_rng(seed).integers(
            1, 97, 16)]
        return {rid: prefix + p for rid, p in paged_prompts(n).items()}


    class Ticks:
        \"\"\"A clock that ticks once a read: rank r's runs 1 + r / 2 times
        as fast as rank 0's, so a rank that decides by its own clock
        evicts other requests than rank 0.\"\"\"

        def __init__(self, rank=0):
            self.rate, self.n = 1.0 + 0.5 * rank, 0

        def __call__(self):
            self.n += 1
            return self.n * self.rate


    def serve(cb, prompts, max_steps=400, **run):
        for rid, p in prompts.items():
            cb.submit(rid, p, features=DS.X_test[rid])
        done = cb.run(max_steps=max_steps, **run)
        return dict(done=dict(done), dropped=list(cb.dropped),
                    reasons=dict(cb.drop_reasons))


    def routed(r, prompts, **run):
        \"\"\"A router's streams, drops, routing, hops and failovers.\"\"\"
        out = serve(r, prompts, **run)
        out.update(assigned=r.assigned, retries=dict(r.retries),
                   failover_log=list(r.failover_log))
        return out


    def streams(cfg, params, gate, mesh, modes=True):
        \"\"\"Every serve path of the slice on ``mesh`` (None: mesh-less);
        ``modes``: speculative decoding, a shared prefix, a fault plan and a
        traced run too.\"\"\"
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
        if not modes:
            return out

        def device(scfg=PAGED, **kw):
            eng = TE.ServeEngine(cfg, params, TE.ServeConfig(**scfg),
                                 gate=gate, mesh=mesh, device="cpu")
            return TE.DeviceContinuousBatcher(
                eng, eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2,
                prefill_chunk=4, **kw)

        # a pilot's draft: the prompts and the streams the LM served them
        pilot = out["device paged chunk 4"]["done"]
        draft = train_draft([paged_prompts()[r] + pilot[r] for r in pilot],
                            cfg.vocab_size)
        cb = device(spec_k=2, draft=draft)
        out["device paged spec"] = serve(cb, paged_prompts())
        out["device paged spec"]["spec"] = cb.spec_stats()
        shared = dict(PAGED, share_prefix=True)
        out["share prefix"] = dict(
            device=serve(device(shared), prefixed_prompts()),
            host=serve(TE.ContinuousBatcher(
                TE.ServeEngine(cfg, params, TE.ServeConfig(**shared),
                               gate=gate, mesh=mesh, device="cpu"),
                eos_token=-1, max_tokens=MAX_TOKENS), prefixed_prompts()))
        plan = FaultPlan.parse("nan:1@2,exhaust:0:2@3")
        out["device paged faults"] = serve(device(
            max_retries=2, fault_injector=plan.injector()), paged_prompts())
        tracer = Tracer(metrics=Metrics())
        out["device paged traced"] = serve(device(tracer=tracer),
                                           paged_prompts())
        out["device paged traced"]["events"] = sorted(collections.Counter(
            e["name"] for e in tracer.chrome_trace()["traceEvents"]).items())
        out["device paged traced"]["violations"] = tracer.validate()
        return out


    def data_routers(cfg, params, gate, mesh, faults=True):
        \"\"\"The router over two data slices (``mesh``; None: the mesh-less
        router with two shards): plain, and with ``faults`` two plans over
        turns of 4 steps, a straggler at one strike: shard 0 slow at its
        first turn (evicted, its work moved to shard 1) and shard 1
        crashed at its second drain (no survivor); and both at their
        second, where the crash moves shard 1's work to shard 0, which took
        its turn already (shard 0 flagged, kept as the last one).\"\"\"
        def router(**kw):
            return TR.ShardedServe(
                cfg, params, TE.ServeConfig(**PAGED), mesh, n_shards=2,
                gate=gate, eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2,
                prefill_chunk=4, device="cpu", **kw)

        r = router()
        out = dict(router=routed(r, paged_prompts()), pools=[
            sum(t.nbytes for t in b._pages.pools()) for b in r.batchers
            if isinstance(b, TE.DeviceContinuousBatcher)])
        for case, spec in (("router faults", "slow:0:60.0@0,crash:1@1"),
                           ("router crash", "slow:0:60.0@1,crash:1@1")):
            if faults:
                out[case] = routed(router(
                    fault_injector=FaultPlan.parse(spec).injector(),
                    straggler_strikes=1, max_retries=2), paged_prompts(16),
                    drain_chunk=4)
        return out


    def deadlines(cfg, params, gate, mesh, clock):
        \"\"\"A device and a host batcher on ``mesh`` with a deadline, both
        reading ``clock``.\"\"\"
        def engine():
            return TE.ServeEngine(cfg, params, TE.ServeConfig(**PAGED),
                                  gate=gate, mesh=mesh, device="cpu")

        return dict(
            device=serve(TE.DeviceContinuousBatcher(
                engine(), eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2,
                prefill_chunk=4, deadline_s=DEVICE_DEADLINE, clock=clock),
                paged_prompts()),
            host=serve(TE.ContinuousBatcher(
                engine(), eos_token=-1, max_tokens=MAX_TOKENS,
                deadline_s=HOST_DEADLINE, clock=clock), paged_prompts()))


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
        from repro_torch.launch.mesh import make_serve_mesh

        scfg = TE.ServeConfig(**PAGED)
        rec = get_smoke_config("xlstm-125m")
        cases = {
            "tp_params": lambda: TE.ServeEngine(
                CFG, params, scfg, mesh=mesh, tp_params=True, device="cpu"),
            "recurrent": lambda: TE.ServeEngine(
                rec, TM.init_params(rec, 0, "cpu"), TE.ServeConfig(**DENSE),
                mesh=mesh, device="cpu"),
            "malformed": lambda: make_serve_mesh("two-by-one"),
            "another device": lambda: SH.RankMesh(
                np.arange(2).reshape(1, 2), ("data", "model"), "meta"),
        }
        return outcomes(cases)


    def outcomes(cases):
        \"\"\"Each case's exception and message, or ``"no error"`` and what
        it returned (a list, tuple or string; else "").\"\"\"
        out = {}
        for name, fn in cases.items():
            try:
                got = fn()
                out[name] = ("no error", got if isinstance(
                    got, (list, tuple, str)) else "")
            except Exception as e:  # the refusal is the result
                out[name] = (type(e).__name__, str(e))
        return out


    def builds(params, mesh):
        \"\"\"What a 2-rank world builds on a 2x1 mesh of ranks, and what a
        lone engine or batcher on it still refuses: each case's outcome.\"\"\"
        from repro_torch.launch.mesh import data_submeshes

        scfg = TE.ServeConfig(**PAGED)
        data2 = SH.RankMesh(np.arange(2).reshape(2, 1), ("data", "model"))

        def router():
            r = TR.ShardedServe(CFG, params, scfg, data2, device="cpu")
            return (r.n_shards, len(r.engines),
                    [type(b).__name__ for b in r.batchers])

        def submeshes():
            return [(type(sm).__name__, [int(i) for i in sm.devices.ravel()],
                     getattr(sm, "coords", None), sm.lead)
                    for sm in data_submeshes(data2)]

        def deadline():
            cb = TE.DeviceContinuousBatcher(
                TE.ServeEngine(CFG, params, scfg, mesh=mesh, device="cpu"),
                deadline_s=1.0)
            return type(cb._now).__name__

        return outcomes({
            "data engine": lambda: TE.ServeEngine(
                CFG, params, scfg, mesh=data2, device="cpu"),
            "data router": router,
            "data submeshes": submeshes,
            "deadline": deadline,
        })


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
            moe = TM.init_params(MOE, 0, "cpu")
            res = dict(mesh=dict(mesh.shape), coords=mesh.coords,
                       shapes=shapes(dense, mesh),
                       dense=streams(CFG, dense, g, mesh),
                       moe=streams(MOE, moe, g, mesh, modes=False))
            # two data slices: of one rank each, or of a model pair each
            data = make_serve_mesh("2x1" if world == 2 else "2x2")
            res["data"] = dict(mesh=dict(data.shape), coords=data.coords,
                               dense=data_routers(CFG, dense, g, data,
                                                  faults=world == 2))
            if world == 2:
                res["data"]["moe"] = data_routers(MOE, moe, g, data,
                                                  faults=False)
                res["deadlines"] = deadlines(CFG, dense, g, mesh,
                                             Ticks(rank))
                res["refusals"] = refusals(dense, mesh)
                res["builds"] = builds(dense, mesh)
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

    assert jax.device_count() == 4
    DS = load_dataset("unsw", n=2000)
    cfg = get_smoke_config("qwen2-1.5b")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    jg = plant(PlanterConfig(model="rf", size="S"), DS.X_train, DS.y_train,
               DS.X_test).mapped
    prompts = {int(k): v for k, v in json.loads(sys.argv[1]).items()}
    out = {}
    for spec in ("1x2", "2x2"):
        r = JR.ShardedServe(
            cfg, jp, JE.ServeConfig(max_batch=4, cache_len=32, page_size=8,
                                    attn_impl="jnp"),
            make_serve_mesh(spec), gate=jg, eos_token=-1, max_tokens=3,
            sync_every=2, prefill_chunk=4)
        for rid, p in prompts.items():
            r.submit(rid, p, features=DS.X_test[rid])
        done = r.run(max_steps=400)
        out[spec] = dict(
            done={str(k): [int(t) for t in v] for k, v in done.items()},
            assigned=r.assigned, dropped=r.dropped,
            reasons={str(k): v for k, v in r.drop_reasons.items()})
    print("ROUTER", json.dumps(out))
""")


@pytest.fixture(scope="module")
def worlds(both, tmp_path_factory):
    """The 2- and 4-rank worlds' results, the JAX 1x2 and 2x2 routers'
    output and the mesh-less port's streams, all started together."""
    _, tp, _, tg = both
    tmp = tmp_path_factory.mktemp("ranks")
    params_path = tmp / "params.pt"
    torch.save(tp, params_path)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_ROUTER, json.dumps(_paged_prompts())],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    started = {m: _start_world(m, tmp, params_path) for m in (2, 4)}
    try:
        moe = TM.init_params(W["MOE"], 0, "cpu")
        meshless = dict(
            dense=W["streams"](CFG, tp, tg, None),
            moe=W["streams"](W["MOE"], moe, tg, None, modes=False),
            data=dict(dense=W["data_routers"](CFG, tp, tg, None),
                      moe=W["data_routers"](W["MOE"], moe, tg, None,
                                            faults=False)),
            deadlines=W["deadlines"](CFG, tp, tg, None, W["Ticks"](0)))
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
    modes = {"device paged spec", "share prefix", "device paged faults",
             "device paged traced"}  # the dense config's
    assert set(want) == {"generate", "host paged", "device paged chunk 1",
                         "device paged chunk 4", "device paged int8",
                         "host dense", "device dense chunk 1", "router"} | (
                             modes if family == "dense" else set())
    for rank, res in enumerate(worlds["results"][m]):
        assert res["mesh"] == {"data": 1, "model": m}
        assert res["coords"] == {"data": 0, "model": rank}
        assert set(res[family]) == set(want)
        for path, got in res[family].items():
            assert got == want[path], (family, m, rank, path)
    # the cases reach what they claim: served streams, a gate drop, the
    # chunked and token-by-token runs alike, accepted drafts, shared
    # prefix pages, a quarantine, a valid trace with the same events
    assert want["host paged"]["done"] and want["host paged"]["dropped"]
    assert want["device paged chunk 4"]["done"] == \
        want["device paged chunk 1"]["done"]
    assert want["device paged int8"]["done"]
    assert len(want["generate"][0]) == W["GEN_TOKENS"]
    if family != "dense":
        return
    spec = want["device paged spec"]
    assert spec["spec"]["accepted"] > 0
    assert spec["done"] == want["device paged chunk 4"]["done"]
    shared = want["share prefix"]
    assert shared["device"]["done"] and \
        shared["device"]["done"] == shared["host"]["done"]
    assert "quarantined" in want["device paged faults"]["reasons"].values()
    traced = want["device paged traced"]
    assert traced["done"] == want["device paged chunk 4"]["done"]
    assert traced["events"] and traced["violations"] == []


@pytest.mark.parametrize("m,family", [(2, "dense"), (2, "moe"),
                                      (4, "dense")])
def test_data_slices_over_ranks_serve_the_meshless_router_bitwise(
        worlds, m, family):
    """The router over two data slices of ranks (``2x1`` over 2 ranks,
    ``2x2`` over 4: each slice a group of ranks) is the mesh-less router
    with two shards on every rank: the streams, routing, drops, reasons,
    hops and failovers, bitwise, and in the 2-rank world also under a
    crash of the later shard and a straggler at one strike; each rank
    holds its slice's pool split over the slice's ``model`` ranks."""
    want = dict(worlds["meshless"]["data"][family])
    if m == 4:  # the fault plans run in the 2-rank world
        want.pop("router faults", None)
        want.pop("router crash", None)
    model = m // 2
    for rank, res in enumerate(worlds["results"][m]):
        data = res["data"]
        assert data["mesh"] == {"data": 2, "model": model}
        assert data["coords"] == {"data": rank // model,
                                  "model": rank % model}
        got = data[family]
        assert set(got) == set(want)
        for case in want:
            if case != "pools":
                assert got[case] == want[case], (m, family, rank, case)
        # the one batcher this rank runs holds 1/model of a slice's pool
        assert len(got["pools"]) == 1 and len(want["pools"]) == 2
        assert got["pools"][0] * model == want["pools"][0]
    plain = want["router"]
    assert plain["done"] and all(plain["assigned"])
    if "router faults" in want:
        faults, crash = want["router faults"], want["router crash"]
        assert [(s, why) for s, why, _ in faults["failover_log"]] == [
            (0, "straggler"), (1, "crash-injected")]
        assert "shard-failed" in faults["reasons"].values()
        assert [(s, why) for s, why, _ in crash["failover_log"]] == [
            (1, "crash-injected")]
        for case in (faults, crash):
            assert case["retries"] and case["done"]


def test_deadlines_over_ranks_follow_rank_zeros_clock(worlds):
    """A device and a host batcher on the ``1x2`` mesh of ranks with a
    deadline, rank ``r``'s clock running ``1 + r / 2`` times as fast: on
    both ranks the drops, reasons and streams are the mesh-less
    batchers' under rank 0's clock, bitwise (one clock for the world:
    the slice's lead reads it, the others take its value)."""
    want = worlds["meshless"]["deadlines"]
    for rank, res in enumerate(worlds["results"][2]):
        assert res["deadlines"] == want, rank
    for kind in ("device", "host"):
        reasons = list(want[kind]["reasons"].values())
        assert "deadline" in reasons and want[kind]["done"], kind


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
    ("recurrent", "NotImplementedError", "item 16"),
    ("malformed", "ValueError", "DATAxMODEL"),
    ("another device", "ValueError", "another rank's device")])
def test_ranks_refuse_what_is_not_ported(worlds, case, exc, match):
    """Over ranks, ``tp_params`` and the recurrent families raise
    ``NotImplementedError`` naming queue A item 16 (``tp_params`` over
    ranks, the families over ranks); a malformed spec and a mesh naming
    another device raise ``ValueError``; on both ranks alike."""
    for res in worlds["results"][2]:
        got, msg = res["refusals"][case]
        assert got == exc and match in msg, (case, got, msg)


@pytest.mark.parametrize("case", ["data engine", "data router",
                                  "data submeshes", "deadline"])
def test_ranks_build_what_now_serves(worlds, case):
    """What the 2-rank world refused before data slices and deadlines
    served over ranks: the router over a ``2x1`` mesh of ranks builds one
    engine (its own slice) beside a stand-in; the slices are a rank mesh
    of this rank's group and a foreign slice; a deadline batcher decides
    by the slice's shared clock.  A lone engine on that mesh still
    raises, naming the router."""
    for rank, res in enumerate(worlds["results"][2]):
        got, out = res["builds"][case]
        if case == "data engine":
            assert got == "ValueError" and "ShardedServe" in out, out
            continue
        assert got == "no error", out
        if case == "data router":
            kinds = ["_SliceStandIn", "_SliceStandIn"]
            kinds[rank] = "DeviceContinuousBatcher"
            assert out == (2, 1, kinds)
        elif case == "data submeshes":
            want = [("ForeignSlice", [0], None, 0),
                    ("ForeignSlice", [1], None, 1)]
            want[rank] = ("RankMesh", [rank], {"data": 0, "model": 0}, rank)
            assert out == want
        else:
            assert out == "SharedClock"


def test_two_rank_router_matches_the_jax_router(worlds, both):
    """The JAX router on a 1x2 mesh of fake devices (replicated) against
    the port's 2-rank router: routing, drops and the served set equal,
    each stream up to its first JAX near tie."""
    jp = both[0]
    j = worlds["jax"]["1x2"]
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


def test_data_router_matches_the_jax_2x2_router(worlds, both):
    """The JAX router on a 2x2 mesh of fake devices against the port's
    router over the 2x2 mesh of 4 ranks (two slices of a model pair):
    routing, drops and the served set equal, each stream up to its first
    JAX near tie."""
    jp = both[0]
    j = worlds["jax"]["2x2"]
    prompts = _paged_prompts()
    done_j = {int(k): v for k, v in j["done"].items()}
    upto = _near_tie_upto(jp, prompts, done_j)
    assert sum(upto.values()) > 0
    for res in worlds["results"][4]:
        got = res["data"]["dense"]["router"]
        assert sorted(got["done"]) == sorted(done_j)
        assert got["assigned"] == j["assigned"]
        assert got["dropped"] == j["dropped"]
        assert got["reasons"] == {int(k): v for k, v in j["reasons"].items()}
        for rid, n in upto.items():
            assert got["done"][rid][:n] == done_j[rid][:n], (rid, n)


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
