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
rank 0's clock whatever the other rank's reads.  The refusals (the
recurrent families over ranks, a malformed spec, a mesh on another
device) and what now builds run in the 2-rank world.

Tensor parallelism (``tp_params``) in the same worlds: the smoke config
(its 3 heads split over neither 2 nor 4 ranks: the attention replicated,
the MLP and vocab split), a narrow config whose heads split (4 query
heads on 2 KV heads, d_model 64: 1 KV head a rank over 2, each KV head
on 2 ranks over 4) and the MoE smoke config (its experts split) serve
every path of ``streams`` on every rank alike, bitwise within TP (host ==
device, chunk 4 == chunk 1, speculative == greedy, shared prefix ==
unshared), and against the replicated mesh-less port with the same
routing, drops and served set and each stream equal up to its first near
tie (the mesh-less port's teacher-forced top-2 margin within twice the
logit tolerance); each rank holds its layout's slices and the pool of
its KV heads; the 2x2 rank router runs TP in each slice's model pair.

Against the JAX package: its router on ``1x2`` and ``2x2`` meshes of
fake XLA devices (a subprocess; on the 2x2 mesh also with ``tp_params``,
for the smoke and the narrow config) against the 2-rank router and the
2x2 rank router (replicated and TP), under the near-tie rule of
``test_torch_serve.py``.  Then the launcher: ``--ranks 2`` prints the
1x2 mesh and the mesh-less run's streams; with ``--tp-params`` the
layout, and streams whose served set is the mesh-less run's.

Both worlds and the JAX subprocess start together; every world and
subprocess has a timeout, so a rank out of lockstep fails the test.
"""
import dataclasses
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

from repro.arch import model as JM  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.arch.convert import params_from_arrays  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from test_torch_serve import (CFG, _near_tie_bound, _top2_margin,  # noqa: E402
                              both)  # noqa: F401
from test_torch_serve_mesh import _near_tie_upto, _paged_prompts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 300  # seconds a world may take in all

# The serve paths, the placement and the refusals, run by each rank (a
# ``python -c`` process that imports the port alone) and, mesh-less, by
# the test itself.
WORKER = textwrap.dedent("""
    import collections, dataclasses, os, pickle, sys, traceback
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
    # the smoke config with heads that split over 2 and 4 ranks
    NARROW = dataclasses.replace(CFG, n_heads=4, n_kv_heads=2, d_model=64)
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


    def streams(cfg, params, gate, mesh, modes=True, tp=False):
        \"\"\"Every serve path of the slice on ``mesh`` (None: mesh-less);
        ``modes``: speculative decoding, a shared prefix, a fault plan and a
        traced run too; ``tp``: the params split over the ranks
        (``tp_params``).\"\"\"
        out = {}
        eng = TE.ServeEngine(cfg, params, TE.ServeConfig(**DENSE), gate=gate,
                             mesh=mesh, tp_params=tp, device="cpu")
        prompts = np.random.default_rng(0).integers(1, 97, (4, 4))
        out["generate"] = eng.generate(prompts, GEN_TOKENS,
                                       features=DS.X_test[:4]).tolist()
        for kind, scfg, prompts, tokens in (
                ("paged", PAGED, paged_prompts(), MAX_TOKENS),
                ("dense", DENSE, dense_prompts(), DENSE_TOKENS)):
            def engine():
                return TE.ServeEngine(cfg, params, TE.ServeConfig(**scfg),
                                      gate=gate, mesh=mesh, tp_params=tp,
                                      device="cpu")

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
                           gate=gate, mesh=mesh, tp_params=tp, device="cpu"),
            eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2,
            prefill_chunk=4), paged_prompts())
        r = TR.ShardedServe(cfg, params, TE.ServeConfig(**PAGED), mesh,
                            gate=gate, eos_token=-1, max_tokens=MAX_TOKENS,
                            sync_every=2, prefill_chunk=4, tp_params=tp,
                            device="cpu")
        out["router"] = serve(r, paged_prompts())
        out["router"]["assigned"] = r.assigned
        if not modes:
            return out

        def device(scfg=PAGED, **kw):
            eng = TE.ServeEngine(cfg, params, TE.ServeConfig(**scfg),
                                 gate=gate, mesh=mesh, tp_params=tp,
                                 device="cpu")
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
                               gate=gate, mesh=mesh, tp_params=tp,
                               device="cpu"),
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


    def data_routers(cfg, params, gate, mesh, faults=True, tp=False):
        \"\"\"The router over two data slices (``mesh``; None: the mesh-less
        router with two shards): plain, and with ``faults`` two plans over
        turns of 4 steps, a straggler at one strike: shard 0 slow at its
        first turn (evicted, its work moved to shard 1) and shard 1
        crashed at its second drain (no survivor); and both at their
        second, where the crash moves shard 1's work to shard 0, which took
        its turn already (shard 0 flagged, kept as the last one); ``tp``:
        each slice's params split over its model ranks.\"\"\"
        def router(**kw):
            return TR.ShardedServe(
                cfg, params, TE.ServeConfig(**PAGED), mesh, n_shards=2,
                gate=gate, eos_token=-1, max_tokens=MAX_TOKENS, sync_every=2,
                prefill_chunk=4, tp_params=tp, device="cpu", **kw)

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


    def tp_slices(params, mesh):
        \"\"\"Under ``tp_params`` this rank's layout, index and param leaves
        (the narrow config's, values and all) and its pool, int8 pool and
        ring shapes.\"\"\"
        def engine(**kw):
            return TE.ServeEngine(NARROW, params, TE.ServeConfig(**kw),
                                  mesh=mesh, tp_params=True, device="cpu")

        eng = engine(**PAGED)
        return dict(
            layout=eng.tp.layout, index=eng.tp.index, params=eng.params,
            pool=[tuple(t.shape) for t in eng.paged_kv.pools()],
            int8=[tuple(t.shape) for t in
                  engine(**PAGED, kv_int8=True).paged_kv.pools()],
            ring=[tuple(t.shape) for t in engine(**DENSE).state["kv"]],
            split=eng.paged_kv.split)


    def one_rank_tp(params, mesh):
        \"\"\"``tp_params`` on this rank's data slice of ``mesh`` (a model
        group of one rank): the engine's TensorParallel (None) and whether
        it holds every param leaf whole.\"\"\"
        from repro_torch.launch.mesh import data_submeshes

        mine = data_submeshes(mesh)[mesh.coords["data"]]
        eng = TE.ServeEngine(CFG, params, TE.ServeConfig(**PAGED), mesh=mine,
                             tp_params=True, device="cpu")
        mine = [p for leaf in leaves(eng.params) for p in leaf.parts]
        given = [p for leaf in leaves(params) for p in leaf.parts]
        return dict(tp=eng.tp, whole=len(mine) == len(given) and all(
            torch.equal(a, b) for a, b in zip(mine, given)))


    def sums(rank, world):
        \"\"\"``comm.reduce_sum`` of a float32 tensor each rank makes from
        its rank (rank 0 ones, the others ``2 ** -24`` a half ulp of 1.0,
        the last 0), and the launches it counted.\"\"\"
        from repro_torch.dist import comm

        v = 1.0 if rank == 0 else (0.0 if rank == world - 1 and world > 2
                                   else 2.0 ** -24)
        t = torch.full((3, 5), v, dtype=torch.float32)
        comm.reset_counts()
        out = comm.reduce_sum(t)
        return dict(sum=out.tolist(), launches=comm.launches,
                    dtype=str(out.dtype))


    def refusals(params, mesh):
        \"\"\"What a 2-rank world refuses: each case's exception and message.\"\"\"
        from repro_torch.launch.mesh import make_serve_mesh

        scfg = TE.ServeConfig(**PAGED)
        rec = get_smoke_config("xlstm-125m")
        cases = {
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


    def rank_main(rank, world, store, params_path, narrow_path, out_path):
        \"\"\"One rank of a gloo world on the CPU: every path over the
        ``1 x world`` mesh of ranks, replicated and under ``tp_params``,
        its results pickled to ``out_path``.\"\"\"
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
            narrow = torch.load(narrow_path)
            moe = TM.init_params(MOE, 0, "cpu")
            res = dict(mesh=dict(mesh.shape), coords=mesh.coords,
                       sums=sums(rank, world), shapes=shapes(dense, mesh),
                       dense=streams(CFG, dense, g, mesh),
                       moe=streams(MOE, moe, g, mesh, modes=False))
            res["tp"] = dict(
                narrow=streams(NARROW, narrow, g, mesh, tp=True),
                dense=streams(CFG, dense, g, mesh, modes=False, tp=True),
                moe=streams(MOE, moe, g, mesh, modes=False, tp=True),
                slices=tp_slices(narrow, mesh))
            # two data slices: of one rank each, or of a model pair each
            data = make_serve_mesh("2x1" if world == 2 else "2x2")
            res["data"] = dict(mesh=dict(data.shape), coords=data.coords,
                               dense=data_routers(CFG, dense, g, data,
                                                  faults=world == 2))
            if world == 4:  # TP inside each slice's model pair
                res["data"]["tp"] = {
                    name: data_routers(cfg, p, g, data, faults=False,
                                       tp=True)
                    for name, cfg, p in (("dense", CFG, dense),
                                         ("narrow", NARROW, narrow))}
            if world == 2:
                res["data"]["moe"] = data_routers(MOE, moe, g, data,
                                                  faults=False)
                # TP over model groups of one rank: nothing split
                res["data"]["tp"] = dict(dense=data_routers(
                    CFG, dense, g, data, faults=False, tp=True))
                res["one_rank_tp"] = one_rank_tp(dense, data)
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
JAX_NARROW = dataclasses.replace(jax_smoke("qwen2-1.5b"), n_heads=4,
                                 n_kv_heads=2, d_model=64)


def _start_world(world, tmp, params_path, narrow_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    code = WORKER + "\nrank_main(int(sys.argv[1]), int(sys.argv[2]), " \
        "*sys.argv[3:])\n"
    procs = []
    for r in range(world):
        out = tmp / f"world{world}_rank{r}.pkl"
        procs.append((subprocess.Popen(
            [sys.executable, "-c", code, str(r), str(world),
             str(tmp / f"store{world}"), str(params_path), str(narrow_path),
             str(out)],
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
    import dataclasses, json, sys
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
    narrow = dataclasses.replace(cfg, n_heads=4, n_kv_heads=2, d_model=64)
    jn = JM.init_params(narrow, jax.random.PRNGKey(0))
    prompts = {int(k): v for k, v in json.loads(sys.argv[1]).items()}
    out = {}
    for key, spec, c, p, tp in (("1x2", "1x2", cfg, jp, False),
                                ("2x2", "2x2", cfg, jp, False),
                                ("2x2 tp", "2x2", cfg, jp, True),
                                ("2x2 tp narrow", "2x2", narrow, jn, True)):
        r = JR.ShardedServe(
            c, p, JE.ServeConfig(max_batch=4, cache_len=32, page_size=8,
                                 attn_impl="jnp"),
            make_serve_mesh(spec), gate=jg, eos_token=-1, max_tokens=3,
            sync_every=2, prefill_chunk=4, tp_params=tp)
        for rid, p in prompts.items():
            r.submit(rid, p, features=DS.X_test[rid])
        done = r.run(max_steps=400)
        out[key] = dict(
            done={str(k): [int(t) for t in v] for k, v in done.items()},
            assigned=r.assigned, dropped=r.dropped,
            reasons={str(k): v for k, v in r.drop_reasons.items()})
    print("ROUTER", json.dumps(out))
""")


@pytest.fixture(scope="module")
def worlds(both, tmp_path_factory):
    """The 2- and 4-rank worlds' results, the JAX 1x2 and 2x2 routers'
    output (the 2x2 replicated and ``tp_params``) and the mesh-less
    port's streams, all started together; the narrow config's JAX params
    (``jn``) beside them."""
    _, tp, _, tg = both
    tmp = tmp_path_factory.mktemp("ranks")
    params_path = tmp / "params.pt"
    torch.save(tp, params_path)
    jn = JM.init_params(JAX_NARROW, jax.random.PRNGKey(0))
    narrow = params_from_arrays(jax.tree.map(np.asarray, jn), W["NARROW"],
                                "cpu")
    narrow_path = tmp / "narrow.pt"
    torch.save(narrow, narrow_path)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_ROUTER, json.dumps(_paged_prompts())],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    started = {m: _start_world(m, tmp, params_path, narrow_path)
               for m in (2, 4)}
    try:
        moe = TM.init_params(W["MOE"], 0, "cpu")
        meshless = dict(
            dense=W["streams"](CFG, tp, tg, None),
            moe=W["streams"](W["MOE"], moe, tg, None, modes=False),
            narrow=W["streams"](W["NARROW"], narrow, tg, None),
            data=dict(dense=W["data_routers"](CFG, tp, tg, None),
                      moe=W["data_routers"](W["MOE"], moe, tg, None,
                                            faults=False),
                      narrow=W["data_routers"](W["NARROW"], narrow, tg,
                                               None, faults=False)),
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
    return dict(results=results, meshless=meshless, jn=jn,
                params=dict(dense=tp, moe=moe, narrow=narrow),
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
    ("recurrent", "NotImplementedError", "item 16"),
    ("malformed", "ValueError", "DATAxMODEL"),
    ("another device", "ValueError", "another rank's device")])
def test_ranks_refuse_what_is_not_ported(worlds, case, exc, match):
    """Over ranks the recurrent families raise ``NotImplementedError``
    naming queue A item 16 (the families over ranks); a malformed spec and
    a mesh naming another device raise ``ValueError``; on both ranks
    alike."""
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


# ------------------------------------------------ tensor parallelism
TP_CFGS = {"narrow": W["NARROW"], "dense": CFG, "moe": W["MOE"]}
# the paths whose streams are teacher-forced through the paged cache, and
# their prompts (the int8 pool's through an int8 pool)
TP_PAGED = ("host paged", "device paged chunk 1", "device paged chunk 4",
            "device paged int8", "router", "device paged spec",
            "device paged faults", "device paged traced")


def _port_upto(cfg, params, prompts, done, kv_dtype="bf16"):
    """Per request, the mesh-less port's stream's length before its first
    near tie: the stream teacher-forced through the mesh-less port's paged
    step (one chunked call), the first generated position whose top-2
    margin is within ``_near_tie_bound``; the port's argmax is the stream
    up to there."""
    rids = sorted(done)
    seqs = [list(prompts[r]) + list(done[r]) for r in rids]
    B, L, page = len(seqs), max(len(x) for x in seqs), PAGED["page_size"]
    n_ps = -(-L // page)
    toks = np.zeros((B, L), np.int32)
    for b, x in enumerate(seqs):
        toks[b, :len(x)] = x
    logits, _ = TM.paged_decode_step(
        params, TM.init_paged_kv(cfg, B * n_ps, page, kv_dtype=kv_dtype,
                                 device="cpu"),
        torch.arange(B * n_ps, dtype=torch.int32).reshape(B, n_ps),
        torch.zeros(B, dtype=torch.int32), torch.as_tensor(toks),
        torch.tensor([len(x) for x in seqs], dtype=torch.int32), cfg,
        all_positions=True)
    logits = logits.numpy()
    out = {}
    for b, r in enumerate(rids):
        P = len(prompts[r])
        lg = logits[b, P - 1: P - 1 + len(done[r])]
        near = np.nonzero(_top2_margin(lg) <= _near_tie_bound(lg))[0]
        out[r] = int(near[0]) if len(near) else len(done[r])
        assert (lg.argmax(-1)[:out[r]] == np.asarray(done[r][:out[r]])).all()
    return out


def _generate_upto(cfg, params, streams):
    """``_port_upto`` for ``generate()``'s streams: the prompts and the
    streams teacher-forced through the mesh-less dense step."""
    prompts = np.random.default_rng(0).integers(1, 97, (4, 4))
    seq = np.concatenate([prompts, np.asarray(streams)], 1)
    P, n = prompts.shape[1], len(streams[0])
    st = TM.init_decode_state(cfg, len(seq), DENSE["cache_len"],
                              device="cpu")
    upto = [n] * len(seq)
    for i in range(seq.shape[1] - 1):
        lg, st = TM.decode_step(params, st, torch.as_tensor(seq[:, i:i + 1]),
                                cfg)
        j = i + 1 - P
        if j < 0:
            continue
        lg = lg.numpy()
        near = _top2_margin(lg) <= _near_tie_bound(lg)
        for b in range(len(seq)):
            if near[b]:
                upto[b] = min(upto[b], j)
            if j < upto[b]:
                assert lg[b].argmax() == seq[b, i + 1]
    return upto


def _tp_prompts(path):
    return (W["prefixed_prompts"]() if path == "share prefix"
            else W["paged_prompts"]())


def _same_served(got, want):
    """The served set, drops and reasons (and a router's routing) of a
    path equal."""
    assert sorted(got["done"]) == sorted(want["done"])
    for k in ("dropped", "reasons", "assigned"):
        assert got.get(k) == want.get(k), k


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("family", list(TP_CFGS))
def test_tp_over_ranks_serves_the_meshless_port_up_to_near_ties(
        worlds, m, family):
    """Every path of ``streams`` under ``tp_params`` over ``1 x m`` ranks:
    every rank alike, bitwise within TP (host == device, chunk 4 == chunk
    1, and for the narrow config speculative == greedy, shared prefix
    host == device, traced == untraced), and against the replicated
    mesh-less port the same served set, drops, reasons and routing, each
    stream (``generate()`` and the paged paths) equal up to its first
    near tie of the mesh-less port's teacher-forced logits."""
    cfg, params = TP_CFGS[family], worlds["params"][family]
    want = worlds["meshless"][family]
    got = [res["tp"][family] for res in worlds["results"][m]]
    for rank, g in enumerate(got):
        assert g == got[0], (family, m, rank)
    g = got[0]
    assert set(g) <= set(want) and ("device paged spec" in g) == (
        family == "narrow")
    assert g["device paged chunk 4"]["done"] == \
        g["device paged chunk 1"]["done"] == g["host paged"]["done"]
    assert g["device dense chunk 1"]["done"] == g["host dense"]["done"]
    if "device paged spec" in g:
        assert g["device paged spec"]["spec"]["accepted"] > 0
        for path in ("device paged spec", "device paged traced"):
            assert g[path]["done"] == g["device paged chunk 4"]["done"]
        assert g["share prefix"]["device"]["done"] == \
            g["share prefix"]["host"]["done"]
        assert g["device paged traced"]["violations"] == []
    compared = 0
    for path in set(g) - {"generate"}:
        pairs = ([(g[path][k], want[path][k]) for k in ("device", "host")]
                 if path == "share prefix" else [(g[path], want[path])])
        for a, b in pairs:
            _same_served(a, b)
            if path in TP_PAGED or path == "share prefix":
                kv = "int8" if path == "device paged int8" else "bf16"
                for r, n in _port_upto(cfg, params, _tp_prompts(path),
                                       b["done"], kv).items():
                    assert a["done"][r][:n] == b["done"][r][:n], (path, r)
                    compared += n
    upto = _generate_upto(cfg, params, want["generate"])
    for b, n in enumerate(upto):
        assert g["generate"][b][:n] == want["generate"][b][:n], b
        compared += n
    assert compared > 0


@pytest.mark.parametrize("m", [2, 4])
def test_reduce_sum_adds_in_rank_order(worlds, m):
    """``comm.reduce_sum`` adds the ranks' float32 tensors in rank order,
    ``((t_0 + t_1) + t_2) + t_3``, the same bits on every rank, one
    collective: over 4 ranks ``1 + 2^-24 + 2^-24 + 0`` is 1.0 (each
    half ulp rounds to even), where the sum from the last rank would be
    ``1 + 2^-23``; over 2 ranks it is ``1 + 2^-24`` = 1.0 too."""
    ts = [np.float32(1.0)] + [np.float32(2.0 ** -24)] * (m - 1)
    if m > 2:
        ts[-1] = np.float32(0.0)
    left = ts[0]
    for t in ts[1:]:
        left = np.float32(left + t)
    right = ts[-1]
    for t in reversed(ts[:-1]):
        right = np.float32(t + right)
    assert m == 2 or left != right
    for res in worlds["results"][m]:
        got = res["sums"]
        assert got["dtype"] == "torch.float32" and got["launches"] == 1
        assert got["sum"] == [[float(left)] * 5] * 3


@pytest.mark.parametrize("m", [2, 4])
def test_tp_each_rank_holds_its_layouts_slices(worlds, m):
    """Under ``tp_params`` each rank holds its layout's slices of the
    narrow config (``tp_layout``: 2 query heads on 1 KV head a rank over
    2, 1 on a shared KV head over 4): the distinct slices of every leaf,
    put together in rank order, are the leaf bitwise; its page pool, int8
    pool (the scale planes by head too) and ring hold every position of
    its KV heads (nothing split over the sequence)."""
    from test_torch_sharding import _pieces, _walk

    cfg = W["NARROW"]
    lay = SH.tp_layout(cfg, m)
    sl = [res["tp"]["slices"] for res in worlds["results"][m]]
    n_pages = PAGED["max_batch"] * PAGED["cache_len"] // PAGED["page_size"]
    pool = (cfg.n_layers, n_pages, PAGED["page_size"], lay.kv_heads,
            cfg.head_dim_)
    ring = (cfg.n_layers, DENSE["max_batch"], DENSE["cache_len"],
            lay.kv_heads, cfg.head_dim_)
    assert lay.attn and lay.kv_heads == 1
    for r, x in enumerate(sl):
        assert x["layout"] == lay and x["index"] == r and x["split"] is None
        assert x["pool"] == [pool] * 2 and x["ring"] == [ring] * 2
        assert x["int8"] == [pool] * 2 + [pool[:-1] + (1,)] * 2
    flat = [list(_walk(x["params"])) for x in sl]
    split = 0
    for i, (names, t) in enumerate(_walk(worlds["params"]["narrow"])):
        pieces = _pieces(lay, names, t.shape)
        if pieces[0] is None:
            assert all(torch.equal(f[i][1], t) for f in flat), names
            continue
        split += 1
        distinct = dict.fromkeys(pieces)
        parts = [flat[pieces.index(p)][i][1] for p in distinct]
        assert torch.equal(torch.cat(parts, pieces[0][0]), t), names
    assert split > 0


def test_tp_over_model_groups_of_one_rank_serves_replicated(worlds):
    """``tp_params`` over the 2x1 mesh of 2 ranks (a data slice a rank,
    model groups of one rank) splits nothing: no ``TensorParallel``,
    every param leaf whole, and the router's streams, routing, drops and
    pools bitwise the replicated 2x1 router's, with no collective of
    tensor parallelism in its steps."""
    for res in worlds["results"][2]:
        assert res["one_rank_tp"] == dict(tp=None, whole=True)
        got, want = res["data"]["tp"]["dense"], res["data"]["dense"]
        assert got["router"] == want["router"]
        assert got["pools"] == want["pools"]


@pytest.mark.parametrize("name", ["dense", "narrow"])
def test_tp_data_slices_over_ranks(worlds, name):
    """The router over the 2x2 mesh of 4 ranks with ``tp_params`` (TP in
    each slice's model pair): every rank alike, the mesh-less 2-shard
    router's routing, drops and served set, each stream its own up to its
    first near tie; each rank's pool holds its KV heads."""
    cfg, params = TP_CFGS[name], worlds["params"][name]
    want = worlds["meshless"]["data"][name]["router"]
    got = [res["data"]["tp"][name] for res in worlds["results"][4]]
    for g in got:
        assert g["router"] == got[0]["router"]
        kv = SH.tp_layout(cfg, 2).kv_heads
        assert len(g["pools"]) == 1
        assert g["pools"][0] * cfg.n_kv_heads == \
            worlds["meshless"]["data"][name]["pools"][0] * kv
    g = got[0]["router"]
    _same_served(g, want)
    for r, n in _port_upto(cfg, params, W["paged_prompts"](),
                           want["done"]).items():
        assert g["done"][r][:n] == want["done"][r][:n], r


@pytest.mark.parametrize("name", ["dense", "narrow"])
def test_tp_router_matches_the_jax_2x2_tp_router(worlds, both, name):
    """The JAX router on a 2x2 mesh of fake devices with ``tp_params``
    against the port's TP router over the 2x2 mesh of 4 ranks: routing,
    drops and the served set equal, each stream up to its first JAX near
    tie (teacher-forced through the JAX model of the config)."""
    jp, jcfg = ((both[0], None) if name == "dense"
                else (worlds["jn"], JAX_NARROW))
    j = worlds["jax"]["2x2 tp" + ("" if name == "dense" else " narrow")]
    prompts = _paged_prompts()
    done_j = {int(k): v for k, v in j["done"].items()}
    upto = _near_tie_upto(jp, prompts, done_j, jcfg)
    assert sum(upto.values()) > 0
    for res in worlds["results"][4]:
        got = res["data"]["tp"][name]["router"]
        assert sorted(got["done"]) == sorted(done_j)
        assert got["assigned"] == j["assigned"]
        assert got["dropped"] == j["dropped"]
        assert got["reasons"] == {int(k): v for k, v in j["reasons"].items()}
        for rid, n in upto.items():
            assert got["done"][rid][:n] == done_j[rid][:n], (rid, n)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``launch.serve --router --page-size 8 --requests 16`` on the CPU over
    ``--ranks 2``, over ``--ranks 2 --tp-params`` and mesh-less, at once:
    each run's stdout lines, and its ``--streams-out`` file's streams
    under ``(name, "streams")``."""
    tmp = tmp_path_factory.mktemp("launched")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
            "--device", "cpu", "--router", "--page-size", "8",
            "--requests", "16"]
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    cmds = {"ranked": base + ["--ranks", "2"],
            "tp": base + ["--ranks", "2", "--tp-params"], "meshless": base}
    cmds = {k: cmd + ["--streams-out", str(tmp / f"{k}.json")]
            for k, cmd in cmds.items()}
    runs = {k: subprocess.Popen(cmd, env=env, cwd=REPO,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
            for k, cmd in cmds.items()}
    outs = {}
    try:
        for k, p in runs.items():
            out, err = p.communicate(timeout=WORLD_TIMEOUT)
            assert p.returncode == 0, out + err
            outs[k] = out.splitlines()
            outs[k, "streams"] = json.loads((tmp / f"{k}.json").read_text())
    finally:
        for p in runs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _served(lines):
    return [x for x in lines if x.startswith("[router] served")][0] \
        .split(" — ")[0]


def test_launcher_serves_over_ranks(launched):
    """``launch.serve --ranks 2`` on the CPU: a gloo world of 2, the 1x2
    mesh, and the mesh-less ``--router`` run's streams (their CRC32)."""
    ranked, meshless = launched["ranked"], launched["meshless"]
    assert "ranks: a world of 2 over gloo (the ranks run on the CPU); rank 0 "\
        "on cpu" in ranked
    assert "router: 1 shard(s) over mesh {'data': 1, 'model': 2} on cpu" \
        in ranked
    crc = [[x for x in o if x.strip().startswith("streams: crc32")]
           for o in (ranked, meshless)]
    assert len(crc[0]) == 1 and crc[0] == crc[1]
    assert _served(ranked) == _served(meshless)
    assert sum(x.startswith("router:") for x in ranked) == 1  # rank 0 alone
    # --streams-out: rank 0 writes every stream, the mesh-less run's
    streams = launched["ranked", "streams"]
    assert streams == launched["meshless", "streams"]
    assert len(streams) == int(_served(ranked).split()[2])


def test_launcher_serves_tp_params_over_ranks(launched):
    """``launch.serve --ranks 2 --tp-params`` on the CPU: the layout
    printed once (the smoke config's attention replicated, its MLP and
    vocab split), the mesh-less run's served and dropped counts and its
    set of streams, a step's ms printed."""
    tp = launched["tp"]
    assert tp.count("tensor parallel over 2 rank(s): attention replicated; "
                    "mlp split (d_ff 48 a rank); embedding and head split "
                    "(128 rows a rank)") == 1
    assert _served(tp) == _served(launched["meshless"])
    timing = [x for x in tp if "ms a step run of rank 0's slice" in x]
    assert len(timing) == 1 and "tensor parallel over 2 rank(s): " in \
        timing[0]
    assert set(launched["tp", "streams"]) == \
        set(launched["meshless", "streams"])
