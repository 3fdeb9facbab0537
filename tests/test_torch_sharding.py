"""The port's sharding rules and meshes against the JAX package's, on the
CPU: every parameter spec of every config at full width (the port's
parameters built under ``FakeTensorMode``: shapes, no memory; the JAX
package's from ``jax.eval_shape``) on abstract 1x2, 2x4, 16x16 and
2x16x16 meshes, the batch, cache, paged, serve and queue specs of the
smoke configs' decode states, ``tests/test_dist.py``'s rule tests and
``tests/test_router.py``'s mesh helpers.  Tolerance: none — a spec is a
tuple of axis names, equal or not.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.dist import sharding as JSH  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.dist.sharding import P  # noqa: E402
from repro_torch.launch.mesh import (data_submeshes,  # noqa: E402
                                     make_production_mesh, make_serve_mesh,
                                     make_smoke_mesh)
from repro_torch.tree import leaves  # noqa: E402


class AbstractMesh:
    """The stand-in both packages' rules read: axis names and sizes."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"1x2": dict(data=1, model=2), "2x4": dict(data=2, model=4),
          "16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}


def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx",
                                                    getattr(p, "name", p))))
                    for p in path)


def _jax_flat(tree, fn) -> dict:
    """{JAX key: tuple(fn(path, leaf))} over a JAX tree."""
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: out.__setitem__(_key(path),
                                           tuple(fn(path, leaf))), tree)
    return out


def _port_flat(tree) -> dict:
    """{key: [tuple(spec) a part]} over a port tree of specs."""
    return {leaf.key: [tuple(s) for s in leaf.parts] for leaf in leaves(tree)}


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch):
    cfg = jax_config(arch)
    return jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The port's float32 masters at full width, as fake tensors."""
    with FakeTensorMode():
        return TM.init_params(get_config(arch), 0, "cpu", masters=True)


# ------------------------------------------------------------ parameters
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax_at_full_width(arch, mesh_key):
    """Every leaf's spec is the JAX leaf's; each layer of a stack takes
    the stacked spec without its leading ``None``."""
    mesh = AbstractMesh(**MESHES[mesh_key])
    want = _jax_flat(_jax_param_shapes(arch),
                     lambda path, leaf: JSH.param_spec(path, leaf, mesh))
    params = _port_params(arch)
    got = _port_flat(SH.param_pspecs(params, mesh))
    assert set(got) == set(want)
    sharded = 0
    for leaf in leaves(params):
        jspec = want[leaf.key]
        if leaf.stacked:
            assert jspec[0] is None, leaf.key
            jspec = jspec[1:]
        assert got[leaf.key] == [jspec] * len(leaf.parts), leaf.key
        sharded += any(a is not None for a in jspec)
    assert sharded > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divisible(arch):
    """Every sharded dim divides the production mesh axis (16x16), on
    the port's own per-layer tensors (``tests/test_dist.py``'s rule)."""
    mesh = make_production_mesh(chips=256, device="cpu")
    params = _port_params(arch)
    shardings = SH.param_shardings(params, mesh)
    for leaf, sh in zip(leaves(params), leaves(shardings)):
        assert leaf.key == sh.key
        for t, s in zip(leaf.parts, sh.parts):
            s.check(t.shape)  # raises if an axis does not divide


# --------------------------------------------------------------- caches
@functools.lru_cache(maxsize=None)
def _decode_pair(arch, B, S):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jstate = jax.eval_shape(lambda: JM.init_decode_state(jcfg, B, S))
    return jstate, TM.init_decode_state(tcfg, B, S, device="cpu")


@pytest.mark.parametrize("mesh_key", ["1x2", "2x4", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_jax(arch, mesh_key):
    """The decode state's every leaf (``cache_pspec``, with the batch
    dividing and not dividing the data axis), ``batch_pspec`` and
    ``queue_pspec``."""
    mesh = AbstractMesh(**MESHES[mesh_key])
    for B in (4, 3):
        jstate, tstate = _decode_pair(arch, B, 32)
        want = _jax_flat(jstate, lambda path, leaf: JSH.cache_pspec(
            path, leaf, mesh, B))
        got = {leaf.key: tuple(SH.cache_pspec(leaf.key, leaf.parts[0], mesh,
                                              B))
               for leaf in leaves(tstate)}
        assert got == want
        if "pod" not in MESHES[mesh_key]:  # on a real mesh of chips too
            real = make_smoke_mesh(MESHES[mesh_key]["data"],
                                   MESHES[mesh_key]["model"], chips=256,
                                   device="cpu")
            placed = SH.cache_shardings(tstate, real, B)
            assert {leaf.key: tuple(leaf.parts[0].spec)
                    for leaf in leaves(placed)} == want
        for n, ndim in ((B, 2), (16, 3), (1, 1)):
            assert tuple(SH.batch_pspec(mesh, n, ndim)) == tuple(
                JSH.batch_pspec(mesh, n, ndim))
            assert tuple(SH.queue_pspec(mesh, n, ndim)) == tuple(
                JSH.queue_pspec(mesh, n, ndim))


PAGED_ARCHS = [a for a in ARCH_IDS
               if not jax_smoke(a).block_pattern
               and jax_smoke(a).family != "encdec"]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_and_serve_specs_equal_jax(arch, kv_dtype):
    """The page pool (``paged_cache_pspec``, ``paged_kv_shardings``) and a
    device batcher's serve state (``serve_pspec``) over the decode state
    and the pool, on every mesh."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    B, n_pages, page = 8, 16, 8
    jkv = jax.eval_shape(lambda: JM.init_paged_kv(jcfg, n_pages, page,
                                                  kv_dtype))
    tkv = TM.init_paged_kv(tcfg, n_pages, page, kv_dtype, device="cpu")
    jpools = [x for x in jax.tree.leaves(jkv)]
    tpools = list(tkv.pools())
    assert [tuple(x.shape) for x in jpools] == [tuple(t.shape)
                                                for t in tpools]
    jstate, tstate = _decode_pair(arch, B, 32)

    def serve_tree(state, pools, arr):
        return {"decode": state, "pages": tuple(pools),
                "free": arr((B,)), "req": arr((B,)), "gen": arr((B,)),
                "pos": arr((B,)), "plen": arr((B,)), "feat": arr((B, 7)),
                "pbuf": arr((B, 32)), "tbl": arr((B, 4)),
                "pfree": arr((n_pages,)), "pref": arr((n_pages,)),
                "out_tok": arr((64, 8)), "out_done": arr((64,)),
                "out_tbl": arr((64, 4)), "head": arr(()),
                "qidx": arr((B,)), "seed": arr((B,))}

    jtree = serve_tree(jstate, jpools,
                       lambda s: jax.ShapeDtypeStruct(s, jnp.int32))
    ttree = serve_tree(tstate, tpools,
                       lambda s: torch.zeros(s, dtype=torch.int32))
    for spec in MESHES.values():
        mesh = AbstractMesh(**spec)
        for j, t in zip(jpools, tpools):
            assert tuple(SH.paged_cache_pspec(t, mesh)) == tuple(
                JSH.paged_cache_pspec(j, mesh))
        want = _jax_flat(jtree, lambda path, leaf: JSH.serve_pspec(
            path, leaf, mesh, B))
        got = {leaf.key: tuple(SH.serve_pspec(leaf.key, leaf.parts[0], mesh,
                                              B))
               for leaf in leaves(ttree)}
        assert got == want
    real = make_smoke_mesh(2, 2, chips=4, device="cpu")
    sh = SH.paged_kv_shardings(tkv, real)
    for t, s in zip(tpools, sh.pools()):
        assert tuple(s.spec) == tuple(JSH.paged_cache_pspec(t, real))
    assert sh.block_tbl is None


# ------------------------------------------- tests/test_dist.py's rules
def test_batch_pspec():
    mesh = AbstractMesh(data=16, model=16)
    assert SH.batch_pspec(mesh, 256, 2) == P("data", None)
    assert SH.batch_pspec(mesh, 1, 2) == P(None, None)
    mesh_mp = AbstractMesh(pod=2, data=16, model=16)
    assert SH.batch_pspec(mesh_mp, 256, 2) == P(("pod", "data"), None)


def test_cache_pspec_rules():
    """Sequence over model, a batch not dividing replicates, and a mesh
    narrower than (data, model) degrades the absent axis."""
    mesh = AbstractMesh(data=16, model=16)
    leaf = torch.empty((4, 128, 2048, 2, 64), device="meta")
    assert SH.cache_pspec((), leaf, mesh, 128) == P(
        None, "data", "model", None, None)
    leaf = torch.empty((4, 3, 2048, 2, 64), device="meta")
    assert SH.cache_pspec((), leaf, mesh, 3) == P(
        None, None, "model", None, None)
    leaf = torch.empty((4, 3, 100, 2, 64), device="meta")
    assert SH.cache_pspec((), leaf, mesh, 3) == P(*[None] * 5)
    leaf = torch.empty((4, 8, 64, 2, 64), device="meta")
    assert SH.cache_pspec((), leaf, AbstractMesh(model=8), 8) == P(
        None, None, "model", None, None)
    assert SH.cache_pspec((), leaf, AbstractMesh(data=8), 8) == P(
        None, "data", None, None, None)
    assert SH.batch_pspec(AbstractMesh(model=8), 64, 2) == P(None, None)


def test_cache_shardings_place_on_small_mesh():
    """A decode state whose batch does not divide the data axis still
    places (replicated batch dim), on a real 2x1 mesh of logical chips."""
    mesh = make_smoke_mesh(2, 1, chips=2, device="cpu")
    cfg = get_smoke_config("qwen2_1_5b")
    for batch in (3, 4):
        state = TM.init_decode_state(cfg, batch, 64, device="cpu")
        shardings = SH.cache_shardings(state, mesh, batch)
        placed = shardings["kv"][0].place(state["kv"][0])
        assert placed.device == mesh.device
        assert shardings["kv"][0].spec[1] == ("data" if batch == 4 else None)


def test_serve_pspec_rules():
    mesh = AbstractMesh(data=8, model=16)
    B, R, T = 16, 32, 8
    st = {"decode": {"kv": torch.empty((4, B, 2048, 2, 64), device="meta")},
          "free": torch.empty((B,)), "gen": torch.empty((B,)),
          "feat": torch.empty((B, 7)), "head": torch.empty(()),
          "out_tok": torch.empty((R, T)), "out_done": torch.empty((R,)),
          "pages": (torch.empty((4, 64, 32, 2, 64), device="meta"),),
          "pbuf": torch.empty((B, 32)), "tbl": torch.empty((B, 4)),
          "pfree": torch.empty((64,))}
    specs = {leaf.key: SH.serve_pspec(leaf.key, leaf.parts[0], mesh, B)
             for leaf in leaves(st)}
    assert specs["decode/kv"] == P(None, "data", "model", None, None)
    assert specs["free"] == P("data") and specs["gen"] == P("data")
    assert specs["feat"] == P("data", None)
    assert specs["head"] == P()
    assert specs["out_tok"] == P(None, None) and specs["out_done"] == P(None)
    assert specs["pages/0"] == P(None, "data", "model", None, None)
    assert specs["pbuf"] == P("data", None) and specs["tbl"] == P("data", None)
    assert specs["pfree"] == P(None)
    assert SH.queue_pspec(mesh, 64, 2) == P("data", None)
    assert SH.queue_pspec(mesh, 9, 2) == P(None, None)


def test_paged_cache_pspec_rules():
    mesh = AbstractMesh(data=8, model=16)
    assert SH.paged_cache_pspec(torch.empty((4, 64, 32, 2, 64),
                                            device="meta"), mesh) == P(
        None, "data", "model", None, None)
    assert SH.paged_cache_pspec(torch.empty((4, 63, 20, 2, 64),
                                            device="meta"), mesh) == P(
        None, None, None, None, None)
    assert SH.paged_cache_pspec(torch.empty((64, 32)), mesh) == P(None, None)


def test_named_sharding_validates_its_leaf():
    """``NamedSharding.check``: an axis off the mesh, a dim it does not
    divide, too many entries or an axis twice are refused; ``place`` puts
    the leaf on the mesh's device whole."""
    mesh = make_smoke_mesh(2, 4, chips=8, device="cpu")
    t = torch.zeros(8, 12)
    ok = SH.NamedSharding(mesh, P("data", "model"))
    assert ok.place(t).shape == t.shape
    for spec, match in ((P("pod", None), "not on the mesh"),
                        (P(None, None, None), "entries"),
                        (P("model", "model"), "twice"),
                        (P(None, ("data", "model")), "does not divide")):
        with pytest.raises(ValueError, match=match):
            SH.NamedSharding(mesh, spec).check(t.shape)


# --------------------------------------------------------------- meshes
def test_mesh_helpers():
    """``tests/test_router.py``'s mesh helpers on the port, with ``chips``
    (logical chips on the one device) for the fake-device flag."""
    with pytest.raises(ValueError):
        make_serve_mesh("not-a-mesh", device="cpu")
    with pytest.raises(RuntimeError):
        make_serve_mesh("2x2", device="cpu")  # one CPU device
    mesh = make_serve_mesh("auto", device="cpu")
    subs = data_submeshes(mesh)
    assert len(subs) == 1 and int(subs[0].shape["model"]) == 1
    mesh = make_serve_mesh("2x4", chips=8, device="cpu")
    subs = data_submeshes(mesh)
    assert [s.device_ids() for s in subs] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(dict(s.shape) == {"data": 1, "model": 4} for s in subs)
    with pytest.raises(ValueError, match="serve meshes are"):
        data_submeshes(make_production_mesh(multi_pod=True, chips=512,
                                            device="cpu"))


def test_production_mesh_needs_its_chips():
    with pytest.raises(RuntimeError, match="mesh needs 256 devices, found 1"):
        make_production_mesh(device="cpu")
    mesh = make_production_mesh(multi_pod=True, chips=512, device="cpu")
    assert dict(mesh.shape) == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512 and mesh.device == torch.device("cpu")
    assert SH.data_axis(mesh) == ("pod", "data")
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        make_smoke_mesh(2, 2, device="cpu")
    np.testing.assert_array_equal(
        make_smoke_mesh(2, 2, chips=4, device="cpu").devices,
        np.arange(4).reshape(2, 2))
