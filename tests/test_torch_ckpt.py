"""The port's checkpoint manager: mirrors of ``tests/test_ckpt.py`` on
torch trees, and checkpoints carried between the two packages.

The port writes the JAX package's layout (keys, stacked layer leaves,
dtypes, CRC32 manifest), so each package restores what the other wrote:
the port's ``restore_flat`` and ``restore`` read a checkpoint of the JAX
launcher's train state, and ``master_params_from_arrays`` carries its
parameters across bitwise; the JAX manager restores a port checkpoint of
a layered tree into its stacked tree, bitwise.
"""
import json
import os
import zipfile
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.dist.elastic import corrupt_checkpoint  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro_torch.arch.convert import master_params_from_arrays  # noqa: E402
from repro_torch.ckpt.manager import (CheckpointCorrupt,  # noqa: E402
                                      CheckpointManager, CheckpointWriteError,
                                      config_hash)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def _tree(seed=0):
    """``tests/test_ckpt.py``'s tree, as tensors."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(0, 1, (8, 8)).astype(
            np.float32)),
            "layers": {"b": torch.arange(6, dtype=torch.int32)}},
        "state": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _same(a, b):
    la, lb = leaves(a), leaves(b)
    assert [x.key for x in la] == [y.key for y in lb]
    for x, y in zip(la, lb):
        for p, q in zip(x.parts, y.parts):
            assert p.dtype == q.dtype and torch.equal(p, q), x.key


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(7, tree)
    _same(mgr.restore(7, _zeros_like(tree)), tree)


def test_roundtrip_layers_bf16_and_namedtuple(tmp_path):
    """A list of layers is stored stacked under the JAX names and split
    back; bf16 leaves keep their bits; an ``AdamWState`` is keyed by its
    fields (``.m``, ``.v``, ``.count``) as JAX keys its NamedTuple."""
    rng = np.random.default_rng(1)
    layers = [{"w": torch.from_numpy(rng.normal(0, 1, (3, 4)).astype(
        np.float32)).to(torch.bfloat16), "ln": torch.randn(4)}
        for _ in range(3)]
    tree = {"params": {"layers": layers},
            "state": {"opt": TOPT.init({"layers": layers},
                                       TOPT.AdamWConfig(m_dtype="bf16"))}}
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(2, tree)
    manifest = json.loads((tmp_path / "step_000000002" / "manifest.json"
                           ).read_bytes())["leaves"]
    assert manifest["params/layers/w"] == {"shape": [3, 3, 4],
                                           "dtype": "bfloat16"}
    assert set(manifest) == {"params/layers/w", "params/layers/ln",
                             "state/opt/.m/layers/w", "state/opt/.m/layers/ln",
                             "state/opt/.v/layers/w", "state/opt/.v/layers/ln",
                             "state/opt/.count"}
    target = {"params": {"layers": [{k: torch.zeros_like(v) for k, v in
                                     l.items()} for l in layers]},
              "state": {"opt": TOPT.init({"layers": layers},
                                         TOPT.AdamWConfig(m_dtype="bf16"))}}
    _same(mgr.restore(2, target), tree)


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.list_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_writes=True)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    mgr.wait()
    assert mgr.latest_step() == 2
    r = mgr.restore(2, _zeros_like(_tree()))
    assert int(r["state"]["step"]) == 7


def test_async_save_snapshots_at_save(tmp_path):
    """An async save copies host tensors at ``save``: an in-place update
    right after it does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_writes=True)
    tree = _tree(3)
    want = tree["params"]["w"].clone()
    mgr.save(1, tree)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore(1, _zeros_like(tree))["params"]["w"],
                       want)


def test_partial_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _tree())
    os.makedirs(str(tmp_path / "step_000000009.tmp"))
    assert mgr.list_steps() == [5]


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, bad)


def test_stale_tmp_removed_on_init(tmp_path):
    stale = tmp_path / "step_000000009.tmp"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"half a write")
    CheckpointManager(str(tmp_path), keep=3)
    assert not stale.exists()


def test_crc_recorded_in_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    d = tmp_path / "step_000000001"
    manifest = json.loads((d / "manifest.json").read_bytes())
    rec = manifest["files"]["arrays.npz"]
    payload = (d / "arrays.npz").read_bytes()
    assert rec["crc32"] == zlib.crc32(payload)
    assert rec["bytes"] == len(payload)
    assert int((d / "manifest.crc32").read_text()) == \
        zlib.crc32((d / "manifest.json").read_bytes())
    assert mgr.verify(1) == []


def test_async_write_failure_surfaces_without_poisoning(tmp_path,
                                                        monkeypatch):
    import repro_torch.ckpt.manager as mod
    real_savez = mod.np.savez
    calls = {"n": 0}

    def flaky_savez(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk detached")
        return real_savez(*a, **k)

    monkeypatch.setattr(mod.np, "savez", flaky_savez)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_writes=True)
    mgr.save(1, _tree(1))  # background write fails
    with pytest.raises(CheckpointWriteError, match="step 1"):
        mgr.save(2, _tree(2))
    mgr.save(2, _tree(2))  # manager not poisoned: clean retry works
    mgr.wait()
    assert mgr.latest_step() == 2
    assert mgr.verify(2) == []


@pytest.mark.parametrize("what,expect", [
    ("arrays", "truncated|CRC32"),
    ("manifest", "manifest"),
    ("leaf", "CRC32|bytes"),
])
def test_corruption_detected_on_restore(tmp_path, what, expect):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(1, tree)
    corrupt_checkpoint(str(tmp_path), 1, what)
    assert mgr.verify(1) != []
    with pytest.raises(CheckpointCorrupt, match=expect):
        mgr.restore(1, _zeros_like(tree))
    assert mgr.latest_valid_step() is None


def test_missing_leaf_detected_by_membership(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(1, tree)
    d = tmp_path / "step_000000001"
    arrays = d / "arrays.npz"
    with zipfile.ZipFile(arrays) as zf:
        names = zf.namelist()
        keep = {n: zf.read(n) for n in names[1:]}
    with zipfile.ZipFile(arrays, "w", zipfile.ZIP_STORED) as zf:
        for n, blob in keep.items():
            zf.writestr(n, blob)
    manifest = json.loads((d / "manifest.json").read_bytes())
    manifest["files"]["arrays.npz"] = {
        "crc32": zlib.crc32(arrays.read_bytes()),
        "bytes": arrays.stat().st_size}
    blob = json.dumps(manifest).encode()
    (d / "manifest.json").write_bytes(blob)
    (d / "manifest.crc32").write_text(str(zlib.crc32(blob)))
    with pytest.raises(CheckpointCorrupt, match="missing from arrays.npz"):
        mgr.restore(1, _zeros_like(tree))


def test_latest_valid_step_falls_back_past_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    corrupt_checkpoint(str(tmp_path), 3, "manifest")
    assert mgr.latest_step() == 3
    assert mgr.latest_valid_step() == 2
    r = mgr.restore(2, _zeros_like(_tree()))
    assert torch.equal(r["params"]["w"], _tree(2)["params"]["w"])


def test_restore_with_sharding_names_item_10(tmp_path):
    """Restoring onto a mesh (``shardings=``, ROADMAP queue A item 10a):
    a train state written on a 1x2 mesh comes back on a 2x2 one bit for
    bit (``tests/test_pipeline_and_dryrun.py``'s elastic handoff), each
    leaf validated against its sharding; a sharding its leaf does not
    divide, or a tree that does not mirror the target, is refused."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_smoke_mesh

    cfg = get_smoke_config("qwen2-1.5b")
    jp = JM.init_params(jax_smoke("qwen2-1.5b"), jax.random.PRNGKey(3))
    params = master_params_from_arrays(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")
    state = {"opt": TOPT.init(params), "step": torch.tensor(
        6, dtype=torch.int32)}
    tree = {"params": params, "state": state}
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(6, tree)
    mesh = make_smoke_mesh(2, 2, chips=4, device="cpu")
    rep = SH.NamedSharding(mesh, SH.P())
    sh = {"params": SH.param_shardings(params, mesh),
          "state": {"opt": TOPT.AdamWState(
              m=SH.param_shardings(params, mesh),
              v=SH.param_shardings(params, mesh), count=rep), "step": rep}}
    target = {"params": master_params_from_arrays(
        jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), jp), cfg,
        "cpu"), "state": {"opt": TOPT.init(params), "step": torch.tensor(
            0, dtype=torch.int32)}}
    _same(mgr.restore(6, target, shardings=sh), tree)
    assert sh["params"]["embed"].spec == SH.P("model", None)
    bad = dict(sh, state={"opt": sh["state"]["opt"],
                          "step": SH.NamedSharding(mesh, SH.P("data"))})
    with pytest.raises(ValueError, match="entries"):
        mgr.restore(6, target, shardings=bad)
    with pytest.raises(ValueError, match="do not mirror"):
        mgr.restore(6, target, shardings={"params": sh["params"]})


def test_config_hash_equals_jax():
    from repro.ckpt.manager import config_hash as jax_hash

    for obj in ((get_smoke_config("qwen2-1.5b"), 2, 64, 8), "x", 3):
        want = jax_hash((jax_smoke("qwen2-1.5b"), 2, 64, 8)
                        if isinstance(obj, tuple) else obj)
        assert config_hash(obj) == want


# ------------------------------------------------- between the packages
def _jax_train_state():
    cfg = jax_smoke("qwen2-1.5b")
    params = JM.init_params(cfg, jax.random.PRNGKey(5))
    opt = JOPT.init(params)
    opt = opt._replace(m=jax.tree.map(lambda p: p * 0.5, params),
                       v=jax.tree.map(lambda p: p * p, params),
                       count=jnp.int32(4))
    return {"params": params, "state": {"opt": opt,
                                        "step": jnp.int32(4)}}


def test_port_reads_a_jax_checkpoint(tmp_path):
    """The JAX launcher's tree, saved by the JAX manager: the port's
    ``restore_flat`` gives its arrays under its keys, the port's
    ``restore`` fills a port train state bitwise, and
    ``master_params_from_arrays`` carries the parameters across."""
    jtree = _jax_train_state()
    JaxManager(str(tmp_path)).save(4, jtree)
    mgr = CheckpointManager(str(tmp_path))
    flat = mgr.restore_flat(4)
    from repro.ckpt.manager import _flatten

    want = _flatten(jtree)
    assert set(flat) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(flat[k], a, err_msg=k)
    cfg = get_smoke_config("qwen2-1.5b")
    np_params = jax.tree.map(np.asarray, jtree["params"])
    masters = master_params_from_arrays(np_params, cfg, "cpu")
    target = {"params": masters,
              "state": {"opt": TOPT.init(masters),
                        "step": torch.zeros((), dtype=torch.int32)}}
    got = mgr.restore(4, target)
    assert int(got["state"]["step"]) == 4
    assert int(got["state"]["opt"].count) == 4
    for tree, key in ((got["params"], "params"),
                      (got["state"]["opt"].m, "state/opt/.m"),
                      (got["state"]["opt"].v, "state/opt/.v")):
        for leaf in leaves(tree):
            stored = flat[f"{key}/{leaf.key}"]
            parts = list(stored) if leaf.stacked else [stored]
            for p, a in zip(leaf.parts, parts):
                np.testing.assert_array_equal(p.numpy(), a)
    for leaf in leaves(masters):
        stored = flat[f"params/{leaf.key}"]
        parts = list(stored) if leaf.stacked else [stored]
        for p, a in zip(leaf.parts, parts):
            np.testing.assert_array_equal(p.numpy(), a)


def test_jax_reads_a_port_checkpoint(tmp_path):
    """A port train state (layers as a list) saved by the port: the JAX
    manager restores it into the JAX package's stacked tree, bitwise."""
    jtree = _jax_train_state()
    cfg = get_smoke_config("qwen2-1.5b")
    np_tree = jax.tree.map(np.asarray, jtree)
    masters = master_params_from_arrays(np_tree["params"], cfg, "cpu")
    opt = TOPT.AdamWState(
        m=master_params_from_arrays(np_tree["state"]["opt"].m, cfg, "cpu"),
        v=master_params_from_arrays(np_tree["state"]["opt"].v, cfg, "cpu"),
        count=torch.tensor(4, dtype=torch.int32))
    CheckpointManager(str(tmp_path)).save(
        4, {"params": masters,
            "state": {"opt": opt, "step": torch.tensor(4,
                                                       dtype=torch.int32)}})
    got = JaxManager(str(tmp_path)).restore(
        4, jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
