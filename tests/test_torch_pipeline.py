"""The port's GPipe step against the JAX package's and against the port's
own ``loss_fn``, on the CPU, and ``split_layers_for_stages`` /
``staged_pspecs`` / the refusals (``tests/test_dist.py``'s).

Both steps start from the same masters (the JAX package's random init,
carried across with ``arch.convert``) and the same tokens (numpy, from a
seed); the JAX step is called in-process with an explicit ``n_stages``
and the specs of an abstract mesh.  Tolerances, each with its reason:

* against JAX: the loss within 1e-3 relative, each gradient leaf within
  0.05 of the JAX leaf's largest magnitude (``tests/test_torch_train.py``'s
  bounds: bf16 products rounded at other places by XLA and by torch);
* against the port's ``loss_fn`` on each microbatch: the loss within one
  float32 rounding of the mean (the same layers in the same order, the
  microbatches' losses summed as the schedule sums them) and the
  gradients within 1e-6 of each leaf's largest magnitude (autograd adds
  the microbatches' contributions in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.ckpt.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.dist import pipeline as JPP  # noqa: E402
from repro.dist import sharding as JSH  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.arch.convert import master_params_from_arrays  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.dist import pipeline as PP  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

LOSS_RTOL = 1e-3
GRAD_TOL = 0.05


class AbstractMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _masters(arch):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, master_params_from_arrays(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _flat_grads(grads) -> dict:
    """The port's staged gradient tree as the JAX package's flat keys of
    its ``split_layers_for_stages`` tree (``stages/<s>/...``)."""
    return {leaf.key: np.stack([g.numpy() for g in leaf.parts])
            if leaf.stacked else leaf.parts[0].numpy()
            for leaf in leaves(grads)}


@pytest.mark.parametrize("arch,n_stages,n_micro", [("qwen3_32b", 2, 2)])
def test_pipeline_step_matches_jax(arch, n_stages, n_micro):
    """``tests/test_pipeline_and_dryrun.py``'s GPipe case (qwen3-32b smoke,
    2 stages; 2 microbatches, where that test takes 4: the JAX compile of
    the unrolled schedule grows with them): loss and every gradient
    against the JAX step's.  The MoE family is held to ``loss_fn``
    below."""
    jcfg, tcfg, jp, tp = _masters(arch)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (8, 16)).astype(np.int32)
    mesh = AbstractMesh(pod=n_stages, data=2, model=2)
    jstep, _ = JPP.make_pipeline_step(
        jcfg, mesh, JSH.param_pspecs(jp, mesh), n_stages=n_stages,
        n_micro=n_micro, q_block=16)
    jloss, jgrads = jax.jit(jstep)(JPP.split_layers_for_stages(jp, n_stages),
                                   {"tokens": jnp.asarray(tokens)})
    step, specs = PP.make_pipeline_step(
        tcfg, mesh, SH.param_pspecs(tp, mesh), n_micro=n_micro, q_block=16)
    staged = PP.split_layers_for_stages(tp, n_stages)
    loss, grads = step(staged, {"tokens": torch.from_numpy(tokens)})
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    got, want = _flat_grads(grads), jax_flatten(jgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        err = np.abs(got[k] - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (k, err)
    # the specs mirror the staged tree, stage by stage
    assert [len(s) for s in specs["stages"]] == [
        len(s) for s in staged["stages"]]


@pytest.mark.parametrize("arch,n_stages,remat", [
    ("gemma3_27b", 3, False), ("gemma3_27b", 3, True),
    ("qwen2_moe_a2_7b", 2, False)])
def test_pipeline_step_matches_loss_fn(arch, n_stages, remat):
    """The schedule computes the unpipelined objective: the microbatches'
    mean of ``loss_fn`` (the MoE aux loss included), and its gradient
    (``remat`` recomputes each layer and changes nothing); gemma3-27b's
    smoke config has 6 layers, local and global."""
    _, tcfg, _, tp = _masters(arch)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (6, 12)).astype(np.int32))
    mesh = make_production_mesh(multi_pod=True, chips=512, device="cpu")
    step, _ = PP.make_pipeline_step(tcfg, mesh, SH.param_pspecs(tp, mesh),
                                    n_stages=n_stages, n_micro=3, q_block=8,
                                    remat=remat)
    loss, grads = step(PP.split_layers_for_stages(tp, n_stages),
                       {"tokens": tokens})
    ps = [p.requires_grad_(True) for leaf in leaves(tp) for p in leaf.parts]
    ref = sum(TM.loss_fn(tp, {"tokens": tokens[2 * m:2 * m + 2]}, tcfg,
                         q_block=8) for m in range(3)) / 3
    want = torch.autograd.grad(ref, ps)
    assert abs(loss.item() - ref.item()) <= 2 * np.finfo(np.float32).eps * \
        abs(ref.item())
    by_key: dict = {}  # the reference's gradient parts by JAX key
    it = iter(want)
    for leaf in leaves(tp):
        by_key[leaf.key] = [next(it) for _ in leaf.parts]
    got: dict = {}  # the staged gradients, stage after stage, by that key
    for leaf in leaves(grads):
        key = leaf.key
        if key.startswith("stages/"):
            key = "layers/" + key.split("/", 2)[2]
        got.setdefault(key, []).extend(leaf.parts)
    assert set(got) == set(by_key)
    for k, ws in by_key.items():
        assert len(got[k]) == len(ws), k
        for g, w in zip(got[k], ws):
            tol = 1e-6 * w.abs().max().item()
            assert (g - w).abs().max().item() <= tol, k


def test_split_layers_for_stages_structure():
    """The split re-cuts the layer list; specs stay per layer
    (``tests/test_dist.py``'s)."""
    _, tcfg, _, tp = _masters("gemma3_27b")
    mesh = AbstractMesh(data=16, model=16)
    staged = PP.split_layers_for_stages(tp, 3)
    assert "layers" not in staged and len(staged["stages"]) == 3
    for s, stage in enumerate(staged["stages"]):
        assert len(stage) == 2
        assert stage[0] is tp["layers"][2 * s]  # the same tensors
    specs = PP.staged_pspecs(SH.param_pspecs(tp, mesh), 3)
    assert [leaf.key for leaf in leaves(specs)] == [
        leaf.key for leaf in leaves(staged)]
    for sl, tl in zip(leaves(specs), leaves(staged)):
        assert len(sl.parts) == len(tl.parts)
    with pytest.raises(ValueError):
        PP.split_layers_for_stages(tp, 4)  # 6 % 4 != 0
    assert PP.n_pipeline_stages(AbstractMesh(pod=2, data=4)) == 2
    assert PP.n_pipeline_stages(AbstractMesh(data=4)) == 1
    with pytest.raises(ValueError):
        PP.n_pipeline_stages(mesh, 0)


@pytest.mark.parametrize("arch", ["internvl2_2b", "seamless_m4t_large_v2",
                                  "xlstm_125m", "recurrentgemma_9b"])
def test_pipeline_refuses_what_jax_refuses(arch):
    """The VLM, enc-dec and ``block_pattern`` families are refused with
    the JAX package's message."""
    mesh = AbstractMesh(data=16, model=16)
    with pytest.raises(NotImplementedError) as want:
        JPP.make_pipeline_step(jax_smoke(arch), mesh, {}, n_stages=1)
    with pytest.raises(NotImplementedError) as got:
        PP.make_pipeline_step(get_smoke_config(arch), mesh, {}, n_stages=1)
    assert str(got.value) == str(want.value)
    if get_smoke_config(arch).block_pattern:
        with pytest.raises(NotImplementedError, match="stacked-'layers'"):
            PP.split_layers_for_stages(
                TM.init_params(get_smoke_config(arch), 0, "cpu",
                               masters=True), 1)
