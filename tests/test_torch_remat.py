"""``remat_policy="dots"`` in the port against the JAX package and
against ``"full"``, on the CPU (ROADMAP queue A item 13): one train step
of the qwen2-1.5b and qwen2-moe-a2.7b smoke configs from the JAX
package's masters (``arch.convert``) and the same tokens (numpy, from a
seed).  Tolerances, each with its reason:

* against the JAX train step at ``"dots"``: the loss within 1e-3
  relative (``tests/test_torch_train.py``'s bound: bf16 products rounded
  at other places by XLA and by torch);
* against the port's ``"full"``: bitwise, the loss and every updated
  master (both run the same products on the same rows; ``"dots"`` saves
  their outputs where ``"full"`` computes them again).

``tests/test_torch_train.py`` ``test_remat_policies`` holds ``loss_fn``'s
gradients under the three policies bitwise.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train.step import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.arch.convert import (arrays_from_master_params,  # noqa: E402
                                      master_params_from_arrays)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train.step import TrainConfig, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "qwen2-1.5b"
LOSS_RTOL = 1e-3


def _jax_masters(seed, cfg):
    """(JAX masters, the port's masters carried across)."""
    jp = JM.init_params(cfg[0], jax.random.PRNGKey(seed))
    return jp, master_params_from_arrays(jax.tree.map(np.asarray, jp),
                                         cfg[1], "cpu")


def _flat_port(tree) -> dict:
    return {leaf.key: np.stack([p.detach().float().numpy().copy()
                                for p in leaf.parts]) if leaf.stacked
            else leaf.parts[0].detach().float().numpy().copy()
            for leaf in leaves(tree)}


@pytest.mark.parametrize("arch", [ARCH, "qwen2-moe-a2.7b"])
def test_dots_step_matches_jax_and_full(arch):
    """One train step under ``remat_policy="dots"`` (ROADMAP queue A item
    13), dense and MoE smoke configs: the loss within LOSS_RTOL of the JAX
    train step's at ``"dots"`` from the same masters; the loss and every
    updated master bitwise the port's ``"full"`` step's; the products
    called once a microbatch under ``"dots"`` (none in the backward), and
    again for every layer under ``"full"``."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp, tp = _jax_masters(0, (jcfg, tcfg))
    tokens = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    jt = JaxTrainConfig(microbatches=2, q_block=16, remat_policy="dots")
    jstate = {"opt": JOPT.init(jp), "step": jnp.zeros((), jnp.int32)}
    _, _, jl = jax.jit(jax_make_step(jcfg, jt))(
        jp, jstate, {"tokens": jnp.asarray(tokens)})
    mod = sys.modules["repro_torch.kernels.linear"]
    real, calls = mod._forward, []
    with torch.no_grad():  # one microbatch's forward: its products
        mod._forward = lambda *a: calls.append(1) or real(*a)
        try:
            TM.forward(tp, {"tokens": torch.from_numpy(tokens[:2])}, tcfg,
                       q_block=16)
        finally:
            mod._forward = real
    fwd, out = len(calls), {}
    for policy in ("full", "dots"):
        ps = master_params_from_arrays(arrays_from_master_params(tp), tcfg,
                                       "cpu")
        cfg_t = TrainConfig(microbatches=2, q_block=16, remat_policy=policy)
        st = {"opt": TOPT.init(ps, cfg_t.adamw),
              "step": torch.zeros((), dtype=torch.int32)}
        calls.clear()
        mod._forward = lambda *a: calls.append(1) or real(*a)
        try:
            ps, st, loss = make_train_step(tcfg, cfg_t)(
                ps, st, {"tokens": torch.from_numpy(tokens)})
        finally:
            mod._forward = real
        out[policy] = (loss, _flat_port(ps), len(calls))
    assert abs(out["dots"][0].item() - float(jl)) <= LOSS_RTOL * abs(
        float(jl))
    assert torch.equal(out["dots"][0], out["full"][0])
    for k, v in out["full"][1].items():
        np.testing.assert_array_equal(out["dots"][1][k], v, err_msg=k)
    assert out["dots"][2] == 2 * fwd
    assert out["full"][2] == 2 * (2 * fwd - 1)  # all but the head again
