"""The port's MoE family (``repro_torch.nn.moe`` and the MoE paths of
``arch.model``) against the JAX package, on the CPU.

Smoke configs ``qwen2-moe-smoke`` (6 experts padded to 16, top-2, a shared
MLP) and ``moonshot-smoke`` (8 experts padded to 16, top-2); the JAX
package's random-init weights are carried across with ``arch.convert``,
inputs are made from a seed with numpy.

Tolerances: a block's bf16 output within ``OUT_TOL`` (3%) of its largest
JAX magnitude, the aux loss within 1e-5 relative, logits as in
``test_torch_serve.py`` (``LOGIT_TOL`` of the JAX logits' largest
magnitude; greedy equal beyond the near-tie margin): the bf16 roundings
of the two frameworks land in other places.  The top-k indices equal
JAX's (ties to the lower expert, as ``jax.lax.top_k``) on the same
logits.  Through a model the routing is discontinuous: where a token's
k-th and (k+1)-th router logits are within a rounding of each other, a
one-ulp difference upstream picks the other expert.  So the model tests
record both packages' top-k at every layer (``_Routing``) and require
that every token routed otherwise than in JAX is a routing near tie (its
k-th and (k+1)-th logits in the port within ``2 LOGIT_TOL`` of the
token's largest logit), and hold the logits to the tolerance at every
position before its sequence's first such token (its causal future sees
the other expert's output), at least half of them.  The port against
itself (chunked prefill, host vs device, paged vs dense): bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.ckpt.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.nn import moe as JMoE  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.arch.convert import (arrays_from_master_params,  # noqa: E402
                                      master_params_from_arrays,
                                      params_from_arrays)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.nn import moe as TMoE  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_serve import (DS, LOGIT_TOL, _near_tie_bound,  # noqa: E402
                              _top2_margin)
from test_torch_train import GRAD_TOL, LOSS_RTOL  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]
OUT_TOL = 0.03
AUX_RTOL = 1e-5
DRAWS = 6  # token draws of the training test, default_rng(0 .. 5), 2 x 16


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    """(arch, JAX cfg, port cfg, JAX masters, numpy masters, port compute
    params)."""
    arch = request.param
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    npt = jax.tree.map(np.asarray, jp)
    return arch, jcfg, cfg, jp, npt, params_from_arrays(npt, cfg, "cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got: torch.Tensor, want, tol=OUT_TOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _jax_layer(jp, i=0):
    return jax.tree.map(lambda a: a[i], jp["layers"]["moe"])


def _check_logits(lt: np.ndarray, lj: np.ndarray, keep=None) -> None:
    """Rows within ``LOGIT_TOL`` of max |JAX logits|, greedy equal where
    the JAX top-2 margin is clear; ``keep`` (bool per row) selects the
    rows before their sequence's first routing flip, at least half."""
    assert lt.shape == lj.shape
    if keep is not None:
        assert keep.mean() >= 0.5, keep.mean()
        lt, lj = lt[keep], lj[keep]
    diff = np.abs(lt - lj).max(-1)
    assert (diff <= LOGIT_TOL * np.abs(lj).max(-1)).all(), diff.max()
    clear = _top2_margin(lj) > _near_tie_bound(lj)
    np.testing.assert_array_equal(lt.argmax(-1)[clear], lj.argmax(-1)[clear])
    assert clear.mean() >= 0.25  # the smoke vocab's logits: many near ties


class _Routing:
    """Both packages' top-k expert sets at every MoE call of a model run:
    the JAX block is wrapped (``jax.debug.callback``, keyed to its layer
    by the router's first values, so scan order does not matter) and so is
    the port's ``nn.moe.route``, which also records each token's routing
    margin (k-th minus (k+1)-th router logit) and near-tie bound."""

    def __init__(self, monkeypatch, npt):
        self.jax, self.port = [], []
        keys = [np.asarray(r[:2, 0]) for r in npt["layers"]["moe"]["router"]]

        def layer(key):
            return next(i for i, k in enumerate(keys)
                        if np.array_equal(k, np.asarray(key)))

        def wrap(real):
            def block(p, x, *, n_experts, top_k, **kw):
                logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
                E = logits.shape[-1]
                logits = jnp.where(jnp.arange(E) >= n_experts, -1e30, logits)
                _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), top_k)
                jax.debug.callback(
                    lambda key, i: self.jax.append(
                        (layer(key), np.sort(np.asarray(i), -1))),
                    p["router"][:2, 0], idx)
                return real(p, x, n_experts=n_experts, top_k=top_k, **kw)
            return block

        monkeypatch.setattr(JM, "moe_block", wrap(JM.moe_block))
        monkeypatch.setattr(JM, "moe_block_sparse", wrap(JM.moe_block_sparse))
        real_route = TMoE.route

        def route(x, router, n_experts, top_k):
            out = real_route(x, router, n_experts, top_k)
            with torch.no_grad():
                logits = ref.linear_ref(x, router.to(x.dtype)).float()
            top = logits[..., :n_experts].sort(-1, descending=True).values
            gap = (top[..., top_k - 1] - top[..., top_k]).numpy()
            bound = 2 * LOGIT_TOL * logits[..., :n_experts].abs().amax(-1)
            self.port.append((np.sort(out[1].numpy(), -1), gap,
                              bound.numpy()))
            return out

        monkeypatch.setattr(TMoE, "route", route)

    def flips(self, shape, valid=None, remat=False, taint=None,
              ties=False) -> np.ndarray:
        """The tokens (``shape``; only the ``valid`` ones) routed otherwise
        than in JAX in some layer of the calls recorded since the last
        call, each a routing near tie.  ``remat``: the calls were a
        gradient's, each layer recomputed in the backward (the JAX layers
        in order, the port's last to first); each recomputation must
        route as its forward did, and the forward's calls are compared.
        ``taint``: the calls were one forward's layers in order, and a
        flip changes what later layers see beyond a rounding, so only a
        token not yet reached by an earlier layer's flip must be a near
        tie: ``"row"`` (the dense dispatch) a flipped token's causal
        future in its row, ``"batch"`` (the capacity dispatch, where a
        token's buffer slot depends on every earlier token) every later
        token of the batch.  ``ties``: a token whose k-th and (k+1)-th
        router logits are equal in the port counts as flipped whatever
        JAX recorded (the JAX block breaks an exact tie otherwise under
        autodiff or jit than its eager forward, which the recorder
        runs)."""
        jax.effects_barrier()
        js = [i for _, i in sorted(self.jax, key=lambda e: e[0])]
        if remat:
            assert len(js) == len(self.port) and len(js) % 2 == 0
            n = len(js) // 2
            assert all(np.array_equal(a, b) for a, b in zip(js[::2],
                                                            js[1::2]))
            assert all(np.array_equal(a[0], b[0]) for a, b in zip(
                self.port[:n], reversed(self.port[n:])))
            js, self.port[:] = js[::2], self.port[:n]
        assert len(js) == len(self.port) > 0
        valid = np.ones(shape, bool) if valid is None else valid
        flip = np.zeros(shape, bool)
        for ji, (ti, gap, bound) in zip(js, self.port):
            k = ti.shape[-1]
            diff = (ji.reshape(-1, k) != ti.reshape(-1, k)).any(-1)
            if ties:
                diff |= gap.reshape(-1) == 0
            diff &= valid.reshape(-1)
            if taint == "row":
                first = diff & _before_first_flip(flip).reshape(-1)
            elif taint == "batch":
                first = diff & (np.cumsum(flip.reshape(-1)) == 0)
            else:
                first = diff
            assert (gap.reshape(-1)[first] <= bound.reshape(-1)[first]).all()
            flip |= diff.reshape(shape)
        self.jax.clear()
        self.port.clear()
        return flip


def _before_first_flip(flip: np.ndarray) -> np.ndarray:
    """[B, S] -> True at the positions before their row's first flip."""
    return np.cumsum(flip, axis=-1) == 0


# ------------------------------------------------------------ the block
@pytest.mark.parametrize("sparse", [False, True])
def test_moe_block_matches_jax(moe, sparse):
    """``moe_block`` (dense dispatch) and ``moe_block_sparse`` (capacity
    dispatch) of layer 0 on [2, 9, D] bf16 inputs: outputs within
    ``OUT_TOL``, aux losses within 1e-5 relative."""
    _, jcfg, cfg, jp, _, tp = moe
    x = _x(1, (2, 9, cfg.d_model))
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.n_experts_active)
    jfn = JMoE.moe_block_sparse if sparse else JMoE.moe_block
    tfn = TMoE.moe_block_sparse if sparse else TMoE.moe_block
    jo, ja = jfn(_jax_layer(jp), jnp.asarray(x, jnp.bfloat16), **kw)
    to, ta = tfn(tp["layers"][0]["moe"], torch.as_tensor(x).bfloat16(), **kw)
    assert to.dtype == torch.bfloat16
    _close(to, jo)  # the same x and router product: no routing flip
    assert abs(float(ta) - float(ja)) <= AUX_RTOL * abs(float(ja))


def test_top_k_indices_equal_jax(moe):
    """The router's top-k over 64 tokens: indices and normalised weights
    as ``jax.lax.top_k`` and the JAX normalisation give them, on the same
    logits; exact gate ties (every logit equal) go to the lower expert."""
    _, jcfg, cfg, jp, _, tp = moe
    x = _x(2, (64, cfg.d_model))
    x[:4] = 0.0  # all logits 0: every real expert ties
    lp = _jax_layer(jp)
    logits = (jnp.asarray(x, jnp.bfloat16)
              @ lp["router"].astype(jnp.bfloat16)).astype(jnp.float32)
    E = logits.shape[-1]
    logits = jnp.where(jnp.arange(E) >= jcfg.n_experts, -1e30, logits)
    gates = jax.nn.softmax(logits, axis=-1)
    jv, ji = jax.lax.top_k(gates, jcfg.n_experts_active)
    jv = jv / jnp.maximum(jv.sum(-1, keepdims=True), 1e-9)
    tg, ti, tv = TMoE.route(torch.as_tensor(x).bfloat16(),
                            tp["layers"][0]["moe"]["router"], cfg.n_experts,
                            cfg.n_experts_active)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[:4].tolist() == [list(range(cfg.n_experts_active))] * 4
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(gates), rtol=1e-6,
                               atol=1e-7)


def test_padding_experts_never_win(moe):
    """Over 2,048 random tokens at three scales the padded experts get no
    gate and no combine weight, and every real expert is picked."""
    _, _, cfg, _, _, tp = moe
    E = cfg.n_experts_padded
    assert E > cfg.n_experts
    for scale in (0.1, 1.0, 30.0):
        x = torch.as_tensor(_x(3, (2048, cfg.d_model)) * scale).bfloat16()
        gates, idx, vals = TMoE.route(x, tp["layers"][0]["moe"]["router"],
                                      cfg.n_experts, cfg.n_experts_active)
        assert int(idx.max()) < cfg.n_experts
        assert (gates[:, cfg.n_experts:] == 0).all()
        assert set(idx.flatten().tolist()) == set(range(cfg.n_experts))
        torch.testing.assert_close(vals.sum(-1), torch.ones(2048))


def test_moe_down_combine_plain_version_is_jax(moe):
    """The plain version of the new kernel on the layer's real shapes:
    JAX's two einsums within ``OUT_TOL``, and each row its own (a row
    alone gives the same bits)."""
    _, jcfg, cfg, jp, _, tp = moe
    p = tp["layers"][0]["moe"]
    E, F, D = p["w_down"].shape
    rng = np.random.default_rng(4)
    h = torch.as_tensor(rng.normal(0, 1, (12, E, F)), dtype=torch.float32)
    h = h.bfloat16()
    c = np.zeros((12, E), np.float32)
    for m in range(11):  # the last row picks nothing
        c[m, rng.choice(cfg.n_experts, 2, replace=False)] = [0.25, 0.75]
    c = torch.as_tensor(c).bfloat16()
    got = ref.moe_down_combine_ref(h, p["w_down"], c)
    jh = jnp.asarray(h.float().numpy(), jnp.bfloat16)
    eo = jnp.einsum("mef,efd->med", jh, _jax_layer(jp)["w_down"].astype(
        jnp.bfloat16))
    want = jnp.einsum("med,me->md", eo, jnp.asarray(c.float().numpy(),
                                                    jnp.bfloat16))
    _close(got, want)
    assert (got[11] == 0).all()
    for m in (0, 5):
        assert torch.equal(ref.moe_down_combine_ref(
            h[m:m + 1], p["w_down"], c[m:m + 1])[0], got[m])


@pytest.mark.parametrize("D", [8, 32, 48, 1536, 2050])
def test_row_sum_is_a_sum_in_a_fixed_order(D):
    """``row_sum`` (rms_norm's mean, the router softmax's sum) adds in
    stages of 32 zero-padded neighbours: the sum within float32 rounding,
    the axis kept, each row's bits its own whatever the rows."""
    from repro_torch.nn.common import row_sum

    x = torch.as_tensor(_x(7, (9, 3, D)))
    got = row_sum(x)
    assert got.shape == (9, 3, 1) and got.dtype == torch.float32
    torch.testing.assert_close(got, x.double().sum(-1, keepdim=True).float(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(row_sum(x[4:5, 1:2]), got[4:5, 1:2])


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("C", [1, 4])
def test_paged_decode_step_matches_jax(moe, C, monkeypatch):
    """Teacher-forced chunks through the paged cache: every routing flip a
    near tie; logits within the tolerance at every valid chunk position
    before its sequence's first flip, greedy equal beyond the near-tie
    margin."""
    _, jcfg, cfg, jp, npt, tp = moe
    routing = _Routing(monkeypatch, npt)
    flip = np.zeros((2, 16), bool)
    jkv = JM.init_paged_kv(jcfg, 8, 8)
    tkv = TM.init_paged_kv(cfg, 8, 8, device="cpu")
    tbl = np.arange(8, dtype=np.int32).reshape(2, 4)
    toks = np.random.default_rng(C).integers(1, 97, (2, 16)).astype(np.int32)
    step = jax.jit(lambda p, kv, tb, pos, t, n: JM.paged_decode_step(
        p, kv, tb, pos, t, n, jcfg, all_positions=True))
    lj_rows, lt_rows, at = [], [], []
    for t0 in range(0, 16, C):
        pos = np.full((2,), t0, np.int32)
        n = np.array([C, max(1, C - 1)], np.int32)  # slot 1 pads its chunk
        lj, jkv = step(jp, jkv, jnp.asarray(tbl), jnp.asarray(pos),
                       jnp.asarray(toks[:, t0:t0 + C]), jnp.asarray(n))
        lt, tkv = TM.paged_decode_step(
            tp, tkv, torch.as_tensor(tbl), torch.as_tensor(pos),
            torch.as_tensor(toks[:, t0:t0 + C]), torch.as_tensor(n), cfg,
            all_positions=True)
        lj = np.asarray(lj)
        valid = np.arange(C)[None] < n[:, None]
        flip[:, t0:t0 + C] = routing.flips((2, C), valid)
        for b in range(2):
            lj_rows.append(lj[b, : n[b]])
            lt_rows.append(lt[b, : n[b]].numpy())
            at += [(b, t0 + j) for j in range(n[b])]
    before = _before_first_flip(flip)
    _check_logits(np.concatenate(lt_rows), np.concatenate(lj_rows),
                  np.array([before[b, t] for b, t in at]))


def test_decode_step_matches_jax(moe, monkeypatch):
    """The dense ring cache, 20 steps from pos 0 past the wrap (cache
    16): every routing flip a near tie; logits within the tolerance at
    every step before its sequence's first flip."""
    _, jcfg, cfg, jp, npt, tp = moe
    routing = _Routing(monkeypatch, npt)
    flip = np.zeros((2, 20), bool)
    toks = np.random.default_rng(5).integers(1, 97, (2, 20)).astype(np.int32)
    js = JM.init_decode_state(jcfg, 2, 16)
    ts = TM.init_decode_state(cfg, 2, 16, device="cpu")
    step = jax.jit(lambda p, s, t: JM.decode_step(p, s, t, jcfg))
    lj, lt = [], []
    for t in range(20):
        out, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        lj.append(np.asarray(out))
        lt.append(TM.decode_step(tp, ts, torch.as_tensor(toks[:, t:t + 1]),
                                 cfg)[0].numpy())
        flip[:, t] = routing.flips((2,))
    assert int(ts["pos"]) == 20
    keep = _before_first_flip(flip).T.reshape(-1)  # rows step-major
    _check_logits(np.concatenate(lt), np.concatenate(lj), keep)


@pytest.mark.parametrize("moe_impl", ["dense", "sparse"])
def test_forward_and_aux_match_jax(moe, moe_impl, monkeypatch):
    """``forward`` on the float32 masters (the training forward): every
    routing flip a near tie; logits within the tolerance before each
    sequence's first flip (with the sparse dispatch, before the batch's
    first: a token's place in an expert's buffer depends on every earlier
    token); the summed aux loss within 1e-3 relative (the gates see the
    upstream bf16 roundings, about one ulp of each logit) plus, for each
    flipped token and layer, the most one token moves it (2 E / N); and,
    with no flip, ``loss_fn`` within 1e-3 relative, the aux loss weighed
    in."""
    _, jcfg, cfg, jp, npt, _ = moe
    masters = master_params_from_arrays(npt, cfg, "cpu")
    tokens = np.random.default_rng(6).integers(0, 256, (2, 16)).astype(
        np.int32)
    jloss = JM.loss_fn(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                       moe_impl=moe_impl, q_block=16)
    with torch.no_grad():
        tloss = TM.loss_fn(masters, {"tokens": torch.from_numpy(tokens)}, cfg,
                           moe_impl=moe_impl, q_block=16)
    routing = _Routing(monkeypatch, npt)
    jl, ja = JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                        moe_impl=moe_impl, q_block=16)
    with torch.no_grad():
        tl, ta = TM.forward(masters, {"tokens": torch.from_numpy(tokens)},
                            cfg, moe_impl=moe_impl, q_block=16)
    flip = routing.flips(tokens.shape)
    keep = (_before_first_flip(flip.reshape(1, -1)).reshape(flip.shape)
            if moe_impl == "sparse" else _before_first_flip(flip))
    V = tl.shape[-1]
    _check_logits(tl.reshape(-1, V).numpy(), np.asarray(jl).reshape(-1, V),
                  keep.reshape(-1))
    assert float(ta) > 0
    E, N = cfg.n_experts_padded, tokens.size
    slack = flip.sum() * cfg.n_layers * 2 * E / N
    assert abs(float(ta) - float(ja)) <= 1e-3 * abs(float(ja)) + slack
    if not flip.any():
        assert abs(float(tloss) - float(jloss)) <= 1e-3 * abs(float(jloss))


@pytest.mark.parametrize("moe_impl", ["dense", "sparse"])
def test_loss_and_gradients_match_jax(moe, moe_impl, monkeypatch):
    """MoE training: ``loss_fn`` and the gradient of every master leaf
    (the dense dispatch's through ``moe_down_combine``'s backward) against
    the JAX package's jitted ``value_and_grad``, on DRAWS fixed token
    draws, the routing of both recorded in the gradient's own forward
    (an exact tie of the port's router logits counted as a flip).  A
    draw with no routing flip: the loss within ``LOSS_RTOL`` and each
    leaf within ``GRAD_TOL`` of the JAX leaf's largest magnitude (as
    ``test_torch_train.py``).  A draw with a flip (each a near tie): the
    loss within ``LOSS_RTOL`` plus the aux term's flip slack of
    ``test_forward_and_aux_match_jax`` (``MOE_AUX_WEIGHT`` x flips x
    layers x 2 E / N), and no gradient bound (a flipped token's expert
    and its whole causal future change).  The draws are not picked: at
    least one must be free of flips, or the test fails."""
    _, jcfg, cfg, jp, npt, _ = moe
    routing = _Routing(monkeypatch, npt)
    jgrad = jax.jit(jax.value_and_grad(lambda p, t: JM.loss_fn(
        p, {"tokens": t}, jcfg, moe_impl=moe_impl, q_block=16)))
    E, L = cfg.n_experts_padded, cfg.n_layers
    clean = 0
    for seed in range(DRAWS):
        tokens = np.random.default_rng(seed).integers(0, 256, (2, 16)).astype(
            np.int32)
        jl, jg = jgrad(jp, jnp.asarray(tokens))
        masters = master_params_from_arrays(npt, cfg, "cpu")
        for leaf in leaves(masters):
            for p in leaf.parts:
                p.requires_grad_(True)
        tl = TM.loss_fn(masters, {"tokens": torch.from_numpy(tokens)}, cfg,
                        moe_impl=moe_impl, q_block=16)
        tl.backward()
        flip = routing.flips(tokens.shape, remat=True, ties=True,
                             taint="row" if moe_impl == "dense" else "batch")
        slack = TM.MOE_AUX_WEIGHT * flip.sum() * L * 2 * E / tokens.size
        err = abs(tl.item() - float(jl))
        assert err <= LOSS_RTOL * abs(float(jl)) + slack, (seed, err)
        if flip.any():
            continue
        clean += 1
        tg = {leaf.key: np.stack([p.grad.numpy() for p in leaf.parts])
              if leaf.stacked else leaf.parts[0].grad.numpy()
              for leaf in leaves(masters)}
        for k, want in jax_flatten(jg).items():
            assert tg[k].shape == want.shape, k
            gerr = np.abs(tg[k] - want).max()
            assert gerr <= GRAD_TOL * np.abs(want).max(), (seed, k, gerr)
    assert clean > 0, f"every one of the {DRAWS} draws has a routing flip"


def test_params_round_trip_through_convert(moe):
    """The JAX tree -> the port's masters -> the JAX tree, bitwise, in the
    JAX layout; the compute copy holds the experts' gate and up as [D,
    E * F] bf16 (column e * F + f is expert e's column f)."""
    _, jcfg, cfg, _, npt, tp = moe
    back = arrays_from_master_params(master_params_from_arrays(npt, cfg,
                                                               "cpu"))
    flat_j = jax.tree_util.tree_leaves_with_path(npt)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(b, a)
    E, D, F = npt["layers"]["moe"]["w_gate"].shape[1:]
    assert E == cfg.n_experts_padded and D == cfg.d_model and F == cfg.d_ff
    for i, layer in enumerate(tp["layers"]):
        for name in ("w_gate", "w_up"):
            w = layer["moe"][name]
            assert w.dtype == torch.bfloat16 and w.shape == (D, E * F)
            want = torch.tensor(npt["layers"]["moe"][name][i]).bfloat16()
            assert torch.equal(w.reshape(D, E, F), want.permute(1, 0, 2))
        assert layer["moe"]["w_down"].shape == (E, F, D)


# ---------------------------------------------------- the port vs itself
def _engine(tp, cfg, **scfg):
    return TE.ServeEngine(cfg, tp, TE.ServeConfig(max_batch=4, cache_len=32,
                                                  **scfg), device="cpu")


def _serve(cb, prompts):
    for rid, p in enumerate(prompts):
        cb.submit(rid, p)
    return cb.run(max_steps=600)


def _prompts(n=8, seed=0, max_len=12):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 97, rng.integers(1, max_len))]
            for _ in range(n)]


def test_chunked_prefill_equals_token_by_token(moe):
    """The device batcher at chunk 4 and 8 against chunk 1, and the host
    batcher against chunk 1: every stream bitwise."""
    _, _, cfg, _, _, tp = moe
    prompts = _prompts()

    def device(chunk):
        return TE.DeviceContinuousBatcher(
            _engine(tp, cfg, page_size=8), eos_token=-1, max_tokens=4,
            sync_every=3, prefill_chunk=chunk)

    one = _serve(device(1), prompts)
    assert len(one) == len(prompts)
    for chunk in (4, 8):
        assert _serve(device(chunk), prompts) == one
    host = TE.ContinuousBatcher(_engine(tp, cfg, page_size=8), eos_token=-1,
                                max_tokens=4)
    assert _serve(host, prompts) == one


def test_paged_equals_dense_on_single_token_prompts(moe):
    """One wave of single-token prompts, every slot admitted at step 0:
    the paged and dense device batchers give every stream bitwise."""
    _, _, cfg, _, _, tp = moe
    prompts = [[t] for t in (5, 17, 42, 90)]
    kw = dict(eos_token=-1, max_tokens=6, sync_every=3)
    paged = _serve(TE.DeviceContinuousBatcher(_engine(tp, cfg, page_size=8),
                                              **kw), prompts)
    dense = _serve(TE.DeviceContinuousBatcher(_engine(tp, cfg), **kw),
                   prompts)
    assert paged == dense and len(dense) == 4


# ------------------------------------------------------ entry points
@pytest.mark.parametrize("argv,tag", [
    (["--continuous", "--page-size", "16", "--prompt-len", "12"],
     "[device] served"),
    (["--continuous", "--page-size", "16", "--prompt-len", "12",
      "--batcher", "host"], "[host] served"),
    (["--continuous"], "[device] served"),
    ([], "generated 32 tokens"),
    (["--router", "--page-size", "16", "--prompt-len", "12"],
     "[router] served"),
    (["--continuous", "--page-size", "16", "--prompt-len", "12",
      "--spec-k", "2"], "speculative: k=2")])
def test_launcher_serves_the_moe_smoke_config(argv, tag, capsys):
    """``--arch qwen2-moe-a2.7b --smoke`` through each serve mode of the
    launcher on the CPU."""
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu",
                "--requests", "8", "--tokens", "4", *argv])
    assert tag in capsys.readouterr().out


def test_distill_example_on_cpu(capsys):
    """``examples/moe_router_distill_torch.py --device cpu``: the two
    planted stages agree with their native models."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "examples"
            / "moe_router_distill_torch.py")
    spec = importlib.util.spec_from_file_location("moe_distill", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    native, mapped = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "PCA-LB parity 1.000" in out and "distilled router" in out
    assert mapped == native > 0
