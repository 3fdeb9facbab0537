"""The port's recurrent families against the JAX package, on the CPU:
``xlstm-125m`` (``ssm``: mLSTM and sLSTM) and ``recurrentgemma-9b``
(``hybrid``: RG-LRU and windowed attention) at their smoke sizes, and cut
to have a tail (``n_layers`` 3 and 5: one macro and a remainder layer, one
macro and two RG-LRU layers).

The JAX package's random-init masters, and where a test starts mid-run its
decode state, are carried across with ``arch.convert``.  Tolerances, as in
``test_torch_serve.py`` and ``test_torch_train.py``:

* logits: every position within ``LOGIT_TOL`` (3%) of the JAX logits'
  largest magnitude there (bf16 roundings land in other places in the two
  frameworks; the recurrent blocks alone agree within 4 bf16 ulps,
  ``test_torch_recurrent.py``), greedy tokens equal wherever the JAX
  top-2 margin exceeds twice that bound, and a served stream compared up
  to the first near tie of its slot;
* decode against the port's own forward: the JAX package's 0.15
  (``tests/test_arch_smoke.py:72``);
* a train step: the loss within 1e-3 relative; an updated master within
  ``UPDATE_TOL`` of JAX's where the JAX gradient is clear of
  ``GRAD_TOL`` (AdamW's first step moves a parameter by about lr x the
  gradient's sign, so a gradient within the bf16 noise may flip it), and
  within twice the step's lr everywhere;
* the port against itself (host == device batcher, ``commit=False``, a
  checkpoint's save and restore) and the decay rule: bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.ckpt.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train.step import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.arch.convert import (arrays_from_master_params,  # noqa: E402
                                      decode_state_from_arrays,
                                      master_params_from_arrays,
                                      params_from_arrays)
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train.step import TrainConfig, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_serve import (DS, LOGIT_TOL, _near_tie_bound,  # noqa: E402
                              _top2_margin)

ROOT = Path(__file__).resolve().parents[1]
XLSTM, RG = "xlstm-125m", "recurrentgemma-9b"
# name -> (arch, n_layers or 0 for the smoke config's own)
MODELS = {"xlstm": (XLSTM, 0), "xlstm-tail": (XLSTM, 3), "rg": (RG, 0),
          "rg-tail": (RG, 5)}
LOSS_RTOL = 1e-3
GRAD_TOL = 0.05
UPDATE_TOL = 1e-5


def _cfgs(name):
    arch, n = MODELS[name]
    jc, tc = jax_smoke(arch), get_smoke_config(arch)
    if n:
        jc = dataclasses.replace(jc, n_layers=n)
        tc = dataclasses.replace(tc, n_layers=n)
    return jc, tc


_MODELS = {}


def _model(name):
    """(JAX cfg, port cfg, JAX params, port compute params), made once."""
    if name not in _MODELS:
        jc, tc = _cfgs(name)
        jp = JM.init_params(jc, jax.random.PRNGKey(1))
        _MODELS[name] = (jc, tc, jp, params_from_arrays(
            jax.tree.map(np.asarray, jp), tc, "cpu"))
    return _MODELS[name]


@pytest.fixture(scope="module")
def gates():
    """(JAX gate, port gate): rf-S on unsw, as ``test_torch_serve``'s."""
    from repro.core import PlanterConfig as JaxPlanterConfig
    from repro.core import plant as jax_plant
    from repro_torch.core import PlanterConfig, plant

    jg = jax_plant(JaxPlanterConfig(model="rf", size="S"), DS.X_train,
                   DS.y_train, DS.X_test).mapped
    tg = plant(PlanterConfig(model="rf", size="S", device="cpu"), DS.X_train,
               DS.y_train, DS.X_test).mapped
    return jg, tg


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


def _check_logits(lt: np.ndarray, lj: np.ndarray) -> None:
    """Every row within LOGIT_TOL of its max |JAX logits|; greedy equal
    where the JAX top-2 margin is clear of the near-tie bound."""
    assert lt.shape == lj.shape
    lt, lj = lt.reshape(-1, lt.shape[-1]), lj.reshape(-1, lj.shape[-1])
    diff = np.abs(lt - lj).max(-1)
    assert (diff <= LOGIT_TOL * np.abs(lj).max(-1)).all(), (
        diff / np.abs(lj).max(-1)).max()
    clear = _top2_margin(lj) > _near_tie_bound(lj)
    np.testing.assert_array_equal(lt.argmax(-1)[clear], lj.argmax(-1)[clear])


def _shapes(tree) -> dict:
    """{key: (shape, dtype name)} of a decode state of either package."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"{k}/{kk}"] = vv
        elif isinstance(v, tuple):
            for i, vv in enumerate(v):
                out[f"{k}/{i}"] = vv
        else:
            out[k] = v
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in out.items()}


def _state_tensors(state) -> list:
    return [t for k, v in sorted(state.items())
            for t in (v.values() if isinstance(v, dict) else
                      v if isinstance(v, tuple) else [v])]


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name):
    """``forward`` of 2 x 12 tokens (the mLSTM in chunks of 5, which do
    not divide 12): the logits of every position."""
    jc, tc, jp, tp = _model(name)
    toks = _tokens(jc, (2, 12), 2)
    lj, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jc, q_block=12,
                       mlstm_chunk=5)
    with torch.no_grad():
        lt, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tc,
                             q_block=12, mlstm_chunk=5)
    assert lt.dtype == torch.float32 and float(aux) == 0.0
    _check_logits(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_step_matches_jax(name):
    """Teacher-forced ``decode_step`` from pos 0, 16 steps with cache 16
    (recurrentgemma's rings hold its window, 8 cells, so they wrap): the
    logits of every step; ``pos`` 16."""
    jc, tc, jp, tp = _model(name)
    toks = _tokens(jc, (2, 16), 3)
    js = JM.init_decode_state(jc, 2, 16)
    ts = TM.init_decode_state(tc, 2, 16, device="cpu")
    step = jax.jit(lambda p, s, t: JM.decode_step(p, s, t, jc))
    lj, lt = [], []
    for t in range(16):
        out, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        lj.append(np.asarray(out))
        with torch.no_grad():
            out, ts = TM.decode_step(tp, ts, torch.from_numpy(
                toks[:, t:t + 1]), tc)
        lt.append(out.numpy())
    assert int(ts["pos"]) == int(js["pos"]) == 16
    _check_logits(np.stack(lt), np.stack(lj))


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_equals_forward(name):
    """Mirror of ``tests/test_arch_smoke.py``'s ``test_decode_matches_
    forward``: teacher-forced decode logits within 0.15 of the port's own
    forward, position by position."""
    _, tc, _, tp = _model(name)
    toks = torch.from_numpy(_tokens(tc, (2, 12), 1))
    with torch.no_grad():
        fwd, _ = TM.forward(tp, {"tokens": toks}, tc, q_block=12)
        st = TM.init_decode_state(tc, 2, 12, device="cpu")
        errs = []
        for t in range(12):
            lg, st = TM.decode_step(tp, st, toks[:, t:t + 1], tc)
            errs.append((lg - fwd[:, t]).abs().max().item())
    assert max(errs) < 0.15, errs


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", list(MODELS))
def test_init_decode_state_matches_jax(name, kv_dtype):
    """Keys, shapes and dtypes of the JAX package's state; an int8 request
    keeps bf16 rings (the JAX package's silent fallback)."""
    jc, tc, _, _ = _model(name)
    js = JM.init_decode_state(jc, 3, 32, kv_dtype=kv_dtype)
    ts = TM.init_decode_state(tc, 3, 32, kv_dtype=kv_dtype, device="cpu")
    assert _shapes(ts) == _shapes(js)
    for k, v in js.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                np.testing.assert_array_equal(ts[k][kk].numpy(),
                                              np.asarray(vv))
    with pytest.raises(ValueError, match="kv_dtype"):
        TM.init_decode_state(tc, 3, 32, kv_dtype="fp8", device="cpu")


@pytest.mark.parametrize("name", ["rg-tail", "xlstm-tail"])
def test_jax_mid_run_state_continues_in_the_port(name):
    """Six JAX steps with cache 4 (recurrentgemma's rings: 4 cells, shorter
    than its window of 8), the JAX state carried across, then ten steps in
    both packages from it: past the ring's wrap the logits agree, and the
    port's state keeps the JAX layout."""
    jc, tc, jp, tp = _model(name)
    toks = _tokens(jc, (2, 16), 4)
    js = JM.init_decode_state(jc, 2, 4)
    step = jax.jit(lambda p, s, t: JM.decode_step(p, s, t, jc))
    for t in range(6):
        _, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
    ts = decode_state_from_arrays(jax.tree.map(np.asarray, js), tc, "cpu")
    assert _shapes(ts) == _shapes(js)
    lj, lt = [], []
    for t in range(6, 16):
        out, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        lj.append(np.asarray(out))
        with torch.no_grad():
            out, ts = TM.decode_step(tp, ts, torch.from_numpy(
                toks[:, t:t + 1]), tc)
        lt.append(out.numpy())
    assert int(ts["pos"]) == 16
    _check_logits(np.stack(lt), np.stack(lj))


@pytest.mark.parametrize("name", list(MODELS))
def test_uncommitted_step_leaves_the_state_bitwise(name):
    """``commit`` False after five steps: every recurrent state (h and
    conv; C, n, m and conv; c, n, m and h), every ring and ``pos`` bitwise
    as they were; ``commit`` True then gives the plain step's state."""
    _, tc, _, tp = _model(name)
    toks = torch.from_numpy(_tokens(tc, (2, 7), 5))
    st = TM.init_decode_state(tc, 2, 8, device="cpu")
    ref = TM.init_decode_state(tc, 2, 8, device="cpu")
    with torch.no_grad():
        for t in range(5):
            TM.decode_step(tp, st, toks[:, t:t + 1], tc)
            TM.decode_step(tp, ref, toks[:, t:t + 1], tc)
        before = [t.clone() for t in _state_tensors(st)]
        TM.decode_step(tp, st, toks[:, 5:6], tc,
                       commit=torch.tensor(False))
        after = _state_tensors(st)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        TM.decode_step(tp, st, toks[:, 5:6], tc, commit=torch.tensor(True))
        TM.decode_step(tp, ref, toks[:, 5:6], tc)
    assert all(torch.equal(a, b) for a, b in zip(_state_tensors(st),
                                                   _state_tensors(ref)))
    assert int(st["pos"]) == 6


# ------------------------------------------------------------ serving
def _engines(name, gates, batch=4, cache_len=16, **kw):
    jc, tc, jp, tp = _model(name)
    jg, tg = gates
    je = JE.ServeEngine(jc, jp, JE.ServeConfig(max_batch=batch,
                                               cache_len=cache_len, **kw),
                        gate=jg)
    te = TE.ServeEngine(tc, tp, TE.ServeConfig(max_batch=batch,
                                               cache_len=cache_len, **kw),
                        gate=tg, device="cpu")
    return je, te


def _workload(cb, n_req=10, seed=0, vocab=256, max_steps=300):
    rng = np.random.default_rng(seed)
    for rid in range(n_req):
        cb.submit(rid, int(rng.integers(1, min(vocab, 100))),
                  features=DS.X_test[rid])
    return cb.run(max_steps=max_steps)


@pytest.mark.parametrize("name", ["xlstm", "rg"])
def test_generate_matches_jax(name, gates):
    """JAX ``generate`` vs the port's (3-token prompts, 10 generated, cache
    8: recurrentgemma's rings wrap): each slot's stream equal up to its
    first JAX near tie, from the JAX model's logits along its stream."""
    jc, _, jp, _ = _model(name)
    prompts = _tokens(jc, (4, 3), 6)
    je, te = _engines(name, gates, cache_len=8)
    want = np.asarray(je.generate(prompts, 10, features=DS.X_test[:4]))
    got = te.generate(prompts, 10, features=DS.X_test[:4])
    assert got.shape == want.shape == (4, 10)
    seqs = np.concatenate([prompts, want], 1).astype(np.int32)
    js = JM.init_decode_state(jc, 4, 8)
    step = jax.jit(lambda p, s, t: JM.decode_step(p, s, t, jc))
    rows = []
    for t in range(seqs.shape[1] - 1):
        lg, js = step(jp, js, jnp.asarray(seqs[:, t:t + 1]))
        if t >= 2:
            rows.append(np.asarray(lg))
    lj = np.stack(rows, 1)
    near = _top2_margin(lj) <= _near_tie_bound(lj)
    compared = 0
    for b in range(4):
        upto = int(np.argmax(near[b])) if near[b].any() else 10
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])
        compared += upto
    assert compared >= 3, compared  # 3 of xlstm's 40, 16 of rg's


@pytest.mark.parametrize("name", ["xlstm", "rg"])
def test_dense_host_batcher_matches_jax(name, gates):
    """JAX ``ContinuousBatcher`` (dense) vs the port's: 10 single-token
    requests with gate features through 4 slots, cache 8; drops, reasons
    and steps equal; each stream equal up to the first JAX near tie of its
    slot (a reused slot continues from its last state, in both)."""
    je, te = _engines(name, gates, cache_len=8)
    jcb = JE.ContinuousBatcher(je, eos_token=-1, max_tokens=6)
    log = []
    inner = jcb.engine.step

    def step(tokens, features=None, block=True):
        logits, labels = inner(tokens, features, block)
        log.append((list(jcb.slot_req), np.asarray(logits)))
        return logits, labels

    jcb.engine.step = step
    tcb = TE.ContinuousBatcher(te, eos_token=-1, max_tokens=6)
    dj, dt = _workload(jcb), _workload(tcb)
    assert tcb.dropped == jcb.dropped and tcb.drop_reasons == jcb.drop_reasons
    assert sorted(dt) == sorted(dj) and len(dj) >= 4
    assert tcb.max_live == jcb.max_live and tcb._drains == jcb._drains
    tie, upto = {}, {r: 0 for r in dj}
    for t, (reqs, lg) in enumerate(log):
        near = _top2_margin(lg) <= _near_tie_bound(lg)
        for b, r in enumerate(reqs):
            if r is None:
                continue
            if near[b]:
                tie.setdefault(b, t)
            if b not in tie and r in upto:
                upto[r] += 1
    compared = 0
    for rid, n in upto.items():
        assert dt[rid][:n] == dj[rid][:n], (rid, n)
        compared += n
    assert compared >= 4, compared  # 5 (xlstm) and 7 (rg) on this workload


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("name", ["xlstm", "rg"])
def test_device_equals_host(name, sampled, gates):
    """The dense device batcher (sync_every 3) and the host batcher on 12
    requests of 12 tokens, cache 16 (recurrentgemma's rings of 8 wrap):
    streams, drops, reasons, steps and the global position bitwise, greedy
    and sampled."""
    kw = dict(temperature=2.0, top_k=40) if sampled else {}
    _, te = _engines(name, gates, **kw)
    _, te2 = _engines(name, gates, **kw)
    host = TE.ContinuousBatcher(te, eos_token=-1, max_tokens=12)
    dev = TE.DeviceContinuousBatcher(te2, eos_token=-1, max_tokens=12,
                                     sync_every=3)
    done_h = _workload(host, n_req=12)
    assert _workload(dev, n_req=12) == done_h and len(done_h) >= 4
    assert dev.dropped == host.dropped
    assert dev.drop_reasons == host.drop_reasons
    assert dev.steps == host.steps
    assert int(dev._decode["pos"]) == int(te.state["pos"]) == host.steps > 8


def test_paged_cache_is_refused_as_in_jax(gates):
    """``init_paged_kv``, ``paged_decode_step`` and a paged engine raise
    the JAX package's ``ValueError`` for a ``block_pattern`` config."""
    for name in ("xlstm", "rg"):
        jc, tc, _, tp = _model(name)
        with pytest.raises(ValueError, match="dense attention") as jerr:
            JM.init_paged_kv(jc, 4, 4)
        with pytest.raises(ValueError, match="dense attention") as terr:
            TM.init_paged_kv(tc, 4, 4, device="cpu")
        assert str(terr.value) == str(jerr.value)
        z = torch.zeros((2, 1), dtype=torch.int32)
        with pytest.raises(ValueError, match="dense attention"):
            TM.paged_decode_step(tp, _pool(), z, z[:, 0], z, z[:, 0], tc)
        eng = TE.ServeEngine(tc, tp, TE.ServeConfig(max_batch=2,
                                                    page_size=4),
                             device="cpu")
        with pytest.raises(ValueError, match="dense attention"):
            TE.DeviceContinuousBatcher(eng)


def _pool():
    from repro_torch.nn.attn_backend import PagedKV

    z = torch.zeros((1, 4, 4, 1, 16), dtype=torch.bfloat16)
    return PagedKV(k=z, v=z.clone())


@pytest.mark.parametrize("arch", [XLSTM, RG])
@pytest.mark.parametrize("mode", [[], ["--continuous"],
                                  ["--continuous", "--batcher", "host"]])
def test_launch_serve_on_cpu(arch, mode, capsys):
    """``launch.serve --arch <arch> --smoke --device cpu``: one generate()
    batch, or either batcher over the dense state; ``--page-size`` fails
    as the JAX launcher's does."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "12", "--tokens", "4", *mode])
    text = capsys.readouterr().out
    if mode:
        assert len(out) >= 4 and all(len(t) == 4 for t in out.values())
        assert "served" in text
    else:
        assert out.shape == (8, 4) and "generated 32 tokens" in text
    if mode == ["--continuous"]:
        with pytest.raises(ValueError, match="dense attention"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--continuous", "--page-size", "16"])


# ------------------------------------------------------------ training
def _jax_masters(name, nonzero_tail=True):
    """(JAX masters, the port's): the tail's norm scales non-zero, so
    that their decay (none: they are 1-D) would show."""
    jc, tc = _cfgs(name)
    np_tree = jax.tree.map(np.asarray, JM.init_params(jc,
                                                      jax.random.PRNGKey(0)))
    np_tree = jax.tree.map(np.array, np_tree)
    rng = np.random.default_rng(7)
    if nonzero_tail:
        for layer in np_tree["tail"]:
            layer["ln1"] = rng.normal(0, 0.5, layer["ln1"].shape).astype(
                np.float32)
        for m in np_tree["macros"].values():
            m["ln1"] = rng.normal(0, 0.5, m["ln1"].shape).astype(np.float32)
    return (jax.tree.map(jnp.asarray, np_tree),
            master_params_from_arrays(np_tree, tc, "cpu"))


@pytest.mark.parametrize("name", ["xlstm-tail", "rg-tail"])
def test_train_step_matches_jax(name):
    """One train step (2 microbatches of 2 x 16 tokens, the mLSTM in
    chunks of 8, lr 3e-3): the loss within 1e-3 relative, and every
    updated master (the tail's 1-D leaves among them) as the JAX step's
    (the module docstring's rule)."""
    jc, tc = _cfgs(name)
    jp, tp = _jax_masters(name)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jt = JaxTrainConfig(microbatches=2, q_block=16, mlstm_chunk=8,
                        adamw=JOPT.AdamWConfig(**kw))
    tt = TrainConfig(microbatches=2, q_block=16, mlstm_chunk=8,
                     adamw=TOPT.AdamWConfig(**kw))
    toks = _tokens(jc, (4, 16), 3)
    jst = {"opt": JOPT.init(jp, jt.adamw), "step": jnp.zeros((), jnp.int32)}
    tst = {"opt": TOPT.init(tp, tt.adamw),
           "step": torch.zeros((), dtype=torch.int32)}
    loss_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jc, q_block=16, mlstm_chunk=8)))
    half = [{"tokens": jnp.asarray(toks[i * 2:(i + 1) * 2])} for i in (0, 1)]
    g = jax.tree.map(lambda a, b: (a + b) / 2,
                     *[loss_and_grad(jp, b)[1] for b in half])
    before = jax_flatten(jp)
    jp2, _, jl = jax.jit(jax_make_step(jc, jt))(
        jp, jst, {"tokens": jnp.asarray(toks)})
    tp2, tst2, tl = make_train_step(tc, tt)(tp, tst, {
        "tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert int(tst2["step"]) == 1
    want, grads = jax_flatten(jp2), jax_flatten(g)
    got = jax_flatten(jax.tree.map(jnp.asarray,
                                   arrays_from_master_params(tp2)))
    assert set(got) == set(want) and any(k.startswith("tail/") for k in want)
    lr = float(JOPT.schedule(jt.adamw, jnp.int32(1)))
    for k, w in want.items():
        w, a, gk = np.asarray(w), np.asarray(got[k]), np.asarray(grads[k])
        assert a.shape == w.shape, k
        step = np.abs(w - np.asarray(before[k]))
        assert np.abs(a - w).max() <= 2 * lr * 1.01 + 1e-7, k
        clear = np.abs(gk) > GRAD_TOL * np.abs(gk).max()
        err = np.abs(a - w)[clear]
        assert (err <= UPDATE_TOL + 1e-3 * step[clear]).all(), (k, err.max())


@pytest.mark.parametrize("name", ["xlstm-tail", "rg-tail"])
def test_decay_skips_the_tails_vectors(name):
    """AdamW decays where the JAX leaf has ndim >= 2: a macro's stacked
    ``[n_macro, D]`` norm scale is decayed, a tail layer's ``[D]`` one,
    its ``lam`` or ``b_f`` is not.  With zero gradients the step is the
    decay alone, ``lr * wd * p``; the port against the JAX update, within
    2 float32 ulps."""
    jc, tc = _cfgs(name)
    jp, tp = _jax_masters(name)
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jp2, _ = JOPT.update(jp, zeros, JOPT.init(jp, JOPT.AdamWConfig(**cfg)),
                         JOPT.AdamWConfig(**cfg))
    tz = master_params_from_arrays(jax.tree.map(np.asarray, zeros), tc,
                                   "cpu")
    tp2, _ = TOPT.update(tp, tz, TOPT.init(tp), TOPT.AdamWConfig(**cfg))
    want = jax_flatten(jp2)
    got = jax_flatten(jax.tree.map(jnp.asarray,
                                   arrays_from_master_params(tp2)))
    before = jax_flatten(jp)
    for k, w in want.items():
        w = np.asarray(w)
        ulps = np.abs(np.asarray(got[k]) - w) / np.spacing(
            np.maximum(np.abs(w), np.float32(1e-30)))
        assert ulps.max() <= 2, k
    assert np.array_equal(want["tail/0/ln1"], before["tail/0/ln1"])
    assert np.abs(before["tail/0/ln1"]).max() > 0
    assert not np.array_equal(want["macros/m0_" + jc.block_pattern[0]
                                   + "/ln1"],
                              before["macros/m0_" + jc.block_pattern[0]
                                     + "/ln1"])
    vec = "tail/0/mixer/" + ("lam" if jc.family == "hybrid" else "b_f")
    assert np.array_equal(want[vec], before[vec])


@pytest.mark.parametrize("name", ["xlstm-tail", "rg-tail"])
def test_checkpoint_keys_match_jax_and_restore_bitwise(name, tmp_path):
    """A port train state saved by the port's manager: its keys and shapes
    the JAX package's ``_flatten`` of the same tree (``tail/0/...``
    indexed, ``macros/...`` stacked); the JAX manager restores it into the
    JAX tree bitwise, and the port's restore gives every leaf back."""
    jc, tc = _cfgs(name)
    jp, tp = _jax_masters(name)
    jtree = {"params": jp, "state": {"opt": JOPT.init(jp),
                                     "step": jnp.int32(3)}}
    ttree = {"params": tp, "state": {"opt": TOPT.init(tp),
                                     "step": torch.tensor(3,
                                                          dtype=torch.int32)}}
    CheckpointManager(str(tmp_path)).save(3, ttree)
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json")
                          .read_text())["leaves"]
    want = jax_flatten(jtree)
    assert set(manifest) == set(want)
    for k, a in want.items():
        assert manifest[k]["shape"] == list(np.shape(a)), k
    got = JaxManager(str(tmp_path)).restore(
        3, jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    target = {"params": master_params_from_arrays(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jp), tc,
        "cpu"), "state": {"opt": TOPT.init(tp),
                          "step": torch.zeros((), dtype=torch.int32)}}
    back = CheckpointManager(str(tmp_path)).restore(3, target)
    for a, b in zip(leaves(back), leaves(ttree)):
        assert a.key == b.key
        assert all(torch.equal(x, y) for x, y in zip(a.parts, b.parts))


def test_remat_and_mlstm_chunk(monkeypatch):
    """``"full"`` remat (each macro recomputed) == ``"none"`` bitwise on a
    config with a tail; ``TrainConfig.mlstm_chunk`` reaches the mLSTM."""
    _, tc = _cfgs("xlstm-tail")
    _, tp = _jax_masters("xlstm-tail")
    toks = torch.from_numpy(_tokens(tc, (2, 12), 9))
    out = []
    for policy in ("full", "none"):
        ps = master_params_from_arrays(arrays_from_master_params(tp), tc,
                                       "cpu")
        for leaf in leaves(ps):
            for p in leaf.parts:
                p.requires_grad_(True)
        loss = TM.loss_fn(ps, {"tokens": toks}, tc, q_block=12,
                          remat_policy=policy, mlstm_chunk=4)
        loss.backward()
        out.append((loss.detach(), [p.grad for leaf in leaves(ps)
                                    for p in leaf.parts]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    from repro_torch.nn import recurrent as R

    seen = []
    real = R.mlstm_block
    monkeypatch.setattr(R, "mlstm_block", lambda p, x, h, chunk: (
        seen.append(chunk), real(p, x, h, chunk))[1])
    step = make_train_step(tc, TrainConfig(mlstm_chunk=4))
    step(tp, {"opt": TOPT.init(tp), "step": torch.zeros((),
                                                        dtype=torch.int32)},
         {"tokens": toks})
    assert seen and set(seen) == {4}


def _run(*argv, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=timeout)


def test_launch_train_xlstm_on_cpu():
    """``launch.train --arch xlstm-125m --smoke --device cpu``: 12 steps
    of 8 x 8 tokens, the loss improves."""
    from repro_torch.launch import train

    losses = train.main(["--arch", "xlstm-125m", "--smoke", "--device",
                         "cpu", "--steps", "12", "--seq", "8"])
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_train_lm_torch_on_cpu_resumes(tmp_path):
    """``examples/train_lm_torch.py --smoke --device cpu``: 1 step of the
    JAX example's 8 x 128 tokens with a checkpoint, then ``--resume auto``
    to 2 continues from step 1."""
    ck = str(tmp_path / "ck")
    a = _run("examples/train_lm_torch.py", "--smoke", "--device", "cpu",
             "--steps", "1", "--ckpt-dir", ck)
    assert a.returncode == 0, a.stderr
    assert "final loss" in a.stdout and "over 1 steps" in a.stdout
    b = _run("examples/train_lm_torch.py", "--smoke", "--device", "cpu",
             "--steps", "2", "--ckpt-dir", ck)
    assert b.returncode == 0, b.stderr
    assert "resumed from step 1" in b.stdout and "over 1 steps" in b.stdout


def test_train_lm_torch_defaults_to_cuda():
    r = _run("-c", textwrap.dedent("""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: False
        sys.argv = ["train_lm_torch.py", "--steps", "1"]
        try:
            runpy.run_path("examples/train_lm_torch.py", run_name="__main__")
        except RuntimeError as exc:
            print("RAISED", exc)
    """))
    assert "RAISED CUDA is not available" in r.stdout, r.stderr
