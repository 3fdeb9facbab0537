"""The port's trainer against the JAX package, on the CPU: the token
pipeline, AdamW's schedule and update, gradient compression, the loss and
its gradients, the training curve, the train step's own properties, and
the launcher.

Every test feeds the same numpy inputs (or the JAX package's random-init
masters, carried across with ``arch.convert``) through both packages, at
the smoke config (``qwen2-1.5b`` smoke: 2 layers, d 48).  Tolerances, each
with its reason:

* the pipeline, the schedule and compression: bitwise (integer and
  elementwise float32 arithmetic in the same order);
* ``update``: 2 float32 ulp at the update's scale, against the JAX
  update run op by op (the same operations in the same order; ``pow``
  and ``sqrt`` of two libraries may differ in the last bit; jit's fused
  multiply-adds are another rounding, see the test);
* the loss: 1e-3 relative, and each gradient leaf within ``GRAD_TOL`` of
  the JAX leaf's largest magnitude.  The forward and backward run in bf16,
  rounded at other places by XLA and by torch: the JAX package's own
  jitted gradient and its op-by-op gradient of the same loss differ by up
  to 2.2% of a leaf's largest magnitude at this config;
* the training curve: each of ten losses within 2e-3 relative of JAX's
  (the gradients' bf16 noise, above, moves the updates).
"""
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.ckpt.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxPipeline  # noqa: E402
from repro.data.tokens import TokenPipelineConfig as JaxPipeConfig  # noqa: E402
from repro.dist import compress as JC  # noqa: E402
from repro.train import optimizer as JOPT  # noqa: E402
from repro.train.step import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.arch.convert import (arrays_from_master_params,  # noqa: E402
                                      master_params_from_arrays)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig  # noqa: E402
from repro_torch.dist import compress as TC  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train.step import TrainConfig, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2-1.5b"
CFG = get_smoke_config(ARCH)
GRAD_TOL = 0.05
LOSS_RTOL = 1e-3
CURVE_RTOL = 2e-3


def _jax_masters(seed=0, cfg=None):
    """(JAX masters, the port's masters carried across)."""
    jcfg = jax_smoke(ARCH) if cfg is None else cfg[0]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = master_params_from_arrays(jax.tree.map(np.asarray, jp),
                                   CFG if cfg is None else cfg[1], "cpu")
    return jp, tp


def _flat_port(tree) -> dict:
    """The port tree as the JAX package's flat ``{key: array}``."""
    return {leaf.key: np.stack([p.detach().float().numpy().copy()
                                for p in leaf.parts]) if leaf.stacked
            else leaf.parts[0].detach().float().numpy().copy()
            for leaf in leaves(tree)}


def _port_tree(np_tree):
    """A JAX-layout numpy tree of the smoke params' shape -> port layout."""
    return master_params_from_arrays(np_tree, CFG, "cpu")


def _random_like(jp, seed, scale=1.0):
    """Numpy arrays shaped as the JAX tree, normal * ``scale``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.normal(0, scale, a.shape)).astype(
        np.float32), jp)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_token_pipeline_is_bitwise_jax(seed):
    for vocab, seq, batch in ((256, 32, 8), (151936, 64, 8)):
        a = JaxPipeline(JaxPipeConfig(vocab_size=vocab, seq_len=seq,
                                      global_batch=batch, seed=seed))
        b = TokenPipeline(TokenPipelineConfig(vocab_size=vocab, seq_len=seq,
                                              global_batch=batch, seed=seed))
        for step in (0, 3, 11):
            np.testing.assert_array_equal(a.batch_at(step)["tokens"],
                                          b.batch_at(step)["tokens"])


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 25), (5, 20)])
def test_schedule_is_bitwise_jax(warmup, total):
    """Steps 0, 1, the warmup's end, mid-decay, the total and past it."""
    jc = JOPT.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    tc = TOPT.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    for step in (0, 1, warmup, (warmup + total) // 2, total, total + 50):
        want = np.float32(JOPT.schedule(jc, jnp.int32(step)))
        got = TOPT.schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert got.item() == want, (step, got.item(), want)


def _nonzero_norms(np_tree, seed):
    """Give the norm scales and biases non-zero values, so that the decay
    of the stacked ``[L, D]`` leaves shows."""
    rng = np.random.default_rng(seed)
    for k in ("ln1", "ln2"):
        np_tree["layers"][k] = rng.normal(0, 0.5, np_tree["layers"][k].shape
                                          ).astype(np.float32)
    for k in ("bq", "bk", "bv"):
        a = np_tree["layers"]["mixer"][k]
        np_tree["layers"]["mixer"][k] = rng.normal(0, 0.5, a.shape).astype(
            np.float32)
    np_tree["ln_f"] = rng.normal(0, 0.5, np_tree["ln_f"].shape).astype(
        np.float32)
    return np_tree


def _assert_ulps(name, got, want, before, n=2):
    """|got - want| <= n float32 ulp at the update's scale: the largest of
    the leaf's magnitude before, after, and of the change (an ulp of the
    result alone would be tiny where ``p - step`` cancels)."""
    scale = np.maximum(np.maximum(np.abs(before), np.abs(want)),
                       np.abs(want - before)).astype(np.float32)
    ulps = np.abs(got - want) / np.spacing(scale)
    assert ulps.max() <= n, (name, int((ulps > n).sum()), ulps.max())


@pytest.mark.parametrize("m_dtype", ["f32", "bf16"])
def test_update_within_two_ulp_of_jax(m_dtype):
    """Two AdamW updates on the carried-across smoke tree (non-zero norm
    scales and biases), each from JAX's state of the round before and with
    the same gradients: every parameter, m and v within 2 float32 ulp of
    JAX's; m in bf16 with ``m_dtype="bf16"``."""
    jp, _ = _jax_masters()
    jp = jax.tree.map(jnp.asarray,
                      _nonzero_norms(jax.tree.map(np.asarray, jp), 1))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, m_dtype=m_dtype)
    jc, tc = JOPT.AdamWConfig(**kw), TOPT.AdamWConfig(**kw)
    js = JOPT.init(jp, jc)
    want_m = torch.bfloat16 if m_dtype == "bf16" else torch.float32
    assert TOPT.init(_port_tree(jax.tree.map(np.asarray, jp)), tc).m[
        "layers"][0]["mixer"]["wq"].dtype == want_m
    # op by op: under jit, XLA on the CPU contracts ``b1 * m + (1 - b1) *
    # g`` (and v's) into fused multiply-adds, one rounding fewer than the
    # written order (measured: jit's m and v equal an FMA emulation
    # bitwise), which torch's separate ops on either device do not make
    jupdate = JOPT.update
    for i in range(2):
        g = _random_like(jp, 10 + i, 0.1)
        before = {"params": jax_flatten(jp), "m": jax_flatten(js.m),
                  "v": jax_flatten(js.v)}
        tp = _port_tree(jax.tree.map(np.asarray, jp))
        ts = TOPT.AdamWState(
            m=TOPT.init(tp, tc).m, v=_port_tree(jax.tree.map(np.asarray,
                                                             js.v)),
            count=torch.tensor(int(js.count), dtype=torch.int32))
        for leaf, src in zip(leaves(ts.m), leaves(
                _port_tree(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        js.m)))):
            for a, b in zip(leaf.parts, src.parts):
                a.copy_(b)
        jp, js = jupdate(jp, jax.tree.map(jnp.asarray, g), js, jc)
        tp, ts = TOPT.update(tp, _port_tree(g), ts, tc)
        assert int(ts.count) == int(js.count) == i + 1
        for name, j, t in (("params", jp, tp), ("m", js.m, ts.m),
                           ("v", js.v, ts.v)):
            jf, tf = jax_flatten(j), _flat_port(t)
            assert set(jf) == set(tf)
            for k, a in jf.items():
                _assert_ulps(f"round {i} {name} {k}", tf[k],
                             np.asarray(a, np.float32),
                             np.asarray(before[name][k], np.float32))


def test_decay_reads_the_stacked_leaf():
    """JAX decays where its leaf has ndim >= 2: the stacked ``[L, D]``
    norm scales and biases, not ``ln_f``.  With zero gradients AdamW's
    step is the decay alone, ``lr * wd * p``."""
    jp, _ = _jax_masters()
    tp = _port_tree(_nonzero_norms(jax.tree.map(np.asarray, jp), 2))
    before = _flat_port(tp)
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jp)
    cfg = TOPT.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    tp, _ = TOPT.update(tp, _port_tree(zeros), TOPT.init(tp), cfg)
    after = _flat_port(tp)
    lr = float(TOPT.schedule(cfg, torch.tensor(1)))
    for k in ("layers/ln1", "layers/ln2", "layers/mixer/bq", "embed"):
        np.testing.assert_allclose(after[k], before[k] * (1 - lr * 0.1),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(after["ln_f"], before["ln_f"])


# ----------------------------------------------------------- compression
def test_compress_grads_is_bitwise_jax():
    """Two rounds of error feedback.  Layer 0's ``wq`` gradient is 100x
    layer 1's, so one scale a stacked leaf (JAX's) and one a layer give
    other bits."""
    jp, _ = _jax_masters()
    rounds = []
    for i in range(2):
        g = _random_like(jp, 20 + i)
        g["layers"]["mixer"]["wq"][0] *= 100.0
        rounds.append(g)
    je = JC.init_error_state(jp)
    te = TC.init_error_state(_port_tree(jax.tree.map(np.asarray, jp)))
    for g in rounds:
        jd, je = JC.compress_grads(jax.tree.map(jnp.asarray, g), je)
        td, te = TC.compress_grads(_port_tree(g), te)
        for a, b in ((jd, td), (je, te)):
            ja, tb = jax_flatten(a), _flat_port(b)
            for k in ja:
                np.testing.assert_array_equal(tb[k], ja[k], err_msg=k)
    # one scale a layer would not give JAX's bits on layer 1
    x = torch.from_numpy(rounds[0]["layers"]["mixer"]["wq"][1])
    per_layer = torch.round(x / (x.abs().max() / 127.0)) * (
        x.abs().max() / 127.0)
    assert not torch.equal(per_layer, td["layers"][1]["mixer"]["wq"])
    assert TC.compression_ratio(td) == JC.compression_ratio(jd)


def test_compression_error_feedback_unbiased():
    """Mirror of ``tests/test_train.py``'s: the accumulated dequantized
    gradient tracks the true sum."""
    g = np.random.default_rng(0).normal(0, 1, (64, 64)).astype(np.float32)
    err = TC.init_error_state({"w": torch.zeros(64, 64)})
    total_deq = np.zeros((64, 64))
    for _ in range(50):
        deq, err = TC.compress_grads({"w": torch.from_numpy(g.copy())}, err)
        total_deq += deq["w"].numpy()
    rel = np.abs(total_deq - 50 * g).max() / np.abs(50 * g).max()
    assert rel < 0.01, rel


# -------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch,vocab", [
    pytest.param(ARCH, 256, id="256"), pytest.param(ARCH, 250, id="250"),
    pytest.param("qwen3-32b", 256, id="qwen3-32b"),
    pytest.param("minitron-4b", 256, id="minitron-4b")])
def test_loss_and_gradients_match_jax(arch, vocab):
    """``loss_fn`` and the gradient of every master leaf, on qwen2-1.5b's
    smoke config and on qwen3-32b's (``qk_norm``) and minitron-4b's (3
    query heads on one KV head).  Vocab 250 pads to 256: the six padded
    columns of the head enter the log-softmax and the z-loss, as in the
    JAX package, and get gradients."""
    jcfg = dataclasses.replace(jax_smoke(arch), vocab_size=vocab)
    tcfg = dataclasses.replace(get_smoke_config(arch), vocab_size=vocab)
    jp, tp = _jax_masters(0, (jcfg, tcfg))
    tokens = np.random.default_rng(3).integers(0, vocab, (4, 32)).astype(
        np.int32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg, q_block=16)))(
            jp, {"tokens": jnp.asarray(tokens)})
    for leaf in leaves(tp):
        for p in leaf.parts:
            p.requires_grad_(True)
    tl = TM.loss_fn(tp, {"tokens": torch.from_numpy(tokens)}, tcfg,
                    q_block=16)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    tg = {leaf.key: np.stack([p.grad.numpy() for p in leaf.parts])
          if leaf.stacked else leaf.parts[0].grad.numpy()
          for leaf in leaves(tp)}
    for k, want in jax_flatten(jg).items():
        assert tg[k].dtype == np.float32 and tg[k].shape == want.shape
        err = np.abs(tg[k] - want).max()
        assert err <= GRAD_TOL * np.abs(want).max(), (k, err)
    if vocab != tcfg.vocab_padded:
        pad = tg["head"][:, vocab:]
        assert np.abs(pad).max() > 0  # padded columns are in the softmax
        np.testing.assert_allclose(
            pad, np.asarray(jg["head"])[:, vocab:],
            atol=GRAD_TOL * np.abs(np.asarray(jg["head"])).max())


def test_remat_policies():
    """``"full"`` (recompute each layer), ``"dots"`` (save the products'
    outputs, recompute the rest) and ``"none"`` give the loss and every
    gradient bitwise; ``"dots"`` calls no product again in the backward,
    ``"full"`` each layer's (ROADMAP queue A item 13); an unknown policy
    is refused."""
    _, tp = _jax_masters()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 16)).astype(np.int32))
    mod = sys.modules["repro_torch.kernels.linear"]
    real, calls = mod._forward, []
    out = {}
    try:
        mod._forward = lambda *a: calls.append(1) or real(*a)
        for policy in ("full", "dots", "none"):
            ps = master_params_from_arrays(arrays_from_master_params(tp),
                                           CFG, "cpu")
            for leaf in leaves(ps):
                for p in leaf.parts:
                    p.requires_grad_(True)
            calls.clear()
            loss = TM.loss_fn(ps, {"tokens": tokens}, CFG, q_block=8,
                              remat_policy=policy)
            n_forward = len(calls)
            loss.backward()
            out[policy] = (loss.detach(), [p.grad for leaf in leaves(ps)
                                           for p in leaf.parts],
                           n_forward, len(calls) - n_forward)
    finally:
        mod._forward = real
    for policy in ("dots", "none"):
        assert torch.equal(out[policy][0], out["full"][0])
        assert all(torch.equal(a, b)
                   for a, b in zip(out[policy][1], out["full"][1]))
    per_layer = 4  # q/k/v, wo, gate/up, w_down
    assert out["full"][2:] == (per_layer * CFG.n_layers + 1,
                               per_layer * CFG.n_layers)
    assert out["dots"][2:] == (per_layer * CFG.n_layers + 1, 0)
    with pytest.raises(ValueError, match="remat_policy must be one of"):
        TM.loss_fn(tp, {"tokens": tokens}, CFG, remat_policy="offload")


# ---------------------------------------------------------- train curve
def _runs(steps, compress=False, seed=0, lr=3e-3, m_dtype="f32",
          jax_too=True):
    """``tests/test_train.py``'s ``_run`` through both packages from the
    same masters: the JAX losses and the port's."""
    kw = dict(lr=lr, warmup_steps=3, total_steps=25, m_dtype=m_dtype)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=CFG.vocab_size, seq_len=32, global_batch=8, seed=seed))
    jp, tp = _jax_masters(seed)
    tcfg = TrainConfig(microbatches=2, compress_grads=compress, q_block=32,
                       adamw=TOPT.AdamWConfig(**kw))
    ts = {"opt": TOPT.init(tp, tcfg.adamw),
          "step": torch.zeros((), dtype=torch.int32)}
    if compress:
        ts["err"] = TC.init_error_state(tp)
    tstep = make_train_step(CFG, tcfg)
    if jax_too:
        jt = JaxTrainConfig(microbatches=2, compress_grads=compress,
                            q_block=32, adamw=JOPT.AdamWConfig(**kw))
        js = {"opt": JOPT.init(jp, jt.adamw), "step": jnp.zeros((), jnp.int32)}
        if compress:
            js["err"] = JC.init_error_state(jp)
        jstep = jax.jit(jax_make_step(jax_smoke(ARCH), jt))
    jl, tl = [], []
    for s in range(steps):
        b = pipe.batch_at(s)
        tp, ts, loss = tstep(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        tl.append(float(loss))
        if jax_too:
            jp, js, loss = jstep(jp, js, {k: jnp.asarray(v)
                                          for k, v in b.items()})
            jl.append(float(loss))
    assert int(ts["step"]) == steps
    return jl, tl, ts


@pytest.mark.parametrize("compress", [False, True])
def test_training_curve_matches_jax(compress):
    """Ten steps of ``tests/test_train.py:15``'s setup (with and without
    compression), each loss within ``CURVE_RTOL`` of JAX's."""
    jl, tl, _ = _runs(10, compress=compress)
    np.testing.assert_allclose(tl, jl, rtol=CURVE_RTOL)


@pytest.mark.parametrize("compress", [False, True])
def test_loss_decreases(compress):
    """Mirrors of ``test_loss_decreases`` and
    ``test_loss_decreases_with_compression``."""
    _, losses, _ = _runs(25, compress=compress, jax_too=False)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_bf16_momentum_converges():
    _, losses, state = _runs(25, m_dtype="bf16", jax_too=False)
    assert state["opt"].m["head"].dtype == torch.bfloat16
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_microbatch_equivalence():
    """1 vs 4 microbatches: the same gradient step."""
    _, tp0 = _jax_masters()
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=CFG.vocab_size, seq_len=16, global_batch=8, seed=1))
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    outs = []
    for m in (1, 4):
        tp = master_params_from_arrays(arrays_from_master_params(tp0), CFG,
                                       "cpu")
        tcfg = TrainConfig(microbatches=m, q_block=16,
                           adamw=TOPT.AdamWConfig(lr=1e-3, warmup_steps=0))
        state = {"opt": TOPT.init(tp), "step": torch.zeros((),
                                                           dtype=torch.int32)}
        p2, _, loss = make_train_step(CFG, tcfg)(tp, state, batch)
        outs.append((float(loss), _flat_port(p2)))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=2e-2)
    assert max(np.abs(outs[0][1][k] - outs[1][1][k]).max()
               for k in outs[0][1]) < 5e-2


# -------------------------------------------------------------- launcher
def _train_argv(ckpt, steps=20):
    return ["--smoke", "--device", "cpu", "--steps", str(steps),
            "--ckpt-dir", str(ckpt)]


def test_launcher_improves_and_resumes_bitwise_after_sigterm(tmp_path,
                                                             capsys):
    """The launcher on the CPU prints "improved"; a run stopped by SIGTERM
    after its step-9 line saves through ``PreemptionHandler`` and stops;
    ``--resume auto`` then gives the uninterrupted run's losses bitwise
    from the resumed step on."""
    from repro_torch.launch import train

    full = train.main(_train_argv(tmp_path / "full"))
    assert "(improved)" in capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cut = tmp_path / "cut"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_train_argv(cut), "--ckpt-every", "1000"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step     9 "):
                proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    stop = [ln for ln in lines if ln.startswith("preempted at step")]
    assert stop and "checkpoint saved, stopping" in stop[0], lines
    at = int(stop[0].split()[3].rstrip(";"))
    assert at >= 9
    resumed = train.main(_train_argv(cut) + ["--resume", "auto"])
    assert f"resumed from step {at + 1}" in capsys.readouterr().out
    assert resumed == full[at + 1:]


def test_launcher_needs_cuda_by_default(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("flag", [["--elastic"], ["--fault-plan", "seed:0:4"],
                                  ["--snapshot-dir", "x"], ["--workers", "2"],
                                  ["--model-parallel", "2"],
                                  ["--chips-per-host", "4"]])
def test_launcher_elastic_flags_name_item_10(flag, tmp_path, capsys):
    """The elastic flags (ROADMAP queue A item 10a) act as in the JAX
    launcher: ``--elastic`` alone exits asking for a snapshot directory;
    with one, each flag runs the supervision loop to its end (a seeded
    plan on 4 workers, 2 workers, a model axis of 2, hosts of 4 chips);
    without ``--elastic`` the supervision flags change nothing."""
    from repro_torch.launch import train

    base = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16",
            "--batch", "4", "--ckpt-every", "1"]
    if flag == ["--elastic"]:
        with pytest.raises(SystemExit, match="snapshot-dir"):
            train.main(base + flag)
        return
    plain = train.main(base + flag)
    assert len(plain) == 2
    extra = {"--fault-plan": ["--workers", "4"],
             "--snapshot-dir": ["--workers", "1"],
             "--workers": [], "--model-parallel": ["--workers", "1"],
             "--chips-per-host": ["--workers", "1"]}[flag[0]]
    snap = str(tmp_path / "snap")
    if flag[0] == "--snapshot-dir":
        flag = ["--snapshot-dir", snap]
    else:
        extra = extra + ["--snapshot-dir", snap]
    capsys.readouterr()
    losses = train.main(base + ["--elastic", *flag, *extra])
    out = capsys.readouterr().out
    assert len(losses) >= 2 and "elastic run: 2/2 steps" in out, out
    assert losses[:2] == plain  # one device: the same function


def test_launcher_trace_metrics_profile_and_compression(tmp_path, capsys):
    """``--trace``, ``--metrics-out``, ``--torch-profile`` and
    ``--compress-grads`` on the CPU: the files are written and the
    compression ratio is the JAX package's for the same tree."""
    import json

    from repro_torch.launch import train

    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    losses = train.main(["--smoke", "--device", "cpu", "--steps", "3",
                         "--compress-grads", "--trace", str(trace),
                         "--metrics-out", str(metrics), "--torch-profile",
                         str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "step time p50=" in out
    assert len(json.loads(trace.read_text())["traceEvents"]) >= 3
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert len(rows) == 3
    want = JC.compression_ratio(JM.init_params(jax_smoke(ARCH),
                                               jax.random.PRNGKey(0)))
    assert rows[-1]["gauges"]["train.compression_ratio"] == want
    assert (tmp_path / "prof" / "trace.json").exists()
