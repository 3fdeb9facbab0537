"""The port's dense decode cache (the ring) against the JAX package, on the
CPU: ``arch.model.decode_step``, ``ServeEngine.step`` / ``generate``, and
both batchers in dense mode.

Smoke configs ``qwen2-1.5b-smoke`` (global attention),
``gemma3-27b-smoke`` (``local_window`` 8 on five of its six layers),
``qwen3-32b-smoke`` (``qk_norm`` with no window, 2 query heads a KV head)
and ``minitron-4b-smoke`` (3 query heads on one KV head, an odd count);
the
JAX package's random-init weights, and where a test starts mid-run its
decode state, are carried across with ``arch.convert``.

Tolerances, as in ``test_torch_serve.py``: the float32 logits of the two
packages lie within ``LOGIT_TOL`` (3%) of the JAX logits' largest
magnitude at every step, and greedy tokens are equal wherever the JAX
top-2 margin exceeds twice that bound.  In a batcher a slot reused by a
later request starts at the global position and sees the cells its slot
held, so a near tie in one request can reach the next request of the same
slot: a stream is compared up to the first near tie of its slot.
Admission verdicts and drop reasons, and the port against itself (host ==
device batcher, paged == dense, ring == the plain mask below the wrap),
are bitwise.
"""
import dataclasses
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
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.obs import Metrics as JaxMetrics  # noqa: E402
from repro.obs import Tracer as JaxTracer  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro_torch.arch import model as TM  # noqa: E402
from repro_torch.arch.convert import (decode_state_from_arrays,  # noqa: E402
                                      params_from_arrays)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.paged_attention import visible_rows  # noqa: E402
from repro_torch.obs import Metrics, Tracer  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import faults as TF  # noqa: E402
from test_torch_serve import (DS, LOGIT_TOL, _engine,  # noqa: E402,F401
                              _near_tie_bound, _top2_margin, both)

ROOT = Path(__file__).resolve().parents[1]
QWEN, GEMMA = "qwen2-1.5b", "gemma3-27b"
# the dense configs held against the JAX package besides qwen2's, each a
# case of the decode, generate, batcher and paged == dense tests
NEW_ARCHS = ("qwen3-32b", "minitron-4b")
_MODELS = {}
DEADLINE = 3.0  # seconds of the ticking clock: request 3 expires mid-run


@pytest.fixture(scope="module")
def gemma():
    """(JAX params, port params) of the windowed smoke config."""
    jp = JM.init_params(jax_smoke(GEMMA), jax.random.PRNGKey(1))
    return jp, params_from_arrays(jax.tree.map(np.asarray, jp),
                                  get_smoke_config(GEMMA), "cpu")


def _arch(both, arch=QWEN):
    """(JAX params, port params, JAX gate, port gate, arch) of ``arch``'s
    smoke config: qwen2's are ``both``; another arch's JAX random-init
    weights (key 0) carried across, beside ``both``'s gates."""
    if arch == QWEN:
        return (*both, QWEN)
    if arch not in _MODELS:
        jp = JM.init_params(jax_smoke(arch), jax.random.PRNGKey(0))
        _MODELS[arch] = (jp, params_from_arrays(
            jax.tree.map(np.asarray, jp), get_smoke_config(arch), "cpu"))
    return (*_MODELS[arch], both[2], both[3], arch)


def _dense(both, gate=True, batch=4, cache_len=32, arch=QWEN, **kw):
    """A port engine over the dense cache (no page_size)."""
    if arch == QWEN:
        return _engine(both, gate=gate, batch=batch, cache_len=cache_len,
                       page_size=0, **kw)
    _, tp, _, tg, _ = _arch(both, arch)
    return TE.ServeEngine(get_smoke_config(arch), tp, TE.ServeConfig(
        max_batch=batch, cache_len=cache_len, **kw),
        gate=tg if gate else None, device="cpu")


def _jax_dense(both, batch=4, cache_len=32, arch=QWEN, **kw):
    jp, _, jg, _, _ = _arch(both, arch)
    return JE.ServeEngine(jax_smoke(arch), jp, JE.ServeConfig(
        max_batch=batch, cache_len=cache_len, **kw), gate=jg)


def _workload(cb, n_req=10, seed=0, max_steps=300):
    """``tests/test_serve.py``'s dense workload: single-token prompts."""
    rng = np.random.default_rng(seed)
    for rid in range(n_req):
        cb.submit(rid, int(rng.integers(1, 100)), features=DS.X_test[rid])
    return cb.run(max_steps=max_steps)


def _check_logits(lt: np.ndarray, lj: np.ndarray) -> None:
    """Every row within ``LOGIT_TOL`` of max |JAX logits|, and greedy equal
    where the JAX top-2 margin is clear of the near-tie bound."""
    assert lt.shape == lj.shape
    diff = np.abs(lt - lj).max(-1)
    assert (diff <= LOGIT_TOL * np.abs(lj).max(-1)).all(), diff.max()
    clear = _top2_margin(lj) > _near_tie_bound(lj)
    np.testing.assert_array_equal(lt.argmax(-1)[clear], lj.argmax(-1)[clear])
    assert clear.mean() > 0.5


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("arch,gqa_impl,kv_dtype", [
    pytest.param(QWEN, g, k, id=f"{g}-{k}")
    for g in ("repeat", "grouped") for k in ("bf16", "int8")] + [
    pytest.param(a, g, k, id=f"{a}-{g}-{k}") for a in NEW_ARCHS
    for g, k in (("repeat", "bf16"), ("grouped", "int8"))])
def test_decode_step_matches_jax(both, arch, kv_dtype, gqa_impl):
    """Teacher-forced steps from pos 0 past the ring's wrap (cache 16, 24
    steps) on ``arch``'s smoke config: the logits of every step within
    the tolerance, greedy equal beyond the near-tie margin."""
    jp, tp, _, _, _ = _arch(both, arch)
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    toks = np.random.default_rng(5).integers(1, 97, (2, 24)).astype(np.int32)
    js = JM.init_decode_state(jcfg, 2, 16, kv_dtype=kv_dtype)
    ts = TM.init_decode_state(cfg, 2, 16, kv_dtype=kv_dtype, device="cpu")
    step = jax.jit(lambda p, s, t: JM.decode_step(p, s, t, jcfg,
                                                  gqa_impl=gqa_impl))
    lj, lt = [], []
    for t in range(24):
        out, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        lj.append(np.asarray(out))
        out, ts = TM.decode_step(tp, ts, torch.as_tensor(toks[:, t:t + 1]),
                                 cfg, gqa_impl=gqa_impl)
        assert out.dtype == torch.float32
        lt.append(out.numpy())
    assert int(ts["pos"]) == int(js["pos"]) == 24
    _check_logits(np.concatenate(lt), np.concatenate(lj))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_windowed_decode_across_the_wrap_matches_jax(gemma, kv_dtype):
    """gemma3-27b's smoke config (window 8 on five of six layers), cache
    16: the JAX package decodes 20 steps, its state (pos 20, past the
    wrap) is carried into the port, and both go on for 20 more steps
    across two more wraps: logits within the tolerance at every step."""
    jp, tp = gemma
    jcfg, cfg = jax_smoke(GEMMA), get_smoke_config(GEMMA)
    assert cfg.local_window == 8 and TM.layer_windows(cfg).tolist() == [
        8, 8, 8, 8, 8, 0]
    toks = np.random.default_rng(6).integers(1, 97, (2, 40)).astype(np.int32)
    js = JM.init_decode_state(jcfg, 2, 16, kv_dtype=kv_dtype)
    step = jax.jit(lambda p, s, t: JM.decode_step(p, s, t, jcfg))
    for t in range(20):
        _, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
    ts = decode_state_from_arrays(jax.tree.map(np.asarray, js), cfg, "cpu")
    assert int(ts["pos"]) == 20
    lj, lt = [], []
    for t in range(20, 40):
        out, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        lj.append(np.asarray(out))
        lt.append(TM.decode_step(tp, ts, torch.as_tensor(toks[:, t:t + 1]),
                                 cfg)[0].numpy())
    _check_logits(np.concatenate(lt), np.concatenate(lj))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_decode_state_from_arrays_carries_the_jax_state(both, kv_dtype):
    jp, _, _, _ = both
    jcfg, cfg = jax_smoke(QWEN), get_smoke_config(QWEN)
    js = JM.init_decode_state(jcfg, 2, 8, kv_dtype=kv_dtype)
    step = jax.jit(lambda p, s, t: JM.decode_step(p, s, t, jcfg))
    for t in range(11):
        _, js = step(jp, js, jnp.full((2, 1), t + 3, jnp.int32))
    ts = decode_state_from_arrays(jax.tree.map(np.asarray, js), cfg, "cpu")
    assert ts["pos"].dtype == torch.int32 and int(ts["pos"]) == 11
    assert ("kv_scales" in ts) == (kv_dtype == "int8")
    for name in ("kv", "kv_scales") if kv_dtype == "int8" else ("kv",):
        for t, j in zip(ts[name], js[name]):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(j, np.float32))
    with pytest.raises(ValueError, match="n_layers|\\["):
        decode_state_from_arrays({"pos": 0, "kv": (np.zeros((1, 2)),) * 2},
                                 cfg, "cpu")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_uncommitted_step_leaves_the_state_bitwise(both, kv_dtype):
    """``commit`` False (a device batcher step with no work): every cache
    plane and ``pos`` bitwise as they were; True is the plain step."""
    _, tp, _, _ = both
    cfg = get_smoke_config(QWEN)
    st = TM.init_decode_state(cfg, 2, 8, kv_dtype=kv_dtype, device="cpu")
    for t in range(10):
        TM.decode_step(tp, st, torch.full((2, 1), t + 1), cfg)
    planes = [p.clone() for k in ("kv", "kv_scales") for p in st.get(k, ())]
    tok = torch.full((2, 1), 9)
    TM.decode_step(tp, st, tok, cfg, commit=torch.tensor(False))
    assert int(st["pos"]) == 10
    now = [p for k in ("kv", "kv_scales") for p in st.get(k, ())]
    assert all(torch.equal(a, b) for a, b in zip(planes, now))
    want = {k: tuple(p.clone() for p in v) if k != "pos" else v.clone()
            for k, v in st.items()}
    a, _ = TM.decode_step(tp, want, tok, cfg)
    b, _ = TM.decode_step(tp, st, tok, cfg, commit=torch.tensor(True))
    assert torch.equal(a, b) and int(st["pos"]) == 11
    assert all(torch.equal(x, y) for k in st if k != "pos"
               for x, y in zip(st[k], want[k]))


def test_gqa_impl_and_cache_type_are_checked(both):
    _, tp, _, _ = both
    cfg = get_smoke_config(QWEN)
    st = TM.init_decode_state(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="gqa_impl"):
        TM.decode_step(tp, st, torch.ones((2, 1), dtype=torch.int32), cfg,
                       gqa_impl="einsum")
    with pytest.raises(ValueError, match="kv_dtype"):
        TM.init_decode_state(cfg, 2, 8, kv_dtype="fp8", device="cpu")


# ------------------------------------------------ the ring's plain version
def _ring_case(seed, B, S, quantized):
    rng = np.random.default_rng(seed)
    H, KV, hd = 4, 2, 16
    q = torch.as_tensor(rng.normal(0, 1, (B, 1, H, hd)), dtype=torch.bfloat16)
    shape = (B, S, KV, hd)
    if quantized:
        k, v = (torch.as_tensor(rng.integers(-127, 128, shape),
                                dtype=torch.int8) for _ in "kv")
        ks, vs = (torch.as_tensor(rng.uniform(0.005, 0.02, shape[:-1] + (1,)),
                                  dtype=torch.float32) for _ in "kv")
    else:
        k, v = (torch.as_tensor(rng.normal(0, 1, shape), dtype=torch.bfloat16)
                for _ in "kv")
        ks = vs = None
    tbl = torch.arange(B, dtype=torch.int32)[:, None]
    return q, k, v, tbl, ks, vs


@pytest.mark.parametrize("window", [0, 5, 13])
@pytest.mark.parametrize("quantized", [False, True])
def test_ring_below_the_wrap_is_the_plain_mask(window, quantized):
    """Below the wrap the ring changes nothing: bitwise the version
    without the ring, at every position of the axis (and -1)."""
    q, k, v, tbl, ks, vs = _ring_case(1, 3, 16, quantized)
    for p in (-1, 0, 4, 9, 15):
        pos = torch.tensor([[p], [max(p - 3, 0)], [15]], dtype=torch.int32)
        a = ref.paged_attention_ref(q, k, v, tbl, pos, window, ks, vs)
        b = ref.paged_attention_ref(q, k, v, tbl, pos, window, ks, vs,
                                    ring=True)
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", [0, 5, 13, 16, 40])
@pytest.mark.parametrize("quantized", [False, True])
def test_ring_past_the_wrap_is_the_unrolled_cache(window, quantized):
    """Past the wrap, the ring at position p equals the version without
    the ring over the same cells laid out in absolute order (cell i at
    logical position abs_i - (p - S + 1), the query at S - 1), within
    one bf16 ulp (the sums run over the positions in another order)."""
    S = 16
    q, k, v, tbl, ks, vs = _ring_case(2, 2, S, quantized)
    for p in (16, 21, 31, 32, 47, 100):
        pos = torch.tensor([[p], [p + 3]], dtype=torch.int32)
        got = ref.paged_attention_ref(q, k, v, tbl, pos, window, ks, vs,
                                      ring=True)
        for b in range(2):
            pb = int(pos[b, 0])
            i = np.arange(S)
            w, s = pb // S, pb % S
            absp = np.where(i <= s, i + w * S, i + (w - 1) * S)
            order = torch.as_tensor(np.argsort(absp - (pb - S + 1)))
            unrolled = [t[b:b + 1, order] if t is not None else None
                        for t in (k, v, ks, vs)]
            want = ref.paged_attention_ref(
                q[b:b + 1], unrolled[0], unrolled[1], tbl[:1],
                torch.tensor([[S - 1]], dtype=torch.int32), window,
                unrolled[2], unrolled[3])
            m = want.float().abs().max().item()
            ulp = 2.0 ** (np.floor(np.log2(m)) - 7)
            assert (got[b:b + 1].float() - want.float()).abs().max() <= ulp


@pytest.mark.parametrize("window", [0, 3, 8, 20])
def test_ring_visible_rows_cover_every_visible_cell(window):
    """The kernel's range (``visible_rows``): every cell the ring mask
    admits lies in it, and without a wrapped window it is exactly the
    window."""
    S = 16
    for p in range(0, 70, 3):
        n = int(visible_rows([[p]], window, S, ring=True)[0])
        s = p % S if p >= S else p
        d = (s - np.arange(S)) % S if p >= S else s - np.arange(S)
        seen = (d >= 0) & ((d < window) if window else True)
        assert n >= int(seen.sum())
        if p >= S and window and s - window + 1 >= 0:
            assert n == window


# ------------------------------------------------------------ the engine
def test_step_fuses_the_gate(both):
    """``step`` with features: the gate's labels (the mapped model's
    verdicts) beside the logits; without, no labels."""
    _, _, _, tg = both
    eng = _dense(both)
    feats = DS.X_test[:4]
    logits, labels = eng.step(np.zeros((4, 1), np.int32), feats)
    np.testing.assert_array_equal(labels, tg.predict(feats))
    assert logits.shape == (4, eng.cfg.vocab_padded)
    assert logits.dtype == np.float32
    assert eng.step(np.zeros((4, 1), np.int32))[1] is None
    assert int(eng.state["pos"]) == 2


def test_generate_shapes_determinism_and_nonblocking(both):
    eng = _dense(both)
    prompts = np.ones((4, 3), np.int64)
    out = eng.generate(prompts, n_tokens=5, features=DS.X_test[:4])
    assert out.shape == (4, 5)
    assert (out >= 0).all() and (out < eng.cfg.vocab_padded).all()
    eng.state = TM.init_decode_state(eng.cfg, 4, 32, device="cpu")
    dev = eng.generate(prompts, 5, features=DS.X_test[:4], block=False)
    assert torch.is_tensor(dev) and dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(), out)
    logits, labels = eng.step(np.ones((4, 1), np.int32), DS.X_test[:4],
                              block=False)
    assert torch.is_tensor(logits) and torch.is_tensor(labels)
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate(np.ones((3, 2)), 2)


@pytest.mark.parametrize("arch", [QWEN, *NEW_ARCHS])
def test_generate_matches_jax(both, arch):
    """JAX ``ServeEngine.generate`` vs the port's on the same prompts (12
    generated tokens from 3-token prompts, cache 8: past the wrap): each
    slot's stream equal up to its first JAX near tie, from the JAX
    model's logits along its own stream (the smoke model's top-2 margins
    are often within the bound: on qwen2's, 14 of the 48 tokens are
    compared)."""
    jp, _, _, _, _ = _arch(both, arch)
    jcfg = jax_smoke(arch)
    prompts = np.random.default_rng(2).integers(1, 97, (4, 3))
    je = _jax_dense(both, cache_len=8, arch=arch)
    want = np.asarray(je.generate(prompts, 12, features=DS.X_test[:4]))
    got = _dense(both, cache_len=8, arch=arch).generate(
        prompts, 12, features=DS.X_test[:4])
    seqs = np.concatenate([prompts, want], 1).astype(np.int32)
    js = JM.init_decode_state(jcfg, 4, 8)
    step = jax.jit(lambda p, s, t: JM.decode_step(p, s, t, jcfg))
    rows = []
    for t in range(seqs.shape[1] - 1):
        lg, js = step(jp, js, jnp.asarray(seqs[:, t:t + 1]))
        if t >= prompts.shape[1] - 1:
            rows.append(np.asarray(lg))
    lj = np.stack(rows, 1)  # [B, 12, Vp]
    near = _top2_margin(lj) <= _near_tie_bound(lj)
    compared = 0
    for b in range(4):
        upto = int(np.argmax(near[b])) if near[b].any() else 12
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])
        compared += upto
    assert compared >= 12, compared  # 14 of the 48 on this workload


def _record_steps(jcb):
    """Wrap the JAX engine's ``step`` so that each call logs the slots'
    requests and the logits it returned."""
    log = []
    inner = jcb.engine.step

    def step(tokens, features=None, block=True):
        logits, labels = inner(tokens, features, block)
        log.append((list(jcb.slot_req), np.asarray(logits)))
        return logits, labels

    jcb.engine.step = step
    return log


def _compared(log, want, got) -> int:
    """Walk the JAX run's steps: each live slot's token of the step is
    compared while its slot has not diverged; the first token that
    differs must come where the JAX top-2 margin is a near tie, and ends
    the comparison of that slot (its later requests see its cells).
    Returns the tokens found equal."""
    diverged, at = set(), {r: 0 for r in want}
    compared = 0
    for reqs, lg in log:
        near = _top2_margin(lg) <= _near_tie_bound(lg)
        for b, r in enumerate(reqs):
            if r is None or r not in at:
                continue
            i = at[r]
            at[r] += 1
            if b in diverged:
                continue
            if got[r][i] == want[r][i]:
                compared += 1
            else:
                assert near[b], (r, i)
                diverged.add(b)
    return compared


@pytest.mark.parametrize("arch", [QWEN, *NEW_ARCHS])
def test_dense_host_batcher_matches_jax(both, arch):
    """JAX ``ContinuousBatcher`` (dense) vs the port's, 10 single-token
    requests with gate features through 4 slots, cache 8 (the global
    position wraps): drops, reasons, steps and drains equal; each slot's
    streams equal to the JAX package's until a token that differs where
    the JAX top-2 margin is a near tie (``_compared``)."""
    jcb = JE.ContinuousBatcher(_jax_dense(both, cache_len=8, arch=arch),
                               eos_token=-1, max_tokens=6)
    log = _record_steps(jcb)
    tcb = TE.ContinuousBatcher(_dense(both, cache_len=8, arch=arch),
                               eos_token=-1, max_tokens=6)
    dj, dt = _workload(jcb), _workload(tcb)
    assert tcb.dropped == jcb.dropped and tcb.drop_reasons == jcb.drop_reasons
    assert sorted(dt) == sorted(dj) and len(dj) >= 4
    assert {r: len(t) for r, t in dt.items()} == {r: len(t)
                                                  for r, t in dj.items()}
    assert tcb.max_live == jcb.max_live and tcb._drains == jcb._drains
    assert len(log) == jcb._drains > 8
    compared = _compared(log, dj, dt)
    assert compared >= 8, compared  # all 36 on this workload, each arch


# --------------------------------------------------- port vs itself
def _host(both, cfg=None, arch=QWEN, **kw):
    return TE.ContinuousBatcher(_dense(both, arch=arch,
                                       **kw.pop("engine_kw", {})),
                                eos_token=kw.pop("eos", -1),
                                max_tokens=kw.pop("max_tokens", 4), **kw)


def _device(both, sync_every=3, arch=QWEN, **kw):
    return TE.DeviceContinuousBatcher(
        _dense(both, arch=arch, **kw.pop("engine_kw", {})),
        eos_token=kw.pop("eos", -1), max_tokens=kw.pop("max_tokens", 4),
        sync_every=sync_every, **kw)


def test_host_batcher_drains_queue(both):
    cb = _host(both)
    rng = np.random.default_rng(0)
    n = sum(bool(cb.submit(rid, int(rng.integers(1, 100)),
                           features=DS.X_test[rid])) for rid in range(10))
    done = cb.run(max_steps=200)
    assert len(done) == n and len(cb.dropped) == 10 - n
    assert all(len(t) == 4 for t in done.values())
    assert cb.pool is None and int(cb.engine.state["pos"]) == cb.steps


@pytest.mark.parametrize("arch,sampled", [
    pytest.param(QWEN, False, id="False"), pytest.param(QWEN, True, id="True")]
    + [pytest.param(a, False, id=f"{a}-False") for a in NEW_ARCHS])
def test_device_equals_host(both, arch, sampled):
    """Streams, drops, reasons, steps with work and the global position
    bitwise equal, greedy and sampled (temperature 2, top-k 40)."""
    kw = dict(temperature=2.0, top_k=40) if sampled else {}
    host = _host(both, arch=arch, engine_kw=kw)
    dev = _device(both, arch=arch, engine_kw=kw)
    done_h, done_d = _workload(host), _workload(dev)
    assert done_d == done_h and len(done_h) >= 4
    assert dev.dropped == host.dropped
    assert dev.drop_reasons == host.drop_reasons
    assert dev.steps == host.steps
    assert int(dev._decode["pos"]) == int(host.engine.state["pos"])


def test_device_equals_host_across_the_windowed_wrap(both, gemma):
    """gemma3-27b's smoke config (window 8), cache 16, 12 tokens a
    request: the global position passes the wrap; host == device
    bitwise."""
    _, tp = gemma
    cfg = get_smoke_config(GEMMA)
    _, _, _, tg = both

    def eng():
        return TE.ServeEngine(cfg, tp, TE.ServeConfig(max_batch=4,
                                                      cache_len=16),
                              gate=tg, device="cpu")

    host = TE.ContinuousBatcher(eng(), eos_token=-1, max_tokens=12)
    dev = TE.DeviceContinuousBatcher(eng(), eos_token=-1, max_tokens=12,
                                     sync_every=4)
    done_h = _workload(host, n_req=12)
    assert _workload(dev, n_req=12) == done_h
    assert dev.dropped == host.dropped and dev.steps == host.steps
    assert int(dev._decode["pos"]) == host.steps > 16


def test_device_equals_host_with_eos_eviction(both):
    probe = _host(both, max_tokens=6)
    eos = next(int(v[1]) for v in _workload(probe).values() if len(v) > 1)
    host = _host(both, eos=eos, max_tokens=6)
    dev = _device(both, eos=eos, max_tokens=6, sync_every=4)
    done_h = _workload(host)
    assert _workload(dev) == done_h
    assert any(len(v) < 6 for v in done_h.values())


@pytest.mark.parametrize("sync_every", [1, 7])
def test_sync_every_is_invariant(both, sync_every):
    ref = _workload(_device(both, sync_every=3))
    cb = _device(both, sync_every=sync_every)
    assert _workload(cb) == ref
    assert 0 <= cb.steps_wasted < sync_every


def test_in_step_gate_eviction(both):
    """``pregate=False``: the in-step gate's verdict evicts a request on
    its first step, before any token is recorded."""
    cb = _device(both, pregate=False, sync_every=4)
    _workload(cb)
    keep = cb.engine.admit(DS.X_test[:10])
    assert sorted(cb.dropped) == sorted(np.where(~keep)[0])
    assert set(cb.drop_reasons.values()) == {"gate-reject"}
    assert sorted(cb.done) == sorted(np.where(keep)[0])


def test_bounded_runs_resume_to_the_host_run(both):
    """``max_steps``-bounded runs carry in-flight slots and re-enqueue
    un-admitted entries; the resumed schedule equals the host batcher's
    single run, the global position too."""
    host = _host(both)
    done_h = _workload(host)
    dev = _device(both, sync_every=2)
    rng = np.random.default_rng(0)
    for rid in range(10):
        dev.submit(rid, int(rng.integers(1, 100)), features=DS.X_test[rid])
    for _ in range(100):
        dev.run(max_steps=3)
        if not dev.queue and all(c is None for c in dev._carry):
            break
    assert dev.done == done_h and dev.dropped == host.dropped
    assert int(dev._decode["pos"]) == int(host.engine.state["pos"])


def test_multi_wave_reuses_the_cache(both):
    """Back-to-back ``run()`` calls share the ring (the position carries
    over and the second wave sees the first wave's cells): the device
    batcher's two waves equal the host batcher's bitwise."""
    out = []
    for cb in (_device(both, max_tokens=3, sync_every=2),
               _host(both, max_tokens=3)):
        for rid in range(5):
            cb.submit(("a", rid), rid + 1, features=DS.X_test[rid])
        first = dict(cb.run(max_steps=100))
        for rid in range(5):
            cb.submit(("b", rid), rid + 1, features=DS.X_test[rid])
        both_waves = cb.run(max_steps=100)
        assert set(first).issubset(both_waves)
        assert len(both_waves) + len(cb.dropped) == 10
        out.append((dict(both_waves), list(cb.dropped)))
    assert out[0] == out[1]
    # the second wave's streams depend on the first wave's cells
    fresh = _device(both, max_tokens=3, sync_every=2)
    for rid in range(5):
        fresh.submit(("b", rid), rid + 1, features=DS.X_test[rid])
    second = {r: t for r, t in out[0][0].items() if r[0] == "b"}
    assert fresh.run(max_steps=100) != second


@pytest.mark.parametrize("arch,batcher", [
    pytest.param(QWEN, b, id=b) for b in ("device", "host")] + [
    pytest.param(a, b, id=f"{a}-{b}") for a in NEW_ARCHS
    for b in ("device", "host")])
def test_paged_decode_bit_identical_to_dense(both, arch, batcher):
    """One wave, every slot admitted at step 0, single-token prompts:
    paged decode bitwise equal to the dense ring cache
    (``tests/test_serve.py`` ``test_paged_decode_bit_identical_to_dense``)."""
    out = []
    for page_size in (0, 8):
        eng = (_engine(both, page_size=page_size) if arch == QWEN else
               _dense(both, arch=arch, page_size=page_size))
        cb = (TE.DeviceContinuousBatcher(eng, eos_token=-1, max_tokens=5,
                                         sync_every=3)
              if batcher == "device" else
              TE.ContinuousBatcher(eng, eos_token=-1, max_tokens=5))
        for rid in range(4):
            cb.submit(rid, rid + 7, features=DS.X_test[rid])
        out.append(cb.run(max_steps=100))
    assert out[0] == out[1] and len(out[0]) >= 2


def test_dense_device_rejects_multi_token_prompts(both):
    dev = _device(both)
    with pytest.raises(ValueError, match="paged"):
        dev.submit(0, [1, 2, 3])
    with pytest.raises(ValueError, match="paged"):
        TE.DeviceContinuousBatcher(_dense(both), spec_k=2, draft=object())


def test_dense_host_batcher_loops_prompt(both):
    """The dense host batcher takes a prompt sequence and loops it a token
    a step at the global position, then emits max_tokens tokens."""
    host = _host(both, max_tokens=3)
    host.submit(0, [5, 9, 13], features=DS.X_test[0])
    host.submit(1, 7, features=DS.X_test[1])  # a bare int still works
    done = host.run(max_steps=100)
    admitted = [r for r in (0, 1) if r not in host.dropped]
    assert sorted(done) == sorted(admitted)
    assert all(len(done[r]) == 3 for r in admitted)


# --------------------------------------------------------- obs, faults
def _ticker():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


@pytest.mark.parametrize("host", [False, True])
def test_traced_dense_runs_match_jax(both, host):
    """A traced dense run of each batcher, two waves: the port's
    lifecycles, Chrome trace and metrics equal the JAX package's under the
    same clock (the device batcher's replay: first token on the admit
    step), and its streams equal the port's untraced run."""
    jp, _, jg, _ = both
    rng = np.random.default_rng(0)
    waves = [[(rid, int(rng.integers(1, 100))) for rid in range(8)],
             [(100 + rid, int(rng.integers(1, 100))) for rid in range(3)]]
    runs = []
    for mod in (JE, TE):
        clock = _ticker()
        if mod is JE:
            tr = JaxTracer(metrics=JaxMetrics(), clock=clock)
            eng = _jax_dense(both)
        else:
            tr = Tracer(metrics=Metrics(), clock=clock)
            eng = _dense(both)
        kw = dict(eos_token=-1, max_tokens=4, tracer=tr, clock=clock)
        cb = (mod.ContinuousBatcher(eng, **kw) if host else
              mod.DeviceContinuousBatcher(eng, sync_every=3, **kw))
        for wave in waves:
            for rid, p in wave:
                cb.submit(rid, p, features=DS.X_test[rid % 1000])
            cb.run(max_steps=300)
        runs.append((cb, tr))
    (jcb, jtr), (tcb, ttr) = runs
    lif = [dataclasses.asdict(r) for r in ttr.requests.values()]
    assert lif == [dataclasses.asdict(r) for r in jtr.requests.values()]
    assert ttr.validate() == [] == jtr.validate() and len(lif) == 11
    assert ttr.chrome_trace() == jtr.chrome_trace()
    assert tr.metrics.snapshot() == jtr.metrics.snapshot()
    assert tcb.done_at == jcb.done_at and tcb.drop_reasons == jcb.drop_reasons
    plain = _host(both) if host else _device(both)
    for wave in waves:
        for rid, p in wave:
            plain.submit(rid, p, features=DS.X_test[rid % 1000])
        plain.run(max_steps=300)
    assert plain.done == tcb.done and plain.dropped == tcb.dropped


@pytest.mark.parametrize("host", [False, True])
def test_dense_quarantine_and_deadline_match_jax(both, host):
    """Four requests in four slots: a corrupted sample in slot 0 at drain
    1 quarantines exactly its request, and request 3, over its deadline,
    is dropped at a drain boundary, in the JAX package's batcher and the
    port's alike (same drops, reasons and stamps); the other two streams
    equal the port's fault-free run (each slot attends its own cells)."""
    outs = []
    for mod, F in ((JE, JF), (TE, TF)):
        clock = _ticker()
        eng = _jax_dense(both) if mod is JE else _dense(both)
        inj = F.FaultPlan([F.CorruptTokens(slot=0, at_drain=1)]).injector()
        kw = dict(eos_token=-1, max_tokens=8, fault_injector=inj,
                  clock=clock)
        cb = (mod.ContinuousBatcher(eng, **kw) if host else
              mod.DeviceContinuousBatcher(eng, sync_every=2, **kw))
        for rid in range(4):
            cb.submit(rid, rid + 5, deadline_s=DEADLINE if rid == 3 else None)
        cb.run(max_steps=200)
        outs.append((cb, inj))
    (jcb, jinj), (tcb, tinj) = outs
    assert tcb.drop_reasons == jcb.drop_reasons == {0: "quarantined",
                                                    3: "deadline"}
    assert tcb.dropped == jcb.dropped and tcb.dropped_at == jcb.dropped_at
    assert tcb.done_at == jcb.done_at and len(tinj.fired) == len(jinj.fired)
    ref = _host(both, max_tokens=8)
    for rid in range(4):
        ref.submit(rid, rid + 5)
    ref.run(max_steps=200)
    assert sorted(tcb.done) == [1, 2]
    for rid, toks in tcb.done.items():
        assert toks == ref.done[rid]


# ------------------------------------------------- launcher and example
def _run(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_anomaly_gate_serving_torch_on_cpu():
    """The port of ``examples/anomaly_gate_serving.py``: the xgb gate's
    verdicts on 256 cicids flows, then the dense ``generate`` with the
    gate fused."""
    r = _run(str(ROOT / "examples" / "anomaly_gate_serving_torch.py"),
             "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "admitted 180/256; dropped 76 (75 true attacks, 1 false " \
           "positives)" in r.stdout
    assert "served 64 tokens for admitted requests on cpu" in r.stdout


def test_anomaly_gate_serving_torch_defaults_to_cuda():
    r = _run("-c", textwrap.dedent("""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: False
        sys.argv = ["anomaly_gate_serving_torch.py"]
        try:
            runpy.run_path("examples/anomaly_gate_serving_torch.py",
                           run_name="__main__")
        except RuntimeError as exc:
            print("RAISED", exc)
    """))
    assert "RAISED CUDA is not available" in r.stdout, r.stderr
