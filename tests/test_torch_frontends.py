"""The port's VLM and enc-dec families against the JAX package, on the CPU:
``internvl2-2b`` (a patch prefix through ``frontend_proj``, text-only
decode) and ``seamless-m4t-large-v2`` (an encoder over frames, a decoder
with cross-attention, the ``cross`` decode planes) at their smoke sizes.

The JAX package's random-init masters, and where a test starts mid-run its
decode state, are carried across with ``arch.convert``.  Tolerances, as in
``test_torch_hybrid.py``:

* logits: every position within ``LOGIT_TOL`` (3%) of the JAX logits'
  largest magnitude there, greedy tokens equal wherever the JAX top-2
  margin exceeds twice that bound, and a served stream compared up to the
  first near tie of its slot;
* decode against the port's own forward: the JAX package's 0.15
  (``tests/test_arch_smoke.py:72``);
* a train step: the loss within 1e-3 relative; an updated master within
  ``UPDATE_TOL`` of JAX's where the JAX gradient is clear of ``GRAD_TOL``,
  and within twice the step's lr everywhere;
* the port against itself (host == device batcher, paged == dense, a
  checkpoint's save and restore, the query-only projection): bitwise.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import model as JM  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.ckpt.manager import _flatten as jax_flatten  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.nn import attention as JA  # noqa: E402
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
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.train import optimizer as TOPT  # noqa: E402
from repro_torch.train.step import TrainConfig, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_hybrid import (GRAD_TOL, LOSS_RTOL, UPDATE_TOL,  # noqa: E402
                               _check_logits, _shapes, _tokens, _workload)
from test_torch_serve import DS, _near_tie_bound, _top2_margin  # noqa: E402

VLM, ENCDEC = "internvl2-2b", "seamless-m4t-large-v2"
ARCHS = {"vlm": VLM, "encdec": ENCDEC}
INPUT = {"vlm": "patches", "encdec": "frames"}  # the frontend's batch key
DECODE_TOL = 0.15  # tests/test_arch_smoke.py:72

_MODELS = {}


def _jax_init(cfg, seed):
    """The JAX package's random-init masters, jitted (one compile in place
    of the layer-by-layer eager init)."""
    return jax.jit(JM.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(seed))


def _model(name):
    """(JAX cfg, port cfg, JAX params, port compute params), made once."""
    if name not in _MODELS:
        arch = ARCHS[name]
        jc, tc = jax_smoke(arch), get_smoke_config(arch)
        jp = _jax_init(jc, 1)
        _MODELS[name] = (jc, tc, jp, params_from_arrays(
            jax.tree.map(np.asarray, jp), tc, "cpu"))
    return _MODELS[name]


@functools.lru_cache(maxsize=None)
def _jax_decode(name):
    """The JAX ``decode_step`` of a model, jitted once for the file."""
    return jax.jit(functools.partial(JM.decode_step, cfg=_model(name)[0]))


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


def _frontend(cfg, B, seed):
    """``[B, frontend_seq, frontend_dim]`` float32 patches or frames."""
    return np.random.default_rng(seed).normal(
        0, 1, (B, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)


def _batches(name, B, S, seed, frontend=True):
    """The same batch for both packages: (JAX dict, port dict)."""
    jc = _model(name)[0]
    b = {"tokens": _tokens(jc, (B, S), seed)}
    if frontend:
        b[INPUT[name]] = _frontend(jc, B, seed + 1)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@functools.lru_cache(maxsize=None)
def _jax_cross_fn(name):
    """The JAX package's own ``_encode`` and ``nn.attention.cross_kv``,
    composed into the ``cross`` planes (nothing in it writes them, ROADMAP
    C.13), jitted once for the file."""
    jc = _model(name)[0]

    def cross(jp, frames):
        enc = JM._encode(jp, jc, frames, 512)
        kvs = [JA.cross_kv(jax.tree.map(lambda a: a[i], jp["cross_layers"])
                           ["mixer"], enc, jc.n_kv_heads, jc.head_dim_)
               for i in range(jc.n_layers)]
        return (jnp.stack([k for k, _ in kvs]),
                jnp.stack([v for _, v in kvs]))

    return jax.jit(cross)


def _jax_cross(name, frames):
    return _jax_cross_fn(name)(_model(name)[2], jnp.asarray(frames))


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("name,frontend", [("vlm", True), ("vlm", False),
                                           ("encdec", True)])
def test_forward_matches_jax(name, frontend):
    """``forward`` of 2 x 12 tokens (a VLM with and without its 8 patches
    ahead of them; the enc-dec model over 16 frames): the logits of every
    position; aux 0."""
    jc, tc, jp, tp = _model(name)
    jb, tb = _batches(name, 2, 12, 2, frontend)
    lj, _ = jax.jit(lambda p, b: JM.forward(p, b, jc, q_block=8))(jp, jb)
    with torch.no_grad():
        lt, aux = TM.forward(tp, tb, tc, q_block=8)
    S = 12 + (jc.frontend_seq if frontend and name == "vlm" else 0)
    assert lt.shape == (2, S, tc.vocab_padded) and float(aux) == 0.0
    _check_logits(lt.numpy(), np.asarray(lj))


@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_loss_matches_jax(name):
    """``loss_fn`` within 1e-3 relative (the VLM's logits sliced past its
    patches); a VLM batch without patches raises the JAX ``KeyError``."""
    jc, tc, jp, tp = _model(name)
    jb, tb = _batches(name, 2, 12, 4)
    lj = float(jax.jit(lambda p, b: JM.loss_fn(p, b, jc, q_block=8))(jp, jb))
    with torch.no_grad():
        lt = float(TM.loss_fn(tp, tb, tc, q_block=8))
    assert abs(lt - lj) <= LOSS_RTOL * abs(lj)
    if name == "vlm":
        jb.pop("patches")
        tb.pop("patches")
        with pytest.raises(KeyError, match="patches"):
            jax.eval_shape(lambda p, b: JM.loss_fn(p, b, jc), jp, jb)
        with pytest.raises(KeyError, match="patches"):
            TM.loss_fn(tp, tb, tc)


def test_remat_policy_as_in_jax():
    """The enc-dec forward ignores ``remat_policy`` (the JAX package's
    recomputes every layer whatever it says): ``"dots"``, ``"none"`` and
    ``"full"`` give the loss and every gradient bitwise; the VLM takes
    ``"dots"`` as a dense model does (queue A item 13): its loss, with the
    patch prefix, bitwise ``"full"``'s."""
    _, tc = _model("encdec")[:2]
    _, tb = _batches("encdec", 2, 8, 5)
    masters = master_params_from_arrays(
        jax.tree.map(np.asarray, _model("encdec")[2]), tc, "cpu")
    out = []
    for policy in ("full", "none", "dots"):
        ps = master_params_from_arrays(arrays_from_master_params(masters),
                                       tc, "cpu")
        parts = [p.requires_grad_(True) for leaf in leaves(ps)
                 for p in leaf.parts]
        loss = TM.loss_fn(ps, tb, tc, q_block=8, remat_policy=policy)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in parts]))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(grads, out[0][1]))
    _, tv, _, tpv = _model("vlm")
    _, tbv = _batches("vlm", 2, 8, 5)
    vlm = [TM.loss_fn(tpv, tbv, tv, q_block=8, remat_policy=policy)
           for policy in ("full", "dots")]
    assert torch.equal(vlm[0], vlm[1])


def test_query_only_projection_is_the_group_bits():
    """The cross-attention projects its query alone: ``ops.linear`` of
    ``wq`` gives the bits of the q/k/v group launch's first output."""
    _, tc, _, tp = _model("encdec")
    h = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, (2, 5, tc.d_model)).astype(np.float32)).to(torch.bfloat16)
    mixer = tp["cross_layers"][1]["mixer"]
    group = ops.linear_group(h, [mixer["wq"], mixer["wk"], mixer["wv"]])
    assert torch.equal(ops.linear(h, mixer["wq"]), group[0])


@pytest.mark.parametrize("S,q_block", [(16, 12), (20, 8), (16, 16)])
def test_blocked_attention_rows_are_contiguous(S, q_block):
    """``attend_blocked`` hands ``wo`` a contiguous ``[B, S, H * hd]``
    operand when the last query block is padded (the encoder's 16 frames in
    blocks of 12): the ``linear`` kernel takes rows at one stride and
    refused the strided slice on the card (ROADMAP C.16)."""
    from repro_torch.nn.attention import attend_blocked

    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, S, 2, 8)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    pos = torch.arange(S)[None].expand(2, S)
    out = attend_blocked(q, k, v, pos, pos, 0, causal=False, q_block=q_block)
    whole = attend_blocked(q, k, v, pos, pos, 0, causal=False, q_block=S)
    assert out.shape == (2, S, 16) and out.is_contiguous()
    assert torch.equal(out, whole)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_init_decode_state_matches_jax(name, kv_dtype):
    """Keys, shapes and dtypes of the JAX package's state: the enc-dec
    ``cross`` planes ``[n_layers, B, frontend_seq, KV, hd]``, an int8
    request kept bf16 there (the JAX package's fallback); the VLM's state
    is a dense model's."""
    jc, tc, _, _ = _model(name)
    js = JM.init_decode_state(jc, 3, 32, kv_dtype=kv_dtype)
    ts = TM.init_decode_state(tc, 3, 32, kv_dtype=kv_dtype, device="cpu")
    assert _shapes(ts) == _shapes(js)
    assert ("cross" in ts) == (name == "encdec")


@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_decode_step_matches_jax(name):
    """Five JAX steps of 4 slots with cache 8 (the enc-dec ``cross`` planes filled by
    the JAX package's ``_encode`` + ``cross_kv``), the JAX state carried
    across, then seven steps in both packages from it: past the ring's
    wrap the logits agree, and the port's state keeps the JAX layout."""
    jc, tc, jp, tp = _model(name)
    toks = _tokens(jc, (4, 12), 7)
    js = JM.init_decode_state(jc, 4, 8)
    if name == "encdec":
        js["cross"] = _jax_cross(name, _frontend(jc, 4, 8))
    step = _jax_decode(name)
    for t in range(5):
        _, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
    ts = decode_state_from_arrays(jax.tree.map(np.asarray, js), tc, "cpu")
    assert _shapes(ts) == _shapes(js)
    lj, lt = [], []
    for t in range(5, 12):
        out, js = step(jp, js, jnp.asarray(toks[:, t:t + 1]))
        lj.append(np.asarray(out))
        with torch.no_grad():
            out, ts = TM.decode_step(tp, ts, torch.from_numpy(
                toks[:, t:t + 1]), tc)
        lt.append(out.numpy())
    assert int(ts["pos"]) == 12
    _check_logits(np.stack(lt), np.stack(lj))


def _teacher_forced(name, toks, cross=None):
    """The port's decode logits ``[B, S, Vp]`` of ``toks`` from a fresh
    state (``cross`` planes, if given, written in)."""
    _, tc, _, tp = _model(name)
    B, S = toks.shape
    st = TM.init_decode_state(tc, B, S, device="cpu")
    if cross is not None:
        st["cross"] = cross
    rows = []
    with torch.no_grad():
        for t in range(S):
            lg, st = TM.decode_step(tp, st, toks[:, t:t + 1], tc)
            rows.append(lg)
    return torch.stack(rows, 1)


def test_vlm_decode_equals_forward():
    """Mirror of ``tests/test_arch_smoke.py``'s ``test_decode_matches_
    forward`` for the VLM's text-only decode (ROADMAP C.14): the
    teacher-forced decode logits within 0.15 of the port's forward without
    patches, position by position."""
    _, tc, _, tp = _model("vlm")
    toks = torch.from_numpy(_tokens(tc, (2, 12), 1))
    with torch.no_grad():
        fwd, _ = TM.forward(tp, {"tokens": toks}, tc, q_block=12)
    err = (_teacher_forced("vlm", toks) - fwd).abs().amax((0, 2))
    assert err.max() < DECODE_TOL, err


@pytest.mark.parametrize("filled_by", ["port", "jax"])
def test_cross_filled_decode_equals_forward(filled_by):
    """The enc-dec decode with its ``cross`` planes filled, by the port's
    ``encode_cross`` or by the JAX package's ``_encode`` + ``cross_kv``
    (the two within the logit tolerance of each other): teacher-forced
    logits within 0.15 of the port's forward over the same frames, and
    past it with the zero planes the JAX package's decode keeps (ROADMAP
    C.13: without them the decode never sees the frames)."""
    jc, tc, _, tp = _model("encdec")
    toks = torch.from_numpy(_tokens(tc, (4, 12), 3))
    frames = _frontend(tc, 4, 9)
    with torch.no_grad():
        fwd, _ = TM.forward(tp, {"tokens": toks,
                                 "frames": torch.from_numpy(frames)}, tc,
                            q_block=12)
    port = TM.encode_cross(tp, torch.from_numpy(frames), tc)
    jax_kv = tuple(torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in _jax_cross("encdec", frames))
    for a, b in zip(port, jax_kv):
        assert a.shape == b.shape == (tc.n_layers, 4, tc.frontend_seq,
                                      tc.n_kv_heads, tc.head_dim_)
        assert a.dtype == torch.bfloat16
        assert (a.float() - b.float()).abs().max() <= 0.03 * b.float(
        ).abs().max()
    cross = port if filled_by == "port" else jax_kv
    err = (_teacher_forced("encdec", toks, cross) - fwd).abs().amax((0, 2))
    assert err.max() < DECODE_TOL, err
    zero = (_teacher_forced("encdec", toks) - fwd).abs().amax((0, 2))
    assert zero.max() > DECODE_TOL, zero


def test_encode_cross_refuses_other_families():
    _, tc, _, tp = _model("vlm")
    with pytest.raises(ValueError, match="enc-dec"):
        TM.encode_cross(tp, torch.zeros((1, 8, 32)), tc)


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


@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_generate_matches_jax(name, gates):
    """JAX ``generate`` vs the port's (3-token prompts, 10 generated, cache
    8: the ring wraps; the enc-dec ``cross`` planes zero in both): each
    slot's stream equal up to its first JAX near tie, from the JAX model's
    logits along its stream."""
    jc, _, jp, _ = _model(name)
    prompts = _tokens(jc, (4, 3), 6)
    je, te = _engines(name, gates, cache_len=8)
    want = np.asarray(je.generate(prompts, 10, features=DS.X_test[:4]))
    got = te.generate(prompts, 10, features=DS.X_test[:4])
    assert got.shape == want.shape == (4, 10)
    seqs = np.concatenate([prompts, want], 1).astype(np.int32)
    js = JM.init_decode_state(jc, 4, 8)
    step = _jax_decode(name)
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
    assert compared >= 3, compared


def _compare_streams(log, dj, dt) -> int:
    """Each stream of ``dt`` equal to ``dj``'s up to the first JAX near tie
    of its slot (``log``: the JAX steps' (slot requests, logits))."""
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
    for rid, n in upto.items():
        assert dt[rid][:n] == dj[rid][:n], (rid, n)
    return sum(upto.values())


@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_dense_batchers_match_jax(name, gates):
    """JAX ``ContinuousBatcher`` and ``DeviceContinuousBatcher`` (dense,
    three steps a round) vs the port's: 10 single-token requests with gate
    features through 4 slots, cache 8; the JAX device batcher runs its
    host batcher's schedule (one JAX engine serves both: the device
    batcher keeps its own cache); drops, reasons (and for the host batchers
    the live-slot peak and drains) equal; each stream of either port
    batcher equal to the JAX package's up to the first JAX near tie of its
    slot (the JAX host batcher's logits)."""
    je, te = _engines(name, gates, cache_len=8)
    _, te2 = _engines(name, gates, cache_len=8)
    jhost = JE.ContinuousBatcher(je, eos_token=-1, max_tokens=6)
    log = []
    inner = jhost.engine.step

    def step(tokens, features=None, block=True):
        logits, labels = inner(tokens, features, block)
        log.append((list(jhost.slot_req), np.asarray(logits)))
        return logits, labels

    jhost.engine.step = step
    jdev = JE.DeviceContinuousBatcher(je, eos_token=-1, max_tokens=6,
                                      sync_every=3)
    thost = TE.ContinuousBatcher(te, eos_token=-1, max_tokens=6)
    tdev = TE.DeviceContinuousBatcher(te2, eos_token=-1, max_tokens=6,
                                      sync_every=3)
    dj = _workload(jhost)
    assert _workload(jdev) == dj and len(dj) >= 4
    for tcb, jcb in ((thost, jhost), (tdev, jdev)):
        dt = _workload(tcb)
        assert tcb.dropped == jcb.dropped
        assert tcb.drop_reasons == jcb.drop_reasons
        assert sorted(dt) == sorted(dj)
        assert _compare_streams(log, dj, dt) >= 4
    assert thost.max_live == jhost.max_live
    assert thost._drains == jhost._drains


@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_device_equals_host(name, gates):
    """The dense device batcher (sync_every 3) and the host batcher on 12
    requests of 12 tokens, cache 16 (the ring wraps): streams, drops,
    reasons, steps and the global position bitwise; the enc-dec ``cross``
    planes untouched (zero) in both."""
    _, te = _engines(name, gates)
    _, te2 = _engines(name, gates)
    host = TE.ContinuousBatcher(te, eos_token=-1, max_tokens=12)
    dev = TE.DeviceContinuousBatcher(te2, eos_token=-1, max_tokens=12,
                                     sync_every=3)
    done_h = _workload(host, n_req=12)
    assert _workload(dev, n_req=12) == done_h and len(done_h) >= 4
    assert dev.dropped == host.dropped
    assert dev.drop_reasons == host.drop_reasons
    assert dev.steps == host.steps
    assert int(dev._decode["pos"]) == int(te.state["pos"]) == host.steps > 8
    if name == "encdec":
        for st in (dev._decode, te.state):
            assert all(not t.any() for t in st["cross"])


_JAX_PAGED = jax.jit(JM.paged_decode_step, static_argnums=6)


def _jax_paged_margins(prompts, done):
    """Each stream's JAX top-2 margins and near-tie bounds along it: the
    JAX VLM re-run teacher-forced through its paged step."""
    jc, _, jp, _ = _model("vlm")
    rids = sorted(done)
    L = max(len(prompts[r]) + len(done[r]) for r in rids)
    seqs = np.zeros((len(rids), L), np.int32)
    for b, r in enumerate(rids):
        s = list(prompts[r]) + list(done[r])
        seqs[b, :len(s)] = s
    kv = JM.init_paged_kv(jc, len(rids) * 4, 8)
    tbl = jnp.arange(len(rids) * 4, dtype=jnp.int32).reshape(len(rids), 4)
    ones = jnp.ones(len(rids), jnp.int32)
    rows = []
    for t in range(L):
        lg, kv = _JAX_PAGED(jp, kv, tbl, jnp.full(len(rids), t, jnp.int32),
                            jnp.asarray(seqs[:, t:t + 1]), ones, jc)
        rows.append(np.asarray(lg))
    logits = np.stack(rows, 1)
    out = {}
    for b, r in enumerate(rids):
        P = len(prompts[r])
        lg = logits[b, P - 1: P - 1 + len(done[r])]
        out[r] = (_top2_margin(lg), _near_tie_bound(lg))
    return out


@pytest.mark.parametrize("batcher", ["host", "device"])
def test_vlm_paged_batchers_match_jax(batcher, gates):
    """The VLM through the paged cache (page 8, cache 32, text prompts of
    1-7 tokens), JAX vs the port with either batcher (the device batcher
    in chunks of 4, three steps a round): drops, reasons and the page
    pool's refcounts equal; each stream equal up to its first JAX near
    tie; the port's paged streams bitwise its dense ones on single-token
    prompts."""
    jc, tc, jp, tp = _model("vlm")
    jg, tg = gates
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 97, rng.integers(1, 8))]
               for _ in range(8)]
    kw = dict(max_batch=4, cache_len=32, page_size=8)
    je = JE.ServeEngine(jc, jp, JE.ServeConfig(attn_impl="jnp", **kw),
                        gate=jg)
    te = TE.ServeEngine(tc, tp, TE.ServeConfig(**kw), gate=tg, device="cpu")
    if batcher == "host":
        jcb = JE.ContinuousBatcher(je, eos_token=-1, max_tokens=4)
        tcb = TE.ContinuousBatcher(te, eos_token=-1, max_tokens=4)
    else:
        jcb = JE.DeviceContinuousBatcher(je, eos_token=-1, max_tokens=4,
                                         sync_every=3, prefill_chunk=4)
        tcb = TE.DeviceContinuousBatcher(te, eos_token=-1, max_tokens=4,
                                         sync_every=3, prefill_chunk=4)
    out = []
    for cb in (jcb, tcb):
        for rid, p in enumerate(prompts):
            cb.submit(rid, p, features=DS.X_test[rid])
        out.append(cb.run(max_steps=600))
    dj, dt = out
    assert tcb.dropped == jcb.dropped and tcb.drop_reasons == jcb.drop_reasons
    assert sorted(dt) == sorted(dj) and len(dj) >= 4
    np.testing.assert_array_equal(tcb.pool.ref, jcb.pool.ref)
    compared = 0
    for rid, (margin, bound) in _jax_paged_margins(prompts, dj).items():
        near = np.nonzero(margin <= bound)[0]
        upto = int(near[0]) if len(near) else len(dj[rid])
        assert dt[rid][:upto] == dj[rid][:upto], (rid, upto)
        compared += upto
    assert compared > 0
    streams = []
    for page_size in (0, 8):
        eng = TE.ServeEngine(tc, tp, TE.ServeConfig(
            max_batch=4, cache_len=32, page_size=page_size), gate=tg,
            device="cpu")
        cb = (TE.DeviceContinuousBatcher(eng, eos_token=-1, max_tokens=5,
                                         sync_every=3)
              if batcher == "device" else
              TE.ContinuousBatcher(eng, eos_token=-1, max_tokens=5))
        for rid in range(4):
            cb.submit(rid, rid + 7, features=DS.X_test[rid])
        streams.append(cb.run(max_steps=100))
    assert streams[0] == streams[1] and len(streams[0]) >= 2


def test_paged_cache_refuses_encdec_as_in_jax():
    """``init_paged_kv``, ``paged_decode_step`` and a paged engine raise
    the JAX package's ``ValueError`` for the enc-dec config."""
    from repro_torch.nn.attn_backend import PagedKV

    jc, tc, _, tp = _model("encdec")
    with pytest.raises(ValueError, match="dense attention") as jerr:
        JM.init_paged_kv(jc, 4, 4)
    with pytest.raises(ValueError, match="dense attention") as terr:
        TM.init_paged_kv(tc, 4, 4, device="cpu")
    assert str(terr.value) == str(jerr.value)
    z = torch.zeros((2, 1), dtype=torch.int32)
    pool = torch.zeros((1, 4, 4, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dense attention"):
        TM.paged_decode_step(tp, PagedKV(k=pool, v=pool.clone()), z, z[:, 0],
                             z, z[:, 0], tc)
    eng = TE.ServeEngine(tc, tp, TE.ServeConfig(max_batch=2, page_size=4),
                         device="cpu")
    with pytest.raises(ValueError, match="dense attention"):
        TE.DeviceContinuousBatcher(eng)


@pytest.mark.parametrize("arch,mode", [
    (VLM, []),
    (VLM, ["--continuous", "--page-size", "16", "--prompt-len", "12"]),
    (ENCDEC, []), (ENCDEC, ["--continuous", "--batcher", "host"])])
def test_launch_serve_on_cpu(arch, mode, capsys):
    """``launch.serve --arch <arch> --smoke --device cpu``: one generate()
    batch over the dense state, the VLM's paged device batcher and the
    enc-dec host batcher (the batchers themselves are held against the
    JAX package above); the enc-dec ``--page-size`` fails as the JAX
    launcher's does."""
    from repro_torch.launch import serve

    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--requests", "12", "--tokens", "4", *mode])
    text = capsys.readouterr().out
    if mode:
        assert len(out) >= 4 and all(len(t) == 4 for t in out.values())
        assert "served" in text
    else:
        assert out.shape == (8, 4) and "generated 32 tokens" in text
    if arch == ENCDEC and mode:
        with pytest.raises(ValueError, match="dense attention"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--continuous", "--page-size", "16"])


# ------------------------------------------------------------ training
def _jax_masters(name):
    """(JAX masters, the port's), the norm scales non-zero (so that the
    decay of the stacked ones shows) and the enc-dec cross layers' unused
    MLP among them."""
    jc, tc, _, _ = _model(name)
    np_tree = jax.tree.map(np.array, _jax_init(jc, 0))
    rng = np.random.default_rng(7)
    stacks = [np_tree["layers"]] + [np_tree[k] for k in ("enc_layers",
                                                         "cross_layers")
                                    if k in np_tree]
    for layers in stacks:
        for k in ("ln1", "ln2"):
            layers[k] = rng.normal(0, 0.5, layers[k].shape).astype(np.float32)
    if "enc_ln_f" in np_tree:
        np_tree["enc_ln_f"] = rng.normal(0, 0.5, np_tree["enc_ln_f"].shape
                                         ).astype(np.float32)
    return (jax.tree.map(jnp.asarray, np_tree),
            master_params_from_arrays(np_tree, tc, "cpu"))


@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_train_step_matches_jax(name):
    """One train step (2 microbatches of 2 x 8 tokens with their patches or
    frames, lr 3e-3): the loss within 1e-3 relative, and every updated
    master as the JAX step's (the module docstring's rule); the enc-dec
    cross layers' ``ln2`` and ``mlp`` (``arch.model.unread``), the only
    leaves whose JAX gradient is zero, moved by AdamW's decay alone, as in
    JAX, and the 1-D ``enc_ln_f`` by its gradient alone."""
    jc, tc, _, _ = _model(name)
    jp, tp = _jax_masters(name)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jt = JaxTrainConfig(microbatches=2, q_block=8,
                        adamw=JOPT.AdamWConfig(**kw))
    tt = TrainConfig(microbatches=2, q_block=8, adamw=TOPT.AdamWConfig(**kw))
    jb, tb = _batches(name, 4, 8, 3)
    jst = {"opt": JOPT.init(jp, jt.adamw), "step": jnp.zeros((), jnp.int32)}
    tst = {"opt": TOPT.init(tp, tt.adamw),
           "step": torch.zeros((), dtype=torch.int32)}
    before = jax_flatten(jp)
    jp2, jst2, jl = jax.jit(jax_make_step(jc, jt))(jp, jst, jb)
    # the step's gradient: AdamW's first moment after one step from zero
    # is (1 - b1) times it
    grads = {k: np.asarray(m) / (1 - jt.adamw.b1)
             for k, m in jax_flatten(jst2["opt"].m).items()}
    tp2, tst2, tl = make_train_step(tc, tt)(tp, tst, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert int(tst2["step"]) == 1
    want = jax_flatten(jp2)
    got = jax_flatten(jax.tree.map(jnp.asarray,
                                   arrays_from_master_params(tp2)))
    assert set(got) == set(want) and "frontend_proj" in want
    lr = float(JOPT.schedule(jt.adamw, jnp.int32(1)))
    for k, w in want.items():
        w, a, gk = np.asarray(w), np.asarray(got[k]), np.asarray(grads[k])
        assert a.shape == w.shape, k
        step = np.abs(w - np.asarray(before[k]))
        assert np.abs(a - w).max() <= 2 * lr * 1.01 + 1e-7, k
        clear = np.abs(gk) > GRAD_TOL * np.abs(gk).max()
        err = np.abs(a - w)[clear]
        assert (err <= UPDATE_TOL + 1e-3 * step[clear]).all(), (k, err.max())
    unread = [k for k in want if TM.unread(k)]
    assert bool(unread) == (name == "encdec")
    for k in want:  # JAX's gradient is zero on the unread leaves alone
        assert np.asarray(grads[k]).any() != (k in unread), k
    for k in unread:
        assert not np.array_equal(want[k], before[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2 * np.spacing(np.float32(1)))


def test_train_step_raises_for_a_leaf_without_gradient():
    """A leaf no forward reads, other than the ``arch.model.unread`` ones,
    is a fault: the step raises rather than decay it under a zero
    gradient."""
    _, tc = _model("vlm")[:2]
    tp = _jax_masters("vlm")[1]
    tp["stray"] = torch.ones((4, 8))
    tt = TrainConfig(q_block=8)
    tst = {"opt": TOPT.init(tp, tt.adamw),
           "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="stray: no gradient"):
        make_train_step(tc, tt)(tp, tst, _batches("vlm", 2, 8, 3)[1])


@pytest.mark.parametrize("name", ["vlm", "encdec"])
def test_checkpoint_keys_match_jax_and_restore_bitwise(name, tmp_path):
    """A port train state saved by the port's manager: its keys and shapes
    the JAX package's ``_flatten`` of the same tree (``enc_layers/...``
    and ``cross_layers/...`` stacked, ``frontend_proj``, ``enc_ln_f``);
    the JAX manager restores it into the JAX tree bitwise, and the port's
    restore gives every leaf back."""
    _, tc, _, _ = _model(name)
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
    assert set(manifest) == set(want) and "params/frontend_proj" in want
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


@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_launch_train_refuses_as_the_jax_launcher_dies(arch):
    """The token pipeline makes no ``patches`` or ``frames``: the JAX
    launcher dies on these configs with a ``KeyError``, the port's raises
    a ``ValueError`` naming ROADMAP C.15 before it builds anything."""
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="C.15"):
        train.main(["--arch", arch, "--smoke", "--device", "cpu"])
