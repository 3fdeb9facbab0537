"""Speculative decoding in the port (``serve/spec.py`` and the device
batcher's ``spec_k``) against the JAX package, on the CPU.

Mirrors ``tests/test_serve.py``'s speculative-decoding tests on the smoke
config, with the JAX package's weights carried across
(``arch.convert.params_from_arrays``).  Bitwise throughout: the draft
table, the sampler's ``categorical`` and, on this workload, the served
streams and the acceptance counters of the two packages; the port's
speculative greedy streams against its own plain greedy ones.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.arch import sampling as JS  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.ml.ngram import NGramModel as JaxNGram  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import spec as JSPEC  # noqa: E402
from repro_torch.arch import sampling as TS  # noqa: E402
from repro_torch.ml.ngram import NGramModel  # noqa: E402
from repro_torch.obs import Metrics, Tracer  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import spec as TSPEC  # noqa: E402
from test_torch_serve import (DS, _engine, _prompts, _serve,  # noqa: E402
                              both)

MAX_TOKENS = 6
SAMPLED = dict(temperature=2.0, top_k=40)


def _device(both, engine_kw=None, **kw):
    return TE.DeviceContinuousBatcher(
        _engine(both, **(engine_kw or {})), eos_token=kw.pop("eos", -1),
        max_tokens=MAX_TOKENS, sync_every=3, prefill_chunk=4, **kw)


@pytest.fixture(scope="module")
def drafted(both):
    """The JAX package's plain greedy run of 8 requests, and the bigram
    draft both packages compile from its prompt + stream chains."""
    jp, _, jg, _ = both
    prompts = _prompts()
    je = JE.ServeEngine(jax_smoke("qwen2-1.5b"), jp, JE.ServeConfig(
        max_batch=4, cache_len=32, page_size=8, attn_impl="jnp"), gate=jg)
    base = JE.DeviceContinuousBatcher(je, eos_token=-1, max_tokens=MAX_TOKENS,
                                      sync_every=3, prefill_chunk=4)
    done = dict(_serve(base, prompts))
    chains = [list(prompts[r]) + list(t) for r, t in done.items()]
    V = jax_smoke("qwen2-1.5b").vocab_size
    return (prompts, done, chains, JSPEC.train_draft(chains, V),
            TSPEC.train_draft(chains, V), je)


def test_draft_table_equals_jax(drafted):
    """The same fitted bigram model compiles to the same table, predicts
    the same successors and accounts for the same resources; the device
    table is its first column."""
    _, _, chains, jdraft, tdraft, _ = drafted
    np.testing.assert_array_equal(tdraft.table.table, jdraft.table.table)
    assert tdraft.vocab_size == jdraft.vocab_size
    assert tdraft.meta == jdraft.meta
    assert vars(tdraft.accounting()) == vars(jdraft.accounting())
    toks = np.arange(-3, tdraft.vocab_size + 3)
    np.testing.assert_array_equal(tdraft.predict(toks), jdraft.predict(toks))
    dev = tdraft.device_table("cpu")
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy(),
                                  np.asarray(jdraft.device_table()))
    fn = tdraft.mapped.torch_predict("ref", "cpu")
    np.testing.assert_array_equal(
        fn(torch.as_tensor(toks)).numpy(),
        np.asarray(jdraft.mapped.make_jax_fn()(jnp.asarray(toks))))
    # a model fitted by each package compiles to the same table, and
    # higher orders or an unfitted model refuse to compile in both
    V = jdraft.vocab_size
    tm, jm = NGramModel(1).fit(chains, V), JaxNGram(1).fit(chains, V)
    np.testing.assert_array_equal(TSPEC.compile_draft(tm).table.table,
                                  JSPEC.compile_draft(jm).table.table)
    for bad in (NGramModel(2).fit(chains, V), NGramModel(1)):
        with pytest.raises(ValueError):
            TSPEC.compile_draft(bad)


@pytest.mark.parametrize("V,order,buckets", [(256, 1, 0), (97, 1, 0),
                                              (256, 2, 0), (300, 3, 64),
                                              (50, 1, 16)])
def test_ngram_fit_equals_jax(V, order, buckets):
    """The port fits from the observed (context, next) pairs, not a dense
    [entries, V] count matrix (184 GB at qwen2-1.5b's vocabulary): the
    same table and fallback as the JAX package's dense fit, ties to the
    lowest token id."""
    rng = np.random.default_rng(V + order)
    seqs = [rng.integers(0, V, rng.integers(1, 40)).tolist()
            for _ in range(60)] + [[1, 2, 1, 2, 1, 3, 1, 3]]
    got = NGramModel(order, buckets).fit(seqs, V)
    want = JaxNGram(order, buckets).fit(seqs, V)
    np.testing.assert_array_equal(got.table_, want.table_)
    assert got.fallback_ == want.fallback_
    assert got.hit_rate(seqs) == want.hit_rate(seqs)


@pytest.mark.parametrize("salt", [0, 2])
def test_categorical_equals_jax(salt):
    """The resample's Gumbel-max draw: the same token for the same
    (seed, position, salt), with zeros excluded."""
    rng = np.random.default_rng(salt)
    p = rng.random((6, 40)).astype(np.float32)
    p[:, ::3] = 0.0  # masked lanes are never drawn
    seed = np.array([0, 1, 7, 0x7FFFFFFF, 12345, 3], np.int32)
    pos = np.array([0, 5, 9, 2, 31, 1000], np.int32)
    got = TS.categorical(torch.as_tensor(p), torch.as_tensor(seed),
                         torch.as_tensor(pos), salt=salt)
    want = np.asarray(JS.categorical(jnp.asarray(p), jnp.asarray(seed),
                                     jnp.asarray(pos), salt=salt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (p[np.arange(6), got.numpy()] > 0).all()


def test_spec_matches_jax(both, drafted):
    """JAX ``DeviceContinuousBatcher(spec_k=3)`` vs the port's, with the
    same draft: streams, drops and ``spec_stats()`` equal."""
    prompts, _, _, jdraft, tdraft, je = drafted
    jcb = JE.DeviceContinuousBatcher(je, eos_token=-1, max_tokens=MAX_TOKENS,
                                     sync_every=3, prefill_chunk=4, spec_k=3,
                                     draft=jdraft)
    tcb = _device(both, spec_k=3, draft=tdraft)
    dj, dt = dict(_serve(jcb, prompts)), dict(_serve(tcb, prompts))
    assert dt == dj and len(dj) >= 4
    assert tcb.drop_reasons == jcb.drop_reasons
    assert tcb.spec_stats() == jcb.spec_stats()
    assert tcb.spec_stats()["accepted"] > 0
    np.testing.assert_array_equal(tcb.pool.ref, jcb.pool.ref)


def test_spec_greedy_equals_plain_greedy(both, drafted):
    """Speculative greedy decode is invisible in the streams: equal to the
    port's plain greedy run, while drafts were accepted."""
    prompts, _, _, _, tdraft, _ = drafted
    plain = dict(_serve(_device(both), prompts))
    spec = _device(both, spec_k=3, draft=tdraft)
    assert dict(_serve(spec, prompts)) == plain
    st = spec.spec_stats()
    assert st["spec_k"] == 3 and st["drafted"] > 0 and st["accepted"] > 0
    assert 0.0 < st["acceptance_rate"] <= 1.0


def test_spec_eos_parity(both, drafted):
    """An EOS inside an accepted draft chain ends the stream where plain
    decode ends it."""
    prompts, done, _, _, tdraft, _ = drafted
    eos = next(int(t[1]) for t in done.values() if len(t) > 1)
    got = dict(_serve(_device(both, eos=eos, spec_k=3, draft=tdraft),
                      prompts))
    want = dict(_serve(_device(both, eos=eos), prompts))
    assert got == want
    assert any(len(t) < MAX_TOKENS for t in want.values())


def test_spec_sampled_smoke(both, drafted):
    """Speculative + sampled (rejection sampling): the same admissions as
    plain sampling, valid streams, drafts counted, and the same streams
    again for the same seeds."""
    prompts, _, _, _, tdraft, _ = drafted
    ref = dict(_serve(_device(both, engine_kw=SAMPLED), prompts))
    spec = _device(both, engine_kw=SAMPLED, spec_k=3, draft=tdraft)
    done = dict(_serve(spec, prompts))
    assert sorted(done) == sorted(ref)
    for toks in done.values():
        assert 1 <= len(toks) <= MAX_TOKENS
        assert all(0 <= t < 256 for t in toks)
    assert spec.spec_stats()["drafted"] > 0
    again = _device(both, engine_kw=SAMPLED, spec_k=3, draft=tdraft)
    assert dict(_serve(again, prompts)) == done


def test_spec_ctor_validation(both, drafted):
    """``spec_k`` needs a compiled draft covering the LM vocab, and a
    positive ``spec_k``: each misuse raises at construction."""
    tdraft = drafted[4]
    with pytest.raises(ValueError, match="draft"):
        _device(both, spec_k=2, draft=None)
    small = TSPEC.train_draft([[1, 2, 3, 1, 2]], vocab_size=8)
    with pytest.raises(ValueError, match="covers 8"):
        _device(both, spec_k=2, draft=small)
    with pytest.raises(ValueError, match="spec_k"):
        _device(both, spec_k=-1, draft=tdraft)
    cb = _device(both, draft=tdraft)  # a draft without spec_k: plain
    assert cb.spec_k == 0 and cb.spec_stats()["drafted"] == 0


def test_spec_traced_run_rejected(both, drafted):
    """The schedule replay assumes one token a decode step: a traced
    speculative run raises at ``run()``."""
    mx = Metrics()
    cb = _device(both, spec_k=2, draft=drafted[4],
                 tracer=Tracer(metrics=mx), metrics=mx)
    cb.submit(0, [3, 5], features=DS.X_test[0])
    with pytest.raises(ValueError, match="spec"):
        cb.run(max_steps=10)


def test_launcher_serves_speculatively_on_cpu(capsys):
    from repro_torch.launch import serve

    done = serve.main(["--smoke", "--device", "cpu", "--continuous",
                       "--page-size", "16", "--requests", "6", "--tokens",
                       "4", "--prompt-len", "6", "--spec-k", "3", "--draft",
                       "pilot", "--sync-every", "4", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "spec draft: bigram table" in out and "speculative: k=3" in out
    assert len(done) > 0 and all(len(t) == 4 for t in done.values())
