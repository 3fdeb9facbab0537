"""The port's ``obs`` (tracer, metrics) and its wiring into both batchers,
against the JAX package on the CPU.

The unit half runs the JAX package's ``tests/test_obs.py`` unit tests on
the port's copies.  The integration half serves the same paged workload
through the JAX package's batchers and the port's, traced, with one
injected clock (a counter that ticks at every read) given to each
package's tracer and batcher: the lifecycles (every event time and device
step), their order, the Chrome trace and the metric counters and
histograms are equal, bitwise.  The port's traced streams equal its
untraced ones.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.obs import Metrics as JaxMetrics  # noqa: E402
from repro.obs import Tracer as JaxTracer  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.obs import Histogram, Metrics, Tracer  # noqa: E402
from repro_torch.obs.trace import step_time_interp  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from test_torch_serve import (DS, _engine, _prefix_prompts,  # noqa: E402
                              _prompts, _serve, both)

MAX_TOKENS = 4


# ---------------------------------------------------------------- unit: metrics
def test_histogram_bucket_edges():
    h = Histogram(lo=1e-3, hi=1e5, per_decade=4)
    assert h.edges[0] == pytest.approx(1e-3)
    assert h.edges[-1] == pytest.approx(1e5)
    assert len(h.counts) == len(h.edges) + 1
    for i, e in enumerate(h.edges[:-1]):
        assert h._bucket(e) == i + 1, e
    assert h._bucket(5e-4) == 0
    assert h._bucket(2e5) == len(h.counts) - 1
    rng = np.random.default_rng(0)
    for v in 10.0 ** rng.uniform(-4, 6, 200):
        b = h._bucket(float(v))
        if v < h.edges[0]:
            assert b == 0
        elif v >= h.edges[-1]:
            assert b == len(h.counts) - 1
        else:
            assert h.edges[b - 1] <= v < h.edges[b]


def test_histogram_merge_by_adding_counts():
    a, b = Histogram(), Histogram()
    rng = np.random.default_rng(1)
    va, vb = rng.exponential(5, 50), rng.exponential(50, 50)
    for v in va:
        a.observe(v)
    for v in vb:
        b.observe(v)
    merged = Histogram()
    for v in np.concatenate([va, vb]):
        merged.observe(v)
    assert a.edges == b.edges == merged.edges
    assert [x + y for x, y in zip(a.counts, b.counts)] == merged.counts


def test_histogram_percentiles():
    h = Histogram(lo=1.0, hi=1e3, per_decade=10)
    assert h.percentile(50) is None
    for v in range(1, 101):
        h.observe(float(v))
    assert h.percentile(50) == pytest.approx(50, rel=0.2)
    assert h.percentile(99) == pytest.approx(99, rel=0.2)


def test_metrics_reset_keeps_handles_live():
    m = Metrics()
    c, g, h = m.counter("c"), m.gauge("g"), m.histogram("h")
    c.inc(3)
    g.set(7)
    h.observe(1.0)
    m.reset()
    assert c.value == 0 and g.value is None and h.count == 0
    c.inc()
    h.observe(2.0)
    snap = m.snapshot()
    assert snap["counters"]["c"] == 1
    assert snap["histograms"]["h"]["count"] == 1


# ----------------------------------------------------------------- unit: tracer
def test_tracer_lifecycle_rules():
    tr = Tracer()
    tr.submitted("r", t=10.0)
    tr.submitted("r", t=12.0)
    assert tr.requests["r"].t_submit == 10.0
    tr.admitted("r", t=11.0)
    tr.first_token("r", t=11.5)
    tr.finished("r", n_tokens=4, t=12.5)
    with pytest.raises(ValueError):
        tr.dropped("r", "gate-reject", t=13.0)
    assert tr.validate() == []
    tr.admitted("s", t=1.0)
    assert any("never terminal" in p for p in tr.validate())


def test_tracer_deferred_emission_flush():
    tr = Tracer()
    order = []
    tr.defer(lambda: (order.append(1), tr.admitted("a", t=1.0)))
    tr.defer(lambda: (order.append(2), tr.finished("a", t=2.0)))
    assert order == []
    assert tr.requests["a"].terminal == "done"
    assert order == [1, 2]
    tr.defer(lambda: order.append(3))
    tr.reset()
    assert tr.requests == {} and order == [1, 2]


def test_step_time_interp_clamps_and_interpolates():
    f = step_time_interp([(0, 10.0), (4, 14.0), (8, 16.0)])
    assert f(-1) == 10.0 and f(12) == 16.0
    assert f(2) == pytest.approx(12.0)
    assert f(6) == pytest.approx(15.0)
    ts = [f(s) for s in range(-1, 13)]
    assert ts == sorted(ts)


def test_chrome_trace_schema():
    tr = Tracer()
    tr.submitted("q", t=tr.epoch)
    tr.admitted("q", t=tr.epoch + 0.1, step=1, shard=2)
    tr.first_token("q", t=tr.epoch + 0.2, step=3)
    tr.finished("q", n_tokens=5, t=tr.epoch + 0.3, step=7)
    tr.drained("q", t=tr.epoch + 0.4)
    tr.dropped("d", "gate-reject", t=tr.epoch + 0.2)
    tr.span("bench", tr.epoch, tr.epoch + 1.0, tid=1, wave=0)
    tr.instant("rebalance", t=tr.epoch + 0.5)
    ct = json.loads(json.dumps(tr.chrome_trace()))
    assert set(ct) == {"traceEvents", "displayTimeUnit"}
    for e in ct["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        assert e["ph"] in {"X", "i", "M"}
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
    names = {e["name"] for e in ct["traceEvents"]}
    assert {"queued", "prefill", "decode", "drained",
            "drop:gate-reject", "thread_name"} <= names
    ev = [e for e in ct["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in ev] == sorted(e["ts"] for e in ev)


# ------------------------------------------------------------------ integration
def _ticker():
    """A clock that advances one second at every read."""
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


def _lifecycles(tr) -> list:
    """Every request's record in the tracer's order, as plain dicts."""
    return [dataclasses.asdict(r) for r in tr.requests.values()]


def _traced_pair(both, host: bool, share: bool, waves):
    """The same traced paged workload through the JAX package's batcher
    and the port's (device: chunk 4, three steps a round), each with its
    own ticking clock; ``waves`` are lists of (rid, prompt)."""
    jp, _, jg, _ = both
    out = []
    for pkg in ("jax", "torch"):
        clock = _ticker()
        if pkg == "jax":
            mx = JaxMetrics()
            tr = JaxTracer(metrics=mx, clock=clock)
            eng = JE.ServeEngine(jax_smoke("qwen2-1.5b"), jp, JE.ServeConfig(
                max_batch=4, cache_len=32, page_size=8, attn_impl="jnp",
                share_prefix=share), gate=jg)
            mod = JE
        else:
            mx = Metrics()
            tr = Tracer(metrics=mx, clock=clock)
            eng = _engine(both, share_prefix=share)
            mod = TE
        kw = dict(eos_token=-1, max_tokens=MAX_TOKENS, tracer=tr, metrics=mx,
                  clock=clock)
        cb = (mod.ContinuousBatcher(eng, **kw) if host else
              mod.DeviceContinuousBatcher(eng, sync_every=3, prefill_chunk=4,
                                          **kw))
        for wave in waves:
            for rid, p in wave:
                cb.submit(rid, p, features=DS.X_test[rid % 1000])
            cb.run(max_steps=600)
        out.append((cb, tr, mx))
    return out


@pytest.mark.parametrize("host,share", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_traced_runs_match_jax(both, host, share):
    """Both batchers, with and without prefix sharing, two waves (the
    second hits the prefix trie the first registered): the port's
    lifecycles, event order, Chrome trace and metrics equal the JAX
    package's under the same clock; done_at and dropped_at too."""
    prompts = _prefix_prompts(n=10) if share else _prompts(n=10)
    waves = [list(enumerate(prompts[:8])),
             [(100 + i, p) for i, p in enumerate(prompts[8:])]]
    (jcb, jtr, jmx), (tcb, ttr, tmx) = _traced_pair(both, host, share, waves)
    assert _lifecycles(ttr) == _lifecycles(jtr)
    assert len(_lifecycles(ttr)) == 10
    assert ttr.chrome_trace() == jtr.chrome_trace()
    assert tmx.snapshot() == jmx.snapshot()
    assert ttr.phase_percentiles() == jtr.phase_percentiles()
    assert ttr.validate() == [] == jtr.validate()
    assert tcb.done_at == jcb.done_at and tcb.dropped_at == jcb.dropped_at
    assert tcb.drop_reasons == jcb.drop_reasons
    snap = tmx.snapshot()
    assert snap["counters"]["serve.requests_done"] == len(tcb.done)
    if share:
        assert snap["counters"].get("pool.prefix_hits", 0) > 0


@pytest.mark.parametrize("host", [False, True])
def test_traced_streams_equal_untraced(both, host):
    """Tracing changes no stream, drop or step; every request reaches one
    terminal event, and a served request's drain stamp is its done_at."""
    prompts = _prompts(n=10)

    def build(**kw):
        if host:
            return TE.ContinuousBatcher(_engine(both), eos_token=-1,
                                        max_tokens=MAX_TOKENS, **kw)
        return TE.DeviceContinuousBatcher(_engine(both), eos_token=-1,
                                          max_tokens=MAX_TOKENS, sync_every=3,
                                          prefill_chunk=4, **kw)

    ref = build()
    want = dict(_serve(ref, prompts))
    tr = Tracer(metrics=Metrics())
    cb = build(tracer=tr, metrics=tr.metrics)
    assert dict(_serve(cb, prompts)) == want
    assert cb.dropped == ref.dropped and cb.steps == ref.steps
    assert tr.validate() == []
    term = [r for r in tr.requests.values() if r.terminal is not None]
    assert len(term) == 10
    for r in term:
        if r.terminal == "done":
            assert cb.done_at[r.rid] == r.t_drain
            assert r.n_tokens == len(want[r.rid])


def test_resume_keeps_lifecycle_and_absolute_steps(both):
    """Bounded traced runs resume the same schedule; their step numbers are
    absolute across ``run()`` calls."""
    prompts = _prompts(n=10)
    ref = dict(_serve(TE.DeviceContinuousBatcher(
        _engine(both), eos_token=-1, max_tokens=MAX_TOKENS, sync_every=3,
        prefill_chunk=4), prompts))
    tr = Tracer()
    cb = TE.DeviceContinuousBatcher(_engine(both), eos_token=-1,
                                    max_tokens=MAX_TOKENS, sync_every=3,
                                    prefill_chunk=4, tracer=tr)
    for rid, p in enumerate(prompts):
        cb.submit(rid, p, features=DS.X_test[rid])
    cb.run(max_steps=2)
    cb.run(max_steps=600)
    assert cb.done == ref
    assert tr.validate() == []
    steps = [r.step_done for r in tr.requests.values()
             if r.step_done is not None]
    assert steps and max(steps) >= 3


def test_attach_obs_detaches_and_keeps_the_step(both):
    """``attach_obs()`` with no arguments detaches; the step shape key and
    the eager path (no CUDA graph on the CPU) do not depend on it."""
    cb = TE.DeviceContinuousBatcher(_engine(both), eos_token=-1,
                                    max_tokens=MAX_TOKENS,
                                    tracer=Tracer(), metrics=Metrics())
    cb.attach_obs()
    assert cb.tracer is None and cb.metrics is None
    assert cb.graph is False  # the CUDA graph is the card's only


def test_launcher_traces_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve

    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    for batcher in ("device", "host"):
        done = serve.main(["--smoke", "--device", "cpu", "--continuous",
                           "--batcher", batcher, "--page-size", "16",
                           "--requests", "6", "--tokens", "3",
                           "--prompt-len", "5", "--trace", str(trace),
                           "--metrics-out", str(metrics)])
        out = capsys.readouterr().out
        assert "ttft_ms: p50=" in out and "LIFECYCLE VIOLATIONS" not in out
        assert len(done) > 0
        ct = json.loads(trace.read_text())
        assert any(e["name"] == "decode" for e in ct["traceEvents"])
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert len(lines) == 2 and lines[0]["kind"] == "serve"
    assert lines[1]["counters"]["serve.requests_done"] > 0
