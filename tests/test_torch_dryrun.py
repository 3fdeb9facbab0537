"""The port's dry-run planner (``repro_torch.launch.dryrun``) on the CPU.

* Per-chip argument bytes against the JAX package's shardings: for the JAX
  dry-run tests' three cells, one MoE and one enc-dec cell, each argument's
  bytes a chip equal, exactly, the sum of JAX ``NamedSharding.shard_shape``
  bytes over the same leaves (``jax.eval_shape`` + ``SH.param_shardings``,
  ``cache_shardings`` and ``batch_pspec`` on 512 fake devices, in one
  subprocess, nothing compiled).
* The meta-tensor FLOP count at the smoke configs equals the count over
  real CPU tensors, for a train, a prefill and a decode step, and a train
  step's count does not depend on its microbatches.
* The CLI: ``OK`` lines and exit 0, ``SKIP`` of ``long_500k`` on a
  full-attention config.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.arch import model as M  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [("xlstm-125m", "decode_32k", False), ("qwen2-1.5b", "train_4k", False),
         ("recurrentgemma-9b", "long_500k", True),
         ("qwen2-moe-a2.7b", "decode_32k", False),
         ("seamless-m4t-large-v2", "train_4k", False)]

# the JAX package's per-chip bytes of each argument, by the port's names
_JAX_BYTES = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun as JD  # pins 512 fake devices first
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.arch import model as M
    from repro.arch.config import SHAPES
    from repro.configs import get_config
    from repro.dist import sharding as SH
    from repro.launch.mesh import make_production_mesh
    from repro.train import optimizer as OPT

    def nbytes(tree, shardings):
        xs = jax.tree.leaves(tree)
        ss = jax.tree.leaves(shardings,
                             is_leaf=lambda s: isinstance(s, NamedSharding))
        assert len(xs) == len(ss)
        return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                   for x, s in zip(xs, ss))

    out = {}
    for arch, shape_name, multi_pod in json.loads(sys.argv[1]):
        cfg, shape = get_config(arch), SHAPES[shape_name]
        mesh = make_production_mesh(multi_pod=multi_pod)
        params = jax.eval_shape(
            lambda: M.init_params(cfg, jax.random.PRNGKey(0)))
        psh = SH.param_shardings(params, mesh)
        rep = NamedSharding(mesh, P())
        got = {"params": nbytes(params, psh)}
        batch = JD.input_specs(cfg, shape)
        bsh = jax.tree.map(lambda l: NamedSharding(
            mesh, SH.batch_pspec(mesh, l.shape[0], len(l.shape))), batch)
        if shape.kind == "train":
            opt = jax.eval_shape(lambda p: OPT.init(p), params)
            got["opt.m"] = nbytes(opt.m, psh)
            got["opt.v"] = nbytes(opt.v, psh)
            got["opt.count"] = nbytes(opt.count, rep)
            got["step"] = 4
            got["batch"] = nbytes(batch, bsh)
        else:
            B = shape.global_batch
            state = jax.eval_shape(
                lambda: M.init_decode_state(cfg, B, shape.seq_len))
            got["state"] = nbytes(state, SH.cache_shardings(state, mesh, B))
            got["tokens"] = nbytes(batch, bsh)
        out[f"{arch} {shape_name} {multi_pod}"] = got
    print("BYTES", json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_bytes():
    pytest.importorskip("jax")
    cells = [list(c) for c in CELLS]
    r = subprocess.run(
        [sys.executable, "-c", _JAX_BYTES, json.dumps(cells)],
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    line = [x for x in r.stdout.splitlines() if x.startswith("BYTES ")][-1]
    return json.loads(line[len("BYTES "):])


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_argument_bytes_equal_jax_shardings(jax_bytes, arch, shape,
                                            multi_pod):
    cell, _ = D.lower_cell(arch, shape, multi_pod=multi_pod, device="cpu")
    got = D.argument_bytes(cell)
    assert got == jax_bytes[f"{arch} {shape} {multi_pod}"]
    assert cell.mesh.size == (512 if multi_pod else 256)


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _train_flops(cfg, dev, microbatches):
    tcfg = TS.TrainConfig(microbatches=microbatches, q_block=16)
    params, state = TS.init_train_state(cfg, tcfg, 0, dev)
    step = TS.make_train_step(cfg, tcfg)
    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32, device=dev)}
    return _count(lambda: step(params, state, batch))


def _serve_flops(cfg, dev):
    params = M.init_params(cfg, 0, dev)
    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32, device=dev)}
    state = M.init_decode_state(cfg, 4, 32, device=dev)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        return (_count(lambda: M.forward(params, batch, cfg, q_block=16)),
                _count(lambda: M.decode_step(params, state, tok, cfg)))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
def test_meta_flops_equal_cpu_flops(arch):
    """The count over meta tensors is the count over real CPU tensors (the
    plain versions), the products included (their operators' formulas);
    and a train step counts the same FLOPs in 1 or 2 microbatches."""
    cfg = get_smoke_config(arch)
    meta = _train_flops(cfg, "meta", 2)
    assert meta == _train_flops(cfg, "cpu", 2)
    assert meta == _train_flops(cfg, "meta", 1)
    assert _serve_flops(cfg, "meta") == _serve_flops(cfg, "cpu")
    # the products are counted: at least 6 x the matrices' params a token
    n = sum(p.numel() for k, v in M.init_params(cfg, 0, "meta").items()
            if k == "layers" for lp in v for p in _tensors(lp)
            if p.dim() == 2)
    assert meta >= 6 * n * 4 * 32


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def test_cli_prints_ok_and_skip(capsys):
    """``OK`` with the bytes and FLOPs and no fit verdict on the CPU; the
    ``SKIP`` of ``long_500k`` on a full-attention config; exit 0."""
    for argv, tag in ((["--arch", "xlstm-125m", "--shape", "decode_32k"],
                       "OK "),
                      (["--arch", "qwen2-1.5b", "--shape", "long_500k"],
                       "SKIP ")):
        with pytest.raises(SystemExit) as e:
            D.main(argv + ["--device", "cpu"])
        assert e.value.code == 0
        out = capsys.readouterr().out
        line = [x for x in out.splitlines() if x.startswith(tag)]
        assert len(line) == 1, out
        if tag == "OK ":
            assert "args/chip=" in line[0] and "flops=" in line[0]
            assert "fit=n/a" in line[0]
        else:
            assert "sub-quadratic" in line[0] or "full-attention" in line[0]
        assert "0 failures" in out


def test_planner_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.main(["--arch", "xlstm-125m", "--shape", "decode_32k"])
