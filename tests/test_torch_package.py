"""Package rules of the PyTorch port: no jax, no ``repro``, CUDA by default."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.planter import MAPPERS as JAX_MAPPERS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _run(*argv: str, timeout: int = 120):
    """Run the interpreter on ``argv`` in a fresh process from the root."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=timeout)


def test_imports_every_module_without_jax():
    """A fresh interpreter with jax blocked imports the whole package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any `import jax` now raises
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = [m for m, mod in sys.modules.items() if mod is not None
                  and (m == "repro" or m.startswith(("repro.", "jax")))]
        assert not leaked, leaked
        serve_slice = {"repro_torch." + m for m in (
            "arch.config", "arch.model", "arch.convert", "arch.sampling",
            "configs.registry", "configs.qwen2_1_5b", "nn.common", "nn.mlp",
            "nn.attn_backend", "nn.attention", "kernels.paged_attention",
            "kernels.linear", "serve.engine", "serve.pages", "serve.faults",
            "serve.spec", "obs", "obs.metrics", "obs.trace",
            "launch.serve")}
        assert serve_slice <= set(names), serve_slice - set(names)
        slice5 = {"repro_torch." + m for m in (
            "serve.router", "nn.moe", "kernels.moe",
            "configs.qwen2_moe_a2_7b", "configs.moonshot_v1_16b_a3b")}
        assert slice5 <= set(names), slice5 - set(names)
        train_slice = {"repro_torch." + m for m in (
            "data.tokens", "dist.compress", "dist.stragglers",
            "train.optimizer", "train.step", "ckpt.manager",
            "launch.train")}
        assert train_slice <= set(names), train_slice - set(names)
        slice6 = {"repro_torch." + m for m in (
            "nn.recurrent", "tree", "configs.xlstm_125m",
            "configs.recurrentgemma_9b")}
        assert slice6 <= set(names), slice6 - set(names)
        slice9 = {"repro_torch." + m for m in (
            "dist.elastic", "dist.sharding", "dist.pipeline",
            "train.elastic", "launch.mesh")}
        assert slice9 <= set(names), slice9 - set(names)
        assert "repro_torch.launch.dryrun" in names  # slice 10
        print("CLEAN", len(names))
    """)
    r = _run("-c", code)
    assert r.returncode == 0, r.stderr
    assert "CLEAN" in r.stdout


def test_every_jax_module_has_a_port_file():
    """Each module file of the JAX package has its counterpart at the same
    path in the port."""
    jax_pkg = ROOT / "src" / "repro"
    missing = [str(f.relative_to(jax_pkg)) for f in jax_pkg.rglob("*.py")
               if not (PKG / f.relative_to(jax_pkg)).exists()]
    assert not missing, missing


def test_no_jax_or_repro_import_in_source():
    bad = []
    sources = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
               + sorted((ROOT / "examples").glob("*_torch.py")))
    assert ROOT / "examples" / "moe_router_distill_torch.py" in sources
    assert ROOT / "examples" / "train_lm_torch.py" in sources
    assert PKG / "nn" / "recurrent.py" in sources
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset
    from repro_torch.launch import plant as plant_cli

    _no_cuda(monkeypatch)
    ds = load_dataset("unsw", n=300)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plant(PlanterConfig(size="S"), ds.X_train, ds.y_train)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plant_cli.main(["--size", "S", "--n", "300"])
    res = plant(PlanterConfig(size="S", device="cpu"), ds.X_train, ds.y_train)
    for backend in ("auto", "cuda", "cuda_fused", "ref"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            res.mapped.torch_predict(backend)
    labels = res.mapped.torch_predict(device="cpu")(ds.X_test)
    assert (labels.numpy() == res.mapped.predict(ds.X_test)).all()


def test_non_hopper_card_is_refused(monkeypatch):
    from repro_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        resolve_device("cuda")


def test_lb_and_dm_requests_name_the_roadmap_item():
    """LB and DM requests (raised naming ROADMAP queue A item 1 until that
    slice was ported) plant and predict on the CPU, with the strategy
    named or left to the Table-2 default (svm -> LB, bnn -> DM)."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset

    ds = load_dataset("unsw", n=300)
    for model, strategy in (("svm", None), ("kmeans", "lb"), ("rf", "dm"),
                            ("bnn", None)):
        y = None if model == "kmeans" else ds.y_train
        cfg = PlanterConfig(model=model, strategy=strategy, size="S",
                            device="cpu", train_params={"epochs": 1}
                            if model == "bnn" else {})
        res = plant(cfg, ds.X_train, y)
        assert res.mapped.strategy == (strategy or {"svm": "lb",
                                                    "bnn": "dm"}[model])
        labels = res.mapped.torch_predict(device="cpu")(ds.X_test).numpy()
        np.testing.assert_array_equal(labels, res.mapped.predict(ds.X_test))


def test_planter_keys_equal_the_jax_package():
    from repro import ml as jax_ml
    from repro.core import planter as jax_planter
    from repro_torch import ml
    from repro_torch.core import DEFAULT_STRATEGY, MAPPERS, SIZE_PARAMS

    assert set(MAPPERS) == set(jax_planter.MAPPERS) and len(MAPPERS) == 12
    assert set(ml.MODEL_REGISTRY) == set(jax_ml.MODEL_REGISTRY)
    assert DEFAULT_STRATEGY == jax_planter.DEFAULT_STRATEGY
    assert SIZE_PARAMS == jax_planter.SIZE_PARAMS


@pytest.mark.parametrize("model,strategy", sorted(JAX_MAPPERS))
def test_every_mapper_key_plants_on_cpu(model, strategy):
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset

    ds = load_dataset("unsw", n=300)
    y = None if model in ("kmeans", "pca", "ae") else ds.y_train
    cfg = PlanterConfig(model=model, strategy=strategy, size="S", device="cpu",
                        train_params={"epochs": 1} if model == "bnn" else {})
    res = plant(cfg, ds.X_train, y, ds.X_test)
    assert res.mapped.strategy == strategy
    assert res.mapped.select_backend("cpu") == "ref"
    out = res.mapped.torch_predict("auto", device="cpu")(ds.X_test).numpy()
    want = res.mapped.predict(ds.X_test)
    if model in ("pca", "ae"):
        assert out.dtype == np.float32 and out.shape == want.shape
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(out, want)


def test_select_backend_gives_lb_and_dm_their_kernels(monkeypatch):
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset

    ds = load_dataset("unsw", n=300)
    planted = {
        s: plant(PlanterConfig(model=m, strategy=s, size="S", device="cpu",
                               train_params={"epochs": 1} if m == "bnn"
                               else {}), ds.X_train, ds.y_train).mapped
        for m, s in (("nb", "lb"), ("bnn", "dm"), ("dt", "eb"))}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda d: (9, 0))
    for strategy in ("lb", "dm"):
        mapped = planted[strategy]
        assert mapped.gate_sized()  # small, yet not the EB fused kernel
        assert mapped.select_backend("cuda") == "cuda"
        assert mapped.select_backend("cpu") == "ref"
        with pytest.raises(ValueError, match="cuda_fused"):
            mapped.torch_predict("cuda_fused", device="cuda")
        with pytest.raises(ValueError, match="cuda_fused"):
            mapped.torch_predict("cuda_fused", device="cpu")
    assert planted["eb"].select_backend("cuda") == "cuda_fused"


def test_cpu_tensors_take_the_plain_versions_and_inputs_are_checked():
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import require

    ops.reset_launch_counts()
    v = torch.zeros((4, 2), dtype=torch.int32)
    t = torch.full((2, 3), 5, dtype=torch.int32)
    assert ops.bucketize(v, t).sum().item() == 0
    assert ops.launch_counts() == {"bucketize": 0, "ternary_match": 0,
                                   "fused_eb": 0, "lb_lookup": 0,
                                   "bnn_popcount_matmul": 0,
                                   "paged_attention": 0, "linear": 0,
                                   "moe_down_combine": 0}
    codes = torch.zeros((4, 2), dtype=torch.int32)
    luts = torch.ones((2, 3, 5), dtype=torch.int32)
    assert ops.lb_lookup(codes, luts).tolist() == [[2] * 5] * 4
    assert ops.bnn_popcount_matmul(v, t[:, :2]).shape == (4, 2)
    q = torch.ones((2, 1, 4, 8), dtype=torch.bfloat16)
    pages = torch.ones((3, 4, 2, 8), dtype=torch.bfloat16)
    tbl = torch.tensor([[0, 1], [2, 5]], dtype=torch.int32)  # 5: past the pool
    pos = torch.tensor([[3], [6]], dtype=torch.int32)
    out = ops.paged_attention(q, pages, pages, tbl, pos, 0)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert torch.equal(out, torch.ones_like(q))  # softmax-weighted ones
    x, w = torch.ones((3, 8), dtype=torch.bfloat16), torch.ones((8, 16),
                                                                dtype=torch.bfloat16)
    assert torch.equal(ops.linear(x, w), torch.full((3, 16), 8.0,
                                                    dtype=torch.bfloat16))
    assert ops.linear(x, w, out_dtype=torch.float32).dtype == torch.float32
    h = torch.ones((3, 2, 8), dtype=torch.bfloat16)
    c = torch.tensor([[0.5, 0.5], [1.0, 0.0], [0.0, 0.0]],
                     dtype=torch.bfloat16)
    assert ops.moe_down_combine(h, w.reshape(2, 8, 8), c).tolist() == [
        [8.0] * 8, [8.0] * 8, [0.0] * 8]
    assert sum(ops.launch_counts().values()) == 0
    cpu = torch.device("cpu")
    with pytest.raises(TypeError, match="int32"):
        require(v.to(torch.int64), "values", 2, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        require(t.T, "thresholds", 2, cpu)
    with pytest.raises(ValueError, match="dims"):
        require(t[0], "thresholds", 2, cpu)


def test_quickstart_torch_on_cpu_is_bit_exact():
    r = _run(str(ROOT / "examples" / "quickstart_torch.py"), "--device", "cpu",
             timeout=300)
    assert r.returncode == 0, r.stderr
    assert "bit-exact" in r.stdout


def _defaults_to_cuda(example: str) -> None:
    """``examples/<example>.py`` with no arguments raises without CUDA."""
    r = _run("-c", textwrap.dedent(f"""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: False
        sys.argv = ["{example}.py"]
        try:
            runpy.run_path("examples/{example}.py", run_name="__main__")
        except RuntimeError as exc:
            print("RAISED", exc)
    """))
    assert "RAISED CUDA is not available" in r.stdout, r.stderr


def test_quickstart_torch_defaults_to_cuda():
    _defaults_to_cuda("quickstart_torch")


def test_finance_lowlatency_torch_defaults_to_cuda():
    _defaults_to_cuda("finance_lowlatency_torch")


def test_finance_lowlatency_torch_on_cpu_runs():
    """The port of ``examples/finance_lowlatency.py`` (its
    ``tests/test_examples.py`` line): xgb-EB, dt-DM, nb-LB and svm-LB on
    nasdaq, the same table and the mid-price line."""
    r = _run(str(ROOT / "examples" / "finance_lowlatency_torch.py"),
             "--device", "cpu", timeout=300)
    assert r.returncode == 0, r.stderr
    assert "mid-price" in r.stdout
    rows = [ln.split() for ln in r.stdout.splitlines()
            if ln.split()[:1] in (["xgb"], ["dt"], ["nb"], ["svm"])]
    assert [row[:2] for row in rows] == [["xgb", "eb"], ["dt", "dm"],
                                         ["nb", "lb"], ["svm", "lb"]]


def test_plant_leaves_the_callers_config_unchanged():
    """An LB plant's feature_max default does not land in the caller's
    convert_params, so a reused config quantizes each dataset afresh."""
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset

    ds = load_dataset("unsw", n=300)
    cfg = PlanterConfig(model="nb", size="S", device="cpu")
    res = plant(cfg, ds.X_train, ds.y_train)
    assert cfg.convert_params == {}
    np.testing.assert_array_equal(res.config.convert_params["feature_max"],
                                  ds.X_train.max(axis=0))
