"""Package rules of the PyTorch port: no jax, no ``repro``, CUDA by default."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

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
        print("CLEAN", len(names))
    """)
    r = _run("-c", code)
    assert r.returncode == 0, r.stderr
    assert "CLEAN" in r.stdout


def test_no_jax_or_repro_import_in_source():
    bad = []
    for path in sorted(PKG.rglob("*.py")):
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
    from repro_torch.core import PlanterConfig, plant
    from repro_torch.data import load_dataset

    ds = load_dataset("unsw", n=300)
    for model, strategy in (("svm", None), ("kmeans", "lb"), ("rf", "dm"),
                            ("bnn", None)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
            plant(PlanterConfig(model=model, strategy=strategy, size="S",
                                device="cpu"), ds.X_train, ds.y_train)


def test_cpu_tensors_take_the_plain_versions_and_inputs_are_checked():
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import require

    ops.reset_launch_counts()
    v = torch.zeros((4, 2), dtype=torch.int32)
    t = torch.full((2, 3), 5, dtype=torch.int32)
    assert ops.bucketize(v, t).sum().item() == 0
    assert ops.launch_counts() == {"bucketize": 0, "ternary_match": 0,
                                   "fused_eb": 0}
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


def test_quickstart_torch_defaults_to_cuda():
    r = _run("-c", textwrap.dedent("""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: False
        sys.argv = ["quickstart_torch.py"]
        try:
            runpy.run_path("examples/quickstart_torch.py", run_name="__main__")
        except RuntimeError as exc:
            print("RAISED", exc)
    """))
    assert "RAISED CUDA is not available" in r.stdout, r.stderr
