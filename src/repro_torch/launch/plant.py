"""One-click Planter CLI on the H100 — the paper's workflow end to end.

    PYTHONPATH=src python -m repro_torch.launch.plant --model rf --size L \
        --backend auto [--device cuda] [--config cfg.json]

Loads the dataset, trains, maps (encode-based, lookup-based or
direct-map: ``--strategy``, default the paper's Table 2 choice), runs the
functionality test (mapped vs native parity), reports resources, and
predicts the test split through the deployed tables on ``--device``
(default ``cuda``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core import PlanterConfig, plant
from ..data import DATASETS, load_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None,
                    help="JSON config file (overridden by CLI flags)")
    ap.add_argument("--model", default="rf")
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--dataset", default="unsw", choices=sorted(DATASETS))
    ap.add_argument("--size", default="M", choices=["S", "M", "L"])
    ap.add_argument("--in-bits", type=int, default=8)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "cuda_fused", "ref"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--save-tables", default=None,
                    help="write table artifacts (npz) here")
    args = ap.parse_args(argv)

    file_cfg = {}
    if args.config:
        with open(args.config) as f:
            file_cfg = json.load(f)
    cfg = PlanterConfig(
        model=file_cfg.get("model", args.model),
        strategy=file_cfg.get("strategy", args.strategy),
        size=file_cfg.get("size", args.size),
        in_bits=file_cfg.get("in_bits", args.in_bits),
        device=args.device,
    )
    ds = load_dataset(file_cfg.get("dataset", args.dataset), n=args.n)
    y = None if cfg.model in ("kmeans", "pca", "ae") else ds.y_train
    res = plant(cfg, ds.X_train, y, ds.X_test)
    r = res.mapped.resources()
    backend = (res.mapped.select_backend(torch.device(args.device))
               if args.backend == "auto" else args.backend)
    print(f"① dataset={ds.name} ({len(ds.X_train)} train / "
          f"{len(ds.X_test)} test, {ds.X_train.shape[1]} features)")
    print(f"② trained {cfg.model} ({res.config.size}) in "
          f"{res.train_seconds:.2f}s")
    print(f"③ mapped via {res.mapped.strategy.upper()} in "
          f"{res.convert_seconds:.2f}s")
    print(f"④⑤ backend={backend} on {args.device}")
    print(f"⑥ tables: {r.entries} entries × ≤{r.entry_bits} bits over "
          f"{r.stages} logical stages ({r.table_bits / 8 / 1024:.1f} KiB)")
    print(f"⑦ functionality test: mapped-vs-native parity = {res.parity:.4f}")
    fn = res.mapped.torch_predict(backend, device=args.device)
    labels = fn(ds.X_test).cpu().numpy()
    want = res.mapped.predict(ds.X_test)
    if labels.dtype.kind == "f":  # LB raw outputs (pca, ae): float32
        if not np.allclose(labels, want, rtol=1e-5, atol=1e-5):
            raise SystemExit("deployed outputs differ from the numpy reference")
    elif not np.array_equal(labels, want):
        raise SystemExit("deployed labels differ from the numpy reference")
    if y is not None:
        print(f"   deployed accuracy: {float((labels == ds.y_test).mean()):.4f}")
    if args.save_tables:
        np.savez(args.save_tables,
                 summary=json.dumps(res.mapped.pipeline.summary()),
                 model=cfg.model, strategy=res.mapped.strategy)
        print(f"   pipeline summary saved to {args.save_tables}")
    return res


if __name__ == "__main__":
    main()
