"""Quickstart on the H100 port: the paper's one-click workflow.

Train a random forest on attack-detection flows, map it to the M/A
pipeline (encode-based), validate mapped-vs-native parity, inspect the
switch resource footprint, and predict through the CUDA kernels.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""
import argparse

import numpy as np

from repro_torch.core import PlanterConfig, plant
from repro_torch.data import load_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # ① + ② load a dataset and train (host side, like the paper)
    ds = load_dataset("unsw", n=6000)
    cfg = PlanterConfig(model="rf", strategy="eb", size="M", device=args.device)

    # ③ map the trained model to match/action tables
    res = plant(cfg, ds.X_train, ds.y_train, ds.X_test)
    print("model=rf strategy=eb size=M")
    print(f"  train {res.train_seconds:.2f}s, convert {res.convert_seconds:.2f}s")
    print(f"  mapped-vs-native parity: {res.parity:.4f}")

    # resource accounting (paper Table 4 columns)
    r = res.mapped.resources()
    print(f"  resources: {r.entries} entries, {r.stages} logical stages, "
          f"{r.table_bits / 8 / 1024:.1f} KiB of tables")

    # ④⑤⑥ deploy: the staged kernels (bucketize + ternary_match)
    infer = res.mapped.torch_predict("cuda", device=args.device)
    labels = infer(ds.X_test[:512]).cpu().numpy()
    native = res.trained.predict(ds.X_test[:512])
    acc = (labels == ds.y_test[:512]).mean()
    print(f"  deployed accuracy on test flows: {acc:.4f} "
          f"(native {np.mean(native == ds.y_test[:512]):.4f}) on {args.device}")
    if not (labels == native).all():
        raise SystemExit("EB tree mapping must be exact")
    print("OK — mapped pipeline is bit-exact with the trained forest")


if __name__ == "__main__":
    main()
