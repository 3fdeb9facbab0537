"""Financial tick classification at minimum latency on the H100 port
(paper §2.1, §7.6).

Maps four models over NASDAQ ITCH-like order flow and compares their
single-batch latency and resource footprint — the paper's financial use
case where "every nanosecond counts".  The decision process is pure table
lookups: no multiplications on the data path (DM/EB), exactly the
property that lets the switch run at line rate.  On the card xgb-EB runs
the EB kernels, nb-LB and svm-LB one ``lb_lookup`` launch each (gather,
bias and argmax / one-vs-one vote fused), dt-DM its plain-torch walk.

    PYTHONPATH=src python examples/finance_lowlatency_torch.py [--device cpu]

``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import PlanterConfig, plant
from repro_torch.data import load_dataset


def bench(fn, x, dev, iters=20):
    """Mean microseconds of one predict call, the card synchronised."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn(x)  # warm-up (kernel build on first use)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    sync()
    return (time.perf_counter() - t0) / iters * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = load_dataset("nasdaq", n=8000)
    X = torch.as_tensor(ds.X_test[:1024].astype(np.int32), device=dev)
    print(f"{'model':10s} {'strategy':8s} {'acc':>6s} {'parity':>7s} "
          f"{'us/batch':>9s} {'entries':>8s} {'stages':>7s}")
    for model, strategy in (("xgb", "eb"), ("dt", "dm"), ("nb", "lb"),
                            ("svm", "lb")):
        res = plant(PlanterConfig(model=model, strategy=strategy, size="S",
                                  device=str(dev)),
                    ds.X_train, ds.y_train, ds.X_test)
        fn = res.mapped.torch_predict("auto", device=dev)
        us = bench(fn, X, dev)
        acc = (fn(X).cpu().numpy() == ds.y_test[:1024]).mean()
        r = res.mapped.resources()
        print(f"{model:10s} {strategy:8s} {acc:6.3f} {res.parity:7.3f} "
              f"{us:9.1f} {r.entries:8d} {r.stages:7d}")
    print(f"\nmid-price-move prediction from (side, size, price) — the "
          f"stateful ITCH features of Appendix C, on {dev}")


if __name__ == "__main__":
    main()
