"""Anomaly-detection gate fused into LM serving on the H100 port (paper
§7.3 coexistence).

An XGB classifier trained on CICIDS-like flows gates the request stream of
a (smoke-sized) qwen2 server: attack-labelled requests are dropped before
they consume decode capacity, and the gate runs inside every decode step
of ``ServeEngine.generate`` over the dense ring cache.  On the card the
gate is the ``fused_eb`` kernel and the step's attention and products the
``paged_attention`` and ``linear`` kernels.

    PYTHONPATH=src python examples/anomaly_gate_serving_torch.py [--device cpu]

``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.arch import model as M
from repro_torch.configs import get_smoke_config
from repro_torch.core import PlanterConfig, plant
from repro_torch.data import load_dataset
from repro_torch.serve.engine import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds = load_dataset("cicids", n=6000)
    gate = plant(PlanterConfig(model="xgb", size="S", device=str(dev)),
                 ds.X_train, ds.y_train, ds.X_test)
    print(f"gate: xgb_eb parity={gate.parity:.3f} "
          f"{gate.mapped.resources().entries} entries")

    cfg = get_smoke_config("qwen2_1_5b")
    params = M.init_params(cfg, 0, dev)
    engine = ServeEngine(cfg, params, ServeConfig(max_batch=8, cache_len=64),
                         gate=gate.mapped, device=dev)

    # a burst of requests: flow features + prompts
    feats = ds.X_test[:256]
    truth = ds.y_test[:256]
    keep = engine.admit(feats)
    tp = ((~keep) & (truth == 1)).sum()
    fp = ((~keep) & (truth == 0)).sum()
    print(f"admitted {keep.sum()}/256; dropped {(~keep).sum()} "
          f"({tp} true attacks, {fp} false positives)")

    admitted = np.where(keep)[0][:8]
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (8, 4))
    out = engine.generate(prompts, n_tokens=8, features=feats[admitted])
    print(f"served {out.size} tokens for admitted requests on {dev}; "
          f"sample row: {out[0]}")


if __name__ == "__main__":
    main()
