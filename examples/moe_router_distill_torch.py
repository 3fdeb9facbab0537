"""Beyond-paper, on the H100 port: distill a learned MoE router into a Planter
pipeline (the PyTorch counterpart of ``examples/moe_router_distill.py``).

An MoE router is itself a tiny classifier (hidden state -> expert id).
The router of layer 0 of qwen2-moe's smoke config labels random hidden
states with their top expert, and two Planter stages distill it, the way
the paper composes dimensional reduction with classification: **PCA (LB)
-> DT (EB)**.  Both stages predict through the port's table pipelines on
the card: the PCA stage is one ``lb_lookup`` launch (its raw epilogue
gives the principal components from the quantized hidden state), the
tree's stage ``fused_eb`` for a gate-sized table, else ``bucketize`` +
``ternary_match``.

    PYTHONPATH=src python examples/moe_router_distill_torch.py [--device cpu]

``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.arch import model as M
from repro_torch.configs import get_smoke_config
from repro_torch.core import PlanterConfig, plant
from repro_torch.kernels import ops


def _quantize(x: np.ndarray, lo, hi, bits: int) -> np.ndarray:
    top = 2**bits - 1
    return np.clip((x - lo) / (hi - lo) * top, 0, top).astype(np.int64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("qwen2_moe_a2_7b")
    params = M.init_params(cfg, 0, dev, masters=True)
    router_w = params["layers"][0]["moe"]["router"].cpu().numpy()  # layer 0

    rng = np.random.default_rng(0)
    hidden = rng.normal(0, 1, (8000, cfg.d_model)).astype(np.float32)
    logits = hidden @ router_w
    logits[:, cfg.n_experts:] = -1e30  # mask pad experts
    top1 = logits.argmax(axis=1).astype(np.int64)
    n = len(hidden) * 3 // 4

    # stage 1: Planter PCA (LB) on the quantized hidden state
    in_bits = 8
    H = _quantize(hidden, hidden.min(0), hidden.max(0), in_bits)
    pca = plant(PlanterConfig(model="pca", in_bits=in_bits, device=str(dev),
                              train_params=dict(n_components=5)),
                H[:n], None, H[n:])
    ops.reset_launch_counts()
    reduce = pca.mapped.torch_predict("auto", dev)
    Z = reduce(torch.as_tensor(H.astype(np.int32), device=dev)).cpu().numpy()
    lb_launches = {k: v for k, v in ops.launch_counts().items() if v}

    # stage 2: Planter DT (EB) on the reduced features
    Zq = _quantize(Z, Z[:n].min(0), Z[:n].max(0), in_bits)
    res = plant(PlanterConfig(model="dt", size="M", in_bits=in_bits,
                              device=str(dev),
                              train_params=dict(max_depth=7)),
                Zq[:n], top1[:n], Zq[n:])
    ops.reset_launch_counts()
    route = res.mapped.torch_predict("auto", dev)
    got = route(torch.as_tensor(Zq[n:].astype(np.int32), device=dev))
    eb_launches = {k: v for k, v in ops.launch_counts().items() if v}
    mapped = (got.cpu().numpy() == top1[n:]).mean()
    native = (res.trained.predict(Zq[n:]) == top1[n:]).mean()
    r = res.mapped.resources()
    base = np.bincount(top1).max() / len(top1)
    print(f"router classes (experts): {cfg.n_experts}; "
          f"majority base rate {base:.3f}")
    print(f"PCA(5) -> DT_EB distilled router agreement: native={native:.3f} "
          f"mapped={mapped:.3f} on {dev}")
    print(f"PCA-LB parity {pca.parity:.3f}; launches: LB stage "
          f"{lb_launches or 'none (plain versions)'}, EB stage "
          f"({res.mapped.select_backend(dev)}) "
          f"{eb_launches or 'none (plain versions)'}")
    print(f"resources: {r.entries} entries, {r.stages} stages, "
          f"{r.table_bits / 8 / 1024:.1f} KiB "
          f"(+ PCA LB tables: {cfg.d_model}x{2**in_bits} entries)")
    print("NOTE: random-init router => near-linear boundaries; a trained "
          "router distills better.  The point is the pipeline: hidden -> "
          "LB dimensional reduction -> feature tables -> ternary match -> "
          "expert id, at line rate in the fabric.")
    return native, mapped


if __name__ == "__main__":
    main()
