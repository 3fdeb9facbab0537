"""Binarized MLP (XNOR-net style) trained in PyTorch with straight-through grads.

Inputs are integer features expanded to their binary representation and
mapped to ±1 bits (the N3IC/toNIC convention).  With ±1 weights and ±1
activations, ``x @ w == 2*popcount(XNOR(x,w)) - n`` — so the trained model
deploys exactly as the paper's Eq. 8 pipeline.

The JAX package's trainer is followed step for step: the same initial
weights and per-epoch permutations drawn from ``np.random.default_rng(seed)``
in the same order, the same loss, Adam and clip.  Float training on another
framework is not bitwise equal to it, so only accuracy is compared.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["BinarizedMLP", "bits_pm1"]


def bits_pm1(X: np.ndarray, in_bits: int) -> np.ndarray:
    """Expand int features [B, F] -> ±1 bit matrix [B, F*in_bits]."""
    X = np.asarray(X, np.int64)
    shifts = np.arange(in_bits)
    bits = (X[..., None] >> shifts) & 1  # [B, F, in_bits]
    return (bits * 2 - 1).reshape(X.shape[0], -1).astype(np.float32)


class _SignSTE(torch.autograd.Function):
    """sign(x) with sign(0) = +1; backward is the hard-tanh straight-through
    estimator ``g * (|x| <= 1)``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


class BinarizedMLP:
    def __init__(self, hidden=(16,), in_bits=8, lr=0.01, epochs=50,
                 batch_size=100, seed=0):
        self.hidden = tuple(hidden)
        self.in_bits = in_bits
        self.lr = lr
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.weights_: List[np.ndarray] = []  # real-valued master weights
        self.n_classes_ = 0

    def _forward(self, params, xb):
        h = xb
        for i, w in enumerate(params):
            h = h @ _SignSTE.apply(w)
            if i < len(params) - 1:
                h = _SignSTE.apply(h)
        return h  # logits (un-activated popcount scores, per paper §4.3.3)

    def fit(self, X, y, device: Union[str, torch.device] = "cuda"):
        """Train on ``device`` (default ``cuda``; ``"cpu"`` for the CPU)."""
        dev = resolve_device(device)
        y = np.asarray(y, np.int64)
        K = self.n_classes_ = int(y.max()) + 1
        Xb = bits_pm1(X, self.in_bits)
        dims = [Xb.shape[1], *self.hidden, K]
        rng = np.random.default_rng(self.seed)
        params = [
            torch.as_tensor(rng.normal(0, 0.5, (dims[i], dims[i + 1])),
                            dtype=torch.float32, device=dev)
            for i in range(len(dims) - 1)
        ]
        opt_m = [torch.zeros_like(p) for p in params]
        opt_v = [torch.zeros_like(p) for p in params]
        temperature = float(np.sqrt(float(dims[-2])))
        Xd = torch.as_tensor(Xb, device=dev)
        yd = torch.as_tensor(y, device=dev)
        b1, b2, eps = 0.9, 0.999, 1e-8

        n = len(Xb)
        t = 0
        for _ in range(self.epochs):
            order = rng.permutation(n)
            for i in range(0, n, self.batch_size):
                idx = torch.as_tensor(order[i: i + self.batch_size], device=dev)
                t += 1
                for p in params:
                    p.requires_grad_(True)
                # popcount-scale logits saturate softmax; temperature by fan-in
                logits = self._forward(params, Xd[idx]) / temperature
                loss = torch.nn.functional.cross_entropy(logits, yd[idx])
                grads = torch.autograd.grad(loss, params)
                with torch.no_grad():
                    new = []
                    for p, g, m, v in zip(params, grads, opt_m, opt_v):
                        m.mul_(b1).add_((1 - b1) * g)
                        v.mul_(b2).add_((1 - b2) * g * g)
                        mhat = m / (1 - b1**t)
                        vhat = v / (1 - b2**t)
                        p = p - self.lr * mhat / (vhat.sqrt() + eps)
                        new.append(p.clamp(-1.5, 1.5))
                params = new
        self.weights_ = [p.detach().cpu().numpy() for p in params]
        return self

    def binary_weights(self) -> List[np.ndarray]:
        """±1 weight matrices as deployed."""
        return [np.where(w >= 0, 1, -1).astype(np.int8) for w in self.weights_]

    def predict(self, X):
        Xb = bits_pm1(X, self.in_bits)
        h = Xb
        ws = self.binary_weights()
        for i, w in enumerate(ws):
            h = h @ w.astype(np.float32)
            if i < len(ws) - 1:
                h = np.where(h >= 0, 1.0, -1.0)
        return h.argmax(axis=1)
