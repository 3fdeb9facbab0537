"""Synthetic use-case datasets shaped like the paper's workloads (§7.1).

Each generator returns integer features in [0, 2^in_bits) — the data plane
matches on packet-field integers — plus labels.  Ground truth has planted
structure so the mapped-vs-native parity claim (the paper's actual
experiment) is measurable; absolute accuracy is dataset-synthetic.

Datasets: UNSW/CICIDS-like 5-tuple flows (attack detection), NASDAQ
ITCH-like order stream (financial), Jane-Street-like anonymized features,
Requet-like QoE, Iris-like petals.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["Dataset", "load_dataset", "DATASETS"]


@dataclasses.dataclass
class Dataset:
    name: str
    X_train: np.ndarray
    y_train: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray
    in_bits: int
    n_classes: int
    feature_names: Tuple[str, ...]


def _split(X, y, test_frac, rng):
    n = len(X)
    order = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr, te = order[:cut], order[cut:]
    return X[tr], y[tr], X[te], y[te]


def unsw_flows(n: int = 8000, in_bits: int = 8, seed: int = 0,
               attack_frac: float = 0.25) -> Dataset:
    """5-tuple flow features; attacks concentrate on port/proto patterns."""
    rng = np.random.default_rng(seed)
    V = 2**in_bits
    src_ip = rng.integers(0, V, n)
    dst_ip = rng.integers(0, V, n)
    src_port = rng.integers(0, V, n)
    dst_port = rng.integers(0, V, n)
    proto = rng.choice([6, 17, 1, 47], n, p=[0.6, 0.25, 0.1, 0.05])
    y = np.zeros(n, np.int64)
    n_attack = int(n * attack_frac)
    idx = rng.choice(n, n_attack, replace=False)
    # planted attack signatures: scanner subnets hitting low ports over TCP,
    # plus a UDP amplification pattern
    half = n_attack // 2
    scan, ampl = idx[:half], idx[half:]
    src_ip[scan] = rng.integers(V - 16, V, half)  # scanner subnet
    dst_port[scan] = rng.integers(0, 32, half)  # well-known ports
    proto[scan] = 6
    dst_port[ampl] = 53 % V
    proto[ampl] = 17
    src_port[ampl] = rng.integers(V - 8, V, len(ampl))
    y[idx] = 1
    X = np.stack([src_ip, dst_ip, src_port, dst_port, proto], 1).astype(np.int64)
    return Dataset("unsw", *_split(X, y, 0.3, rng), in_bits, 2,
                   ("src_ip", "dst_ip", "src_port", "dst_port", "proto"))


def cicids_flows(n: int = 8000, in_bits: int = 8, seed: int = 1) -> Dataset:
    """Like UNSW but with three attack families (DoS / brute-force / bot)."""
    rng = np.random.default_rng(seed)
    V = 2**in_bits
    X = rng.integers(0, V, (n, 5))
    y = np.zeros(n, np.int64)
    third = n // 10
    dos = slice(0, third)
    brute = slice(third, 2 * third)
    bot = slice(2 * third, 3 * third)
    X[dos, 3] = 80 % V
    X[dos, 0] = rng.integers(0, 8, third)  # few sources, one dst port
    y[dos] = 1
    X[brute, 3] = 22 % V
    X[brute, 2] = rng.integers(V // 2, V, third)
    y[brute] = 1
    X[bot, 1] = rng.integers(V - 4, V, third)  # C2 subnet
    X[bot, 4] = 6
    y[bot] = 1
    perm = rng.permutation(n)
    return Dataset("cicids", *_split(X[perm], y[perm], 0.3, rng), in_bits, 2,
                   ("src_ip", "dst_ip", "src_port", "dst_port", "proto"))


def nasdaq_orders(n: int = 8000, in_bits: int = 8, seed: int = 2) -> Dataset:
    """ITCH add-order stream: (side, size, price) -> mid-price move label.

    Order-flow imbalance drives the planted mid-price dynamics, so the
    label is genuinely predictable from the stream (stateful features are
    the running aggregates, computed here as in Appendix C).
    """
    rng = np.random.default_rng(seed)
    V = 2**in_bits
    side = rng.integers(0, 2, n)  # 0 sell, 1 buy
    size = np.minimum((rng.pareto(2.0, n) * 20).astype(np.int64), V - 1)
    mid = V // 2
    prices = np.zeros(n, np.int64)
    labels = np.zeros(n, np.int64)
    imb = 0.0
    for i in range(n):
        imb = 0.9 * imb + (1 if side[i] else -1) * size[i]
        drift = int(np.clip(imb / 50.0, -3, 3))
        mid = int(np.clip(mid + drift + rng.integers(-1, 2), 1, V - 2))
        prices[i] = np.clip(mid + (1 if side[i] else -1) * rng.integers(0, 3),
                            0, V - 1)
        labels[i] = 1 if drift > 0 else 0  # next mid-price movement up?
    X = np.stack([side, size, prices], 1).astype(np.int64)
    return Dataset("nasdaq", *_split(X, labels, 0.3, rng), in_bits, 2,
                   ("side", "size", "price"))


def janestreet(n: int = 8000, in_bits: int = 8, seed: int = 3) -> Dataset:
    """Five anonymized market features; buy/sell from a noisy linear rule."""
    rng = np.random.default_rng(seed)
    V = 2**in_bits
    Z = rng.normal(0, 1, (n, 5))
    w = np.array([1.2, -0.8, 0.5, 0.9, -1.1])
    logit = Z @ w + rng.normal(0, 0.7, n)
    y = (logit > 0).astype(np.int64)
    X = np.clip(((Z + 4) / 8 * V), 0, V - 1).astype(np.int64)
    return Dataset("janestreet", *_split(X, y, 0.3, rng), in_bits, 2,
                   ("f42", "f43", "f120", "f124", "f126"))


def requet_qoe(n: int = 8000, in_bits: int = 8, seed: int = 4) -> Dataset:
    """QoE buffer-warning prediction from streaming-state features."""
    rng = np.random.default_rng(seed)
    V = 2**in_bits
    buf_prog = rng.integers(0, V, n)
    play_prog = rng.integers(0, V, n)
    src_ip = rng.integers(0, V, n)
    quality = rng.integers(0, 5, n)
    buf_valid = rng.integers(0, 2, n)
    # warning when buffer low relative to playback and high quality
    y = ((buf_prog < V // 5) & (quality >= 3) | (buf_valid == 0) &
         (buf_prog < V // 3)).astype(np.int64)
    X = np.stack([buf_prog, play_prog, src_ip, quality, buf_valid], 1).astype(
        np.int64
    )
    return Dataset("requet", *_split(X, y, 0.3, rng), in_bits, 2,
                   ("buf_prog", "play_prog", "src_ip", "quality", "buf_valid"))


def iris_like(n: int = 600, in_bits: int = 8, seed: int = 5) -> Dataset:
    """Three Gaussian petal clusters quantized to in_bits (4 features)."""
    rng = np.random.default_rng(seed)
    V = 2**in_bits
    means = np.array(
        [[50, 34, 15, 2], [59, 28, 43, 13], [66, 30, 55, 20]], np.float64
    ) * (V / 80.0)
    X_list, y_list = [], []
    for k in range(3):
        m = n // 3
        X_list.append(rng.normal(means[k], V / 28.0, (m, 4)))
        y_list.append(np.full(m, k, np.int64))
    X = np.clip(np.concatenate(X_list), 0, V - 1).astype(np.int64)
    y = np.concatenate(y_list)
    perm = rng.permutation(len(X))
    return Dataset("iris", *_split(X[perm], y[perm], 0.3, rng), in_bits, 3,
                   ("sep_l", "sep_w", "pet_l", "pet_w"))


DATASETS = {
    "unsw": unsw_flows,
    "cicids": cicids_flows,
    "nasdaq": nasdaq_orders,
    "janestreet": janestreet,
    "requet": requet_qoe,
    "iris": iris_like,
}


def load_dataset(name: str, **kw) -> Dataset:
    """The paper's Data Loader component: everything lands in one format."""
    return DATASETS[name](**kw)
