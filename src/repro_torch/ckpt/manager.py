"""Fault-tolerant checkpointing: atomic, retained, verified (mirrors
``repro.ckpt.manager``; the same layout on disk, so each package reads the
other's checkpoints).

Layout per step::

    <dir>/step_000123.tmp/   (written)  ->  <dir>/step_000123/  (renamed)
        manifest.json   {step, leaves: {key: shape, dtype}, config_hash,
                         files: {arrays.npz: {crc32, bytes}}}
        manifest.crc32  CRC32 of manifest.json's own bytes
        arrays.npz      flat leaf arrays keyed by joined path

Keys and shapes are the JAX package's: a tree is flattened by
``repro_torch.tree``, so the port's list of layers is stored as the JAX
package's stacked ``[n_layers, ...]`` leaves under its names (``params/
layers/mixer/wq``, ``state/opt/.m/...``), and ``restore`` splits them
back into the target's layers.  Tensors are copied to the host at
``save``; bf16 leaves are stored as their 16-bit patterns (numpy has no
bf16 of its own) and recorded as ``bfloat16`` in the manifest, as the
JAX package records its own.

Every payload file's CRC32 is recorded in the manifest and re-checked on
restore (the manifest itself is covered by a sidecar CRC), so a torn
write, bit rot, or a dropped archive member raises
:class:`CheckpointCorrupt` instead of silently restoring garbage;
:meth:`CheckpointManager.latest_valid_step` walks retained steps
newest-first so a restart falls back past a damaged checkpoint instead
of dying on it.  Stale ``step_*.tmp`` directories left by a crash
mid-write are removed on construction.

Async mode snapshots to host memory and writes on a background thread so
the training loop never blocks on storage; a failed background write
surfaces as :class:`CheckpointWriteError` (naming the failing step) on
the *next* ``save``/``wait`` call and never poisons subsequent saves.
``restore(..., shardings=)`` restores onto a mesh (``dist.sharding``),
which may be another than the one the checkpoint was written under: the
elastic restart path.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves, map_leaves

BF16 = "bfloat16"  # the manifest's name of a bf16 leaf


class CheckpointCorrupt(RuntimeError):
    """A checkpoint on disk failed verification (CRC mismatch, damaged
    manifest, or missing leaf) — restore refuses to hand back garbage."""


class CheckpointWriteError(RuntimeError):
    """A background (async) checkpoint write failed; raised on the next
    ``save``/``wait`` call with the failing step in the message."""


def _host(x, copy: bool) -> Tuple[np.ndarray, str]:
    """(a host array of ``x``, the manifest's dtype name).  A tensor on
    the card is copied by the transfer; ``copy`` copies a host tensor or
    array too, so a later in-place update cannot reach an async write."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            a, name = t.view(torch.int16).cpu().numpy().view(np.uint16), BF16
        else:
            a = t.cpu().numpy()
            name = str(a.dtype)
        return (a.copy() if copy and t.device.type == "cpu" else a), name
    a = np.array(x, copy=copy) if copy else np.asarray(x)
    return a, str(a.dtype)


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """The JAX package's flat ``{key: array}`` view of ``tree`` (stacked
    layers stacked) and each leaf's dtype name."""
    flat, dtypes = {}, {}
    for leaf in leaves(tree):
        host = [_host(p, copy=not leaf.stacked) for p in leaf.parts]
        flat[leaf.key] = (np.stack([a for a, _ in host]) if leaf.stacked
                          else host[0][0])
        dtypes[leaf.key] = host[0][1]
    return flat, dtypes


def _restore_like(arr: np.ndarray, dtype_name: str, like, sharding=None):
    """A stored array in the form of the target leaf ``like``: a tensor of
    its dtype on its device, or an array of its dtype.  With ``sharding``
    (a ``dist.sharding.NamedSharding``) the leaf is validated against it
    and becomes a tensor on its mesh's device (of the target's dtype, or
    the stored one for a target that is no tensor)."""
    arr = arr if arr.flags.c_contiguous else arr.copy()
    if dtype_name == BF16 or (arr.dtype.kind == "V" and arr.itemsize == 2):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = None
    if sharding is not None:
        sharding.check(arr.shape)
        t = torch.from_numpy(arr) if t is None else t
        dtype = like.dtype if isinstance(like, torch.Tensor) else t.dtype
        return t.to(device=sharding.device, dtype=dtype)
    if isinstance(like, torch.Tensor):
        if t is None:
            t = torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    if t is not None:
        arr = t.float().numpy()
    return np.asarray(arr, getattr(like, "dtype", None))


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_writes: bool = False):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # a crash mid-_write leaves step_*.tmp behind; nothing ever
        # publishes them, so reclaim the space now instead of letting
        # them accumulate across restarts
        for d in os.listdir(directory):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d),
                              ignore_errors=True)
        self._pool = ThreadPoolExecutor(max_workers=1) if async_writes else None
        self._pending: Optional[Future] = None
        self._pending_step: Optional[int] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, config_hash: str = "") -> str:
        if self._pool is not None:
            # backpressure: one in flight, joined before the next host
            # snapshot is taken (two of a large model's would not fit);
            # surfaces the last write's failure
            self._reap()
        flat, dtypes = _flatten(tree)  # host copy (snapshot)
        if self._pool is not None:
            self._pending = self._pool.submit(
                self._write, step, flat, dtypes, config_hash)
            self._pending_step = step
            return self._final_dir(step)
        return self._write(step, flat, dtypes, config_hash)

    def wait(self):
        self._reap()

    def _reap(self):
        """Join the in-flight async write, surfacing its failure (with
        the failing step) without poisoning the manager: the pending
        slot is cleared *before* re-raising, so the next save starts
        clean."""
        if self._pending is None:
            return
        fut, step = self._pending, self._pending_step
        self._pending = None
        self._pending_step = None
        try:
            fut.result()
        except Exception as e:
            raise CheckpointWriteError(
                f"async checkpoint write for step {step} failed: "
                f"{e!r}") from e

    def _final_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               dtypes: Dict[str, str], config_hash: str) -> str:
        final = self._final_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = os.path.join(tmp, "arrays.npz")
        np.savez(arrays, **flat)
        manifest = {
            "step": step,
            "config_hash": config_hash,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
            "files": {"arrays.npz": {"crc32": _crc32_file(arrays),
                                     "bytes": os.path.getsize(arrays)}},
            "time": time.time(),
        }
        blob = json.dumps(manifest).encode()
        with open(os.path.join(tmp, "manifest.json"), "wb") as f:
            f.write(blob)
        # the manifest holds the payload CRCs, so it needs its own
        # integrity record — a sidecar CRC over its exact bytes
        with open(os.path.join(tmp, "manifest.crc32"), "w") as f:
            f.write(str(zlib.crc32(blob)))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._final_dir(s), ignore_errors=True)

    # ----------------------------------------------------- verification
    def verify(self, step: int) -> List[str]:
        """Integrity-check one retained step; returns the list of
        problems (empty = valid).  Checks, in order: the manifest
        parses and matches its sidecar CRC, the recorded step matches,
        every recorded payload file exists with the recorded size and
        CRC32, and every manifest leaf is present in the archive.
        Legacy checkpoints without CRC records fall back to the
        structural checks only."""
        d = self._final_dir(step)
        mpath = os.path.join(d, "manifest.json")
        problems: List[str] = []
        try:
            blob = open(mpath, "rb").read()
        except OSError as e:
            return [f"manifest unreadable: {e}"]
        crc_path = os.path.join(mpath[: -len(".json")] + ".crc32")
        if os.path.exists(crc_path):
            try:
                want = int(open(crc_path).read().strip())
            except (OSError, ValueError) as e:
                return [f"manifest sidecar unreadable: {e}"]
            if zlib.crc32(blob) != want:
                return [f"manifest.json CRC mismatch (step {step})"]
        try:
            manifest = json.loads(blob)
        except ValueError as e:
            return [f"manifest.json does not parse: {e}"]
        if manifest.get("step") != step:
            problems.append(
                f"manifest step {manifest.get('step')} != dir step {step}")
        for fname, rec in manifest.get("files", {}).items():
            fpath = os.path.join(d, fname)
            if not os.path.exists(fpath):
                problems.append(f"{fname} missing")
                continue
            size = os.path.getsize(fpath)
            if size != rec.get("bytes"):
                problems.append(
                    f"{fname} is {size} bytes, manifest says "
                    f"{rec.get('bytes')} (truncated write?)")
                continue
            if _crc32_file(fpath) != rec.get("crc32"):
                problems.append(f"{fname} CRC32 mismatch")
        if not problems:
            # CRCs cover bytes; membership covers a well-formed archive
            # that lost a member (or a legacy checkpoint with no CRCs)
            try:
                with np.load(os.path.join(d, "arrays.npz")) as data:
                    names = set(data.files)
            except Exception as e:
                return [f"arrays.npz unreadable: {e}"]
            for key in manifest.get("leaves", {}):
                if key not in names:
                    problems.append(f"leaf {key} missing from arrays.npz")
        return problems

    def latest_valid_step(self) -> Optional[int]:
        """Newest retained step that passes :meth:`verify` — the elastic
        restart entry point: a corrupted latest checkpoint is skipped,
        not fatal."""
        for s in reversed(self.list_steps()):
            if not self.verify(s):
                return s
        return None

    def _load_verified(self, step: int) -> Tuple[dict, Any]:
        problems = self.verify(step)
        if problems:
            raise CheckpointCorrupt(
                f"checkpoint step {step} failed verification: "
                + "; ".join(problems))
        d = self._final_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        return manifest, data

    # ---------------------------------------------------------- restore
    def list_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d,
                                               "manifest.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore_flat(self, step: int) -> Dict[str, np.ndarray]:
        """Restore the flat ``{path: array}`` view without a target tree.

        ``restore`` needs a structure-and-shape-matched template, which
        callers with variable-shape payloads (the serve queue snapshot a
        preemption writes) cannot build up front; the flat view is the
        manifest's own keying, shapes included.
        """
        manifest, data = self._load_verified(step)
        with data:
            return {k: data[k] for k in manifest["leaves"]}

    def restore(self, step: int, target_tree: Any,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``target_tree``: each leaf in its
        target's dtype and on its device, a stacked leaf split into the
        target's layers; the shapes must match.

        ``shardings`` (a tree of ``dist.sharding.NamedSharding`` mirroring
        the target, e.g. ``param_shardings``) restores onto a mesh: each
        tensor is validated against its sharding and placed on the
        sharding's mesh device, which may come from another mesh than the
        one the checkpoint was written under (the elastic restart path).
        """
        manifest, data = self._load_verified(step)
        placed = ({leaf.key: leaf.parts for leaf in leaves(shardings)}
                  if shardings is not None else None)

        def one(leaf):
            if leaf.key not in data:
                raise CheckpointCorrupt(
                    f"checkpoint step {step} missing leaf {leaf.key}")
            arr = data[leaf.key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {leaf.key}: "
                                 f"{arr.shape} vs {leaf.shape}")
            name = manifest["leaves"][leaf.key]["dtype"]
            parts = list(arr) if leaf.stacked else [arr]
            shs = [None] * len(parts)
            if placed is not None:
                shs = placed.get(leaf.key)
                if shs is None or len(shs) != len(parts):
                    raise ValueError(f"shardings do not mirror the target "
                                     f"at {leaf.key}")
            return [_restore_like(a, name, like, sh)
                    for a, like, sh in zip(parts, leaf.parts, shs)]

        with data:
            return map_leaves(one, target_tree)


def config_hash(obj: Any) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]
