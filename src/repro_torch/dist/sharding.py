"""Mesh-aware partition-spec derivation for params, batches and caches
(mirrors ``repro.dist.sharding``, with the port's own ``Mesh``,
``PartitionSpec`` and ``NamedSharding`` in place of ``jax.sharding``'s).

The rules are the JAX package's rule table, name-driven, so one table
covers every family (dense, GQA, MoE, recurrent, enc-dec, VLM):

* column-parallel projections shard their output dim over ``model``;
* row-parallel projections (``wo``/``w_down``/``w_out``) shard their
  input dim over ``model``;
* the embedding shards the (256-padded) vocab, the LM head its vocab
  output dim;
* MoE expert stacks ``[E, D, F]`` shard the expert dim over ``model``;
* stacked-layer leading dims (``layers``/``macros``/``enc_layers``/
  ``cross_layers``) are scan axes and never shard;
* every proposal is validated against the mesh: an axis absent from the
  mesh or not dividing its dim is dropped (replicated), so specs are
  safe for any mesh from the 1x2 smoke mesh to the 16x16 pod.

A ``pod`` super-axis, when present, folds into data parallelism:
``batch_pspec`` returns ``P(("pod", "data"), ...)``.

**One card, logical chips.**  The JAX package simulates a fleet inside
one process (fake XLA devices on the CPU).  The port does the same over
*logical chips*: a :class:`Mesh` is an array of logical chip ids, its
axis names, and the one ``torch.device`` that every chip lives on.  A
:class:`NamedSharding` records a placement and validates it against its
leaf; on the one device the leaf is held once, whole, and the train step
computes the same function as on any other mesh, in the single-device
reduction order (ROADMAP C.18: the port's losses do not depend on the
mesh shape; the JAX package's GSPMD reductions may).

**Ranks.**  A :class:`RankMesh`'s chips are the ranks of a
``torch.distributed`` world (``dist.comm``), each on its own device: its
``device`` is this rank's, and ``NamedSharding.place`` keeps this rank's
contiguous shard of a leaf (``shard_shape``), not the whole leaf.  The
rule table is the same for both meshes.  ``seq_split`` tells a cache
whose sequence the rules split over ``model`` which part this rank holds
(:class:`SeqSplit`), so a step writes its own rows and gathers the rest
from its ``model`` row before the attention.  A mesh of several data
slices makes a process group a slice; a slice this rank is not in is a
:class:`ForeignSlice`.

The port keeps a model's layers as a list of per-layer dicts, where the
JAX package stacks them.  ``param_spec`` takes a leaf's JAX key and its
stacked shape (``repro_torch.tree``'s view), so it is the JAX rule
verbatim; ``param_pspecs`` gives each layer's tensor that spec with the
stack's leading ``None`` dropped.  Only ``mesh.axis_names`` and
``mesh.shape`` are read until a ``NamedSharding`` is built, so the rules
work on abstract mesh stand-ins too.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..tree import SEP, leaves, map_leaves

__all__ = ["MODEL_AXIS", "Mesh", "RankMesh", "ForeignSlice", "SeqSplit",
           "PartitionSpec",
           "P", "NamedSharding",
           "place", "data_axis", "param_spec", "param_pspecs",
           "param_shardings", "batch_pspec", "cache_pspec", "cache_shardings",
           "paged_cache_pspec", "paged_kv_shardings", "serve_pspec",
           "serve_state_shardings", "queue_pspec"]

MODEL_AXIS = "model"

# roots whose first array dim is a stacked layer axis (never sharded)
_STACKED_ROOTS = ("layers", "macros", "enc_layers", "cross_layers")

# output-dim ("column") parallel projections: shard the last dim
_COL_PARALLEL = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_lin", "w_rec_gate", "w_in_gate",
    "w_i", "w_f", "w_gates", "r_gates", "router", "conv", "frontend_proj",
    "embed_proj",
}
# input-dim ("row") parallel projections: shard the first dim
_ROW_PARALLEL = {"wo", "w_down", "w_out"}


class PartitionSpec:
    """One mesh axis (a name, a tuple of names, or None) per array dim:
    ``jax.sharding.PartitionSpec``'s counterpart.  Equal to any sequence
    of the same entries (a JAX spec included); not a tuple, so the port's
    tree walk (``repro_torch.tree``) takes a spec as one leaf."""

    __slots__ = ("_axes",)

    def __init__(self, *axes):
        self._axes = tuple(tuple(a) if isinstance(a, list) else a
                           for a in axes)

    def __iter__(self):
        return iter(self._axes)

    def __len__(self) -> int:
        return len(self._axes)

    def __getitem__(self, i):
        return self._axes[i]

    def __eq__(self, other) -> bool:
        try:
            return self._axes == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self._axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._axes!r}"


P = PartitionSpec


class Mesh:
    """A mesh of logical chips on one physical device.

    ``devices`` is the array of logical chip ids (its shape the mesh's),
    ``axis_names`` one name a dim, ``device`` the ``torch.device`` every
    chip lives on.  ``mesh.shape`` maps each axis name to its size, as a
    JAX mesh's does.  ``with mesh:`` is accepted and does nothing (the
    JAX loops enter their mesh)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 device: Union[str, torch.device] = "cuda"):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.devices.ravel().tolist())) != self.devices.size:
            raise ValueError(f"a chip appears twice in {self.devices}")
        self.device = torch.device(device)

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(
            (a, int(n)) for a, n in zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_ids(self) -> list:
        """The logical chip ids, row-major."""
        return [int(i) for i in self.devices.ravel()]

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def submesh(self, devices) -> "Mesh":
        """The mesh of a block of this one's chips, on the same axes."""
        return Mesh(devices, self.axis_names, self.device)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, chips {self.device_ids()}, on "
                f"{self.device})")


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A cache's sequence split over the ``model`` axis of a rank mesh:
    this rank holds part ``index`` of ``parts`` equal, contiguous parts,
    and ``dist.comm.gather`` over ``group`` rebuilds the whole."""

    index: int
    parts: int
    group: Any = None

    def full(self, local: int) -> int:
        return local * self.parts


class RankMesh(Mesh):
    """A mesh whose chips are the ranks of a ``torch.distributed`` world
    (``dist.comm.init``), one rank a chip: ``devices`` holds world rank
    numbers, ``device`` is this rank's device, ``rank`` its world rank,
    ``coords`` its index on each axis and ``lead`` the mesh's first rank.
    ``group`` is the process group of the mesh's ranks (None: the world).
    A mesh of several ``model`` rows (``DATA > 1``) is made over the world
    and makes one group a row when it is made (``dist.comm.new_groups``,
    every rank in the same order); ``model_group`` is the row of this
    rank, over which a cache split over ``model`` gathers.  A mesh naming
    another device than this rank's raises ``ValueError``; a mesh without
    this rank, too."""

    def __init__(self, devices, axis_names: Sequence[str],
                 device: Union[str, torch.device, None] = None, group=None):
        from . import comm

        here = comm.placement()
        device = here.device if device is None else torch.device(device)
        if device.type == "cuda" and device.index is None \
                and here.device.type == "cuda":
            device = torch.device("cuda", here.device.index)
        if device != here.device:
            raise ValueError(f"rank {here.rank} serves on {here.device}; a "
                             f"rank mesh on {device} names another rank's "
                             f"device")
        super().__init__(devices, axis_names, device)
        import torch.distributed as dist

        self.group = group
        self.rank = here.rank
        members = (list(range(here.world_size)) if group is None
                   else dist.get_process_group_ranks(group))
        if sorted(self.device_ids()) != sorted(members):
            raise ValueError(f"a rank mesh holds every rank of its group "
                             f"once ({sorted(members)}), got "
                             f"{self.device_ids()}")
        at = np.argwhere(self.devices == self.rank)
        self.coords = {a: int(i) for a, i in zip(self.axis_names, at[0])}
        self.lead = self.device_ids()[0]
        self._rows = _model_rows(self)
        for row in self._rows:
            if row != sorted(row):
                raise ValueError(f"a model row of a rank mesh lists its "
                                 f"ranks in ascending order (the order a "
                                 f"gather concatenates in), got {row}")
        if len(self._rows) == 1:
            self._groups = [group]
        elif group is not None:
            raise ValueError("a rank mesh of several model rows is made "
                             "over the world (group None)")
        else:
            self._groups = comm.new_groups(self._rows)
        self.model_group = next(g for row, g in zip(self._rows, self._groups)
                                if self.rank in row)

    def submesh(self, devices) -> "RankMesh":
        """The mesh of a block of this one's ranks, on the same axes: the
        whole mesh, or one model row (a data slice) that holds this rank,
        over the group made with this mesh."""
        devices = np.asarray(devices)
        ids = [int(i) for i in devices.ravel()]
        if ids == self.device_ids():
            return RankMesh(devices, self.axis_names, self.device,
                            self.group)
        for row, g in zip(self._rows, self._groups):
            if ids == row:
                if g is None:
                    raise ValueError(f"rank {self.rank} is not in the slice "
                                     f"of ranks {row}")
                return RankMesh(devices, self.axis_names, self.device, g)
        raise ValueError(f"a block of a rank mesh is the whole mesh or one "
                         f"model row {self._rows}, got {ids}")

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (a name or a tuple of names,
        row-major over them)."""
        names = axis if isinstance(axis, tuple) else (axis,)
        idx = 0
        for a in names:
            idx = idx * int(self.shape[a]) + self.coords[a]
        return idx

    def seq_split(self, full: int) -> Optional[SeqSplit]:
        """The split of a cache sequence of ``full`` cells over ``model``
        (the rules' ``cache_pspec`` / ``paged_cache_pspec``: only where
        ``model`` divides it), over this rank's ``model`` row, or None
        where each rank holds it whole, as on a ``model`` axis of one rank:
        a world of one gathers nothing."""
        m = int(self.shape.get(MODEL_AXIS, 1))
        if m == 1 or full <= 1 or full % m:
            return None
        return SeqSplit(self.axis_index(MODEL_AXIS), m, self.model_group)

    def __repr__(self) -> str:
        return (f"RankMesh({dict(self.shape)}, ranks {self.device_ids()}, "
                f"rank {self.rank} on {self.device})")


def _model_rows(mesh: Mesh) -> list:
    """The mesh's ranks grouped by every coordinate but ``model``'s, each
    row in ``model`` order: the data slices of a ``(data, model)`` mesh."""
    devs = np.asarray(mesh.devices)
    if MODEL_AXIS in mesh.axis_names:
        devs = np.moveaxis(devs, mesh.axis_names.index(MODEL_AXIS), -1)
    else:
        devs = devs[..., None]
    return [[int(i) for i in row]
            for row in devs.reshape(-1, devs.shape[-1])]


@dataclasses.dataclass(frozen=True)
class ForeignSlice:
    """A data slice of a rank mesh that this rank is not in: its world
    ranks (a ``(1, model)`` block).  This rank gets no mesh of it, since it
    is in none of its groups; the router serves it through a stand-in
    that the slice's lead rank reports for."""

    devices: Any

    @property
    def lead(self) -> int:
        return int(np.asarray(self.devices).ravel()[0])


class NamedSharding:
    """A placement of one leaf on a mesh: ``jax.sharding.NamedSharding``'s
    counterpart.  ``check(shape)`` validates the spec against a leaf (at
    most one entry a dim, every axis on the mesh, each dim divisible by
    its axes' size) and ``place(t)`` puts the validated leaf on the mesh's
    device: whole on logical chips (they share it), this rank's shard on a
    :class:`RankMesh`."""

    def __init__(self, mesh: Mesh, spec: Union[PartitionSpec, Iterable]):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def check(self, shape: Sequence[int]) -> None:
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has {len(self.spec)} entries for "
                             f"a {len(shape)}-d leaf {shape}")
        used = []
        for dim, ax in zip(shape, self.spec):
            if ax is None:
                continue
            names = ax if isinstance(ax, tuple) else (ax,)
            for a in names:
                if a not in self.mesh.axis_names:
                    raise ValueError(f"{self.spec} names axis {a!r}, not on "
                                     f"the mesh {self.mesh.axis_names}")
                if a in used:
                    raise ValueError(f"{self.spec} uses axis {a!r} twice")
                used.append(a)
            if dim % _axis_size(self.mesh, ax):
                raise ValueError(f"{self.spec}: dim {dim} of {shape} does "
                                 f"not divide over {ax!r} "
                                 f"({_axis_size(self.mesh, ax)} chips)")

    def place(self, t: torch.Tensor) -> torch.Tensor:
        self.check(t.shape)
        if not isinstance(self.mesh, RankMesh):
            return t.to(self.mesh.device)
        out = t
        for dim, ax in enumerate(self.spec):
            n = _axis_size(self.mesh, ax)
            if n > 1:
                size = t.shape[dim] // n
                out = out.narrow(dim, self.mesh.axis_index(ax) * size, size)
        if out is t:
            return t.to(self.mesh.device)
        # a copy of the shard alone: the whole leaf is not kept alive
        return out.to(self.mesh.device, copy=True).contiguous()

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One chip's shard of a leaf of ``shape``, as JAX's
        ``NamedSharding.shard_shape``: each dim over its axes' size."""
        self.check(shape)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(int(d) // _axis_size(self.mesh, ax)
                     for d, ax in zip(shape, spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def place(tree, shardings):
    """``jax.device_put``'s counterpart: ``tree`` placed by a tree of
    NamedShardings that mirrors it (None where the tree holds no tensor),
    or by one NamedSharding for every tensor.  Each tensor is validated
    and held whole on the mesh's device; one already there is the same
    tensor, so nothing is copied and no kernel runs."""
    if isinstance(tree, torch.Tensor):
        return shardings.place(tree)

    def at(key):  # a child's shardings
        if isinstance(shardings, NamedSharding):
            return shardings
        if dataclasses.is_dataclass(shardings):
            return getattr(shardings, key)
        return shardings[key]

    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: place(getattr(tree, f.name), at(f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, dict):
        return {k: place(v, at(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [place(v, at(i)) for i, v in enumerate(tree)]
        return (type(tree)(*items) if hasattr(tree, "_fields")
                else type(tree)(items))
    return tree


def _path_names(path) -> Tuple[str, ...]:
    """A leaf's path as names: a ``repro_torch.tree`` key (``"a/b/.m"``)
    or a sequence of names; a NamedTuple field loses its dot, as a JAX
    ``GetAttrKey`` gives its bare name."""
    parts = path.split(SEP) if isinstance(path, str) else [str(p)
                                                          for p in path]
    return tuple(p[1:] if p.startswith(".") else p for p in parts if p)


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return int(np.prod([int(mesh.shape[a]) for a in axis]))
    return int(mesh.shape[axis])


def _present(mesh, axis):
    """Restrict a proposed axis to the names the mesh actually has: an
    absent axis degrades to replication on that dim."""
    names = tuple(mesh.axis_names)
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        kept = tuple(a for a in axis if a in names)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return axis if axis in names else None


def _divides(mesh, axis, dim: int) -> bool:
    return dim > 0 and dim % _axis_size(mesh, axis) == 0


def data_axis(mesh):
    """The (possibly compound) data-parallel axis: pod folds into data."""
    if "pod" in tuple(mesh.axis_names):
        return ("pod", "data")
    return "data"


def _validated(shape: Sequence[int], axes: Sequence[Any], mesh) -> P:
    """Drop any proposed axis absent from the mesh or not dividing its dim."""
    out = []
    for dim, ax in zip(shape, axes):
        ax = _present(mesh, ax)
        if ax is not None and _divides(mesh, ax, dim):
            out.append(ax)
        else:
            out.append(None)
    return P(*out)


# ------------------------------------------------------------------ params
def param_spec(path, leaf, mesh) -> P:
    """The JAX package's PartitionSpec for one parameter leaf: ``path`` its
    JAX key (``repro_torch.tree``), ``leaf`` anything with the JAX leaf's
    ``shape`` (a stacked leaf's shape leads with the layer count)."""
    names = _path_names(path)
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    ndim = len(shape)
    if ndim == 0:
        return P()

    lead = 1 if (names and names[0] in _STACKED_ROOTS and ndim > 1) else 0
    core = shape[lead:]
    axes: Tuple[Any, ...] = tuple(None for _ in core)

    if name == "embed" and ndim == 2:
        axes = (MODEL_AXIS, None)  # vocab rows (256-padded -> always even)
    elif name == "head" and ndim == 2:
        axes = (None, MODEL_AXIS)  # vocab columns
    elif ("moe" in names and "shared" not in names
          and name in ("w_gate", "w_up", "w_down") and len(core) == 3):
        axes = (MODEL_AXIS, None, None)  # expert parallelism over [E, ., .]
    elif name in _ROW_PARALLEL and len(core) == 2:
        axes = (MODEL_AXIS, None)
    elif name in _COL_PARALLEL and len(core) >= 2:
        axes = tuple(None for _ in core[:-1]) + (MODEL_AXIS,)
    # 1-D leaves (norm scales, biases, gate biases, lam) replicate: they
    # are tiny and feed elementwise ops on model-sharded activations.

    full = tuple([None] * lead) + tuple(axes)
    return _validated(shape, full, mesh)


def param_pspecs(params, mesh):
    """A tree of PartitionSpecs mirroring the port's ``params``: each
    tensor's is its JAX leaf's spec, a layer's without the stack's leading
    entry."""
    def one(leaf):
        spec = param_spec(leaf.key, leaf, mesh)
        if leaf.stacked:
            spec = P(*tuple(spec)[1:])
        return [spec] * len(leaf.parts)

    return map_leaves(one, params)


def _shardings(specs, mesh):
    return map_leaves(lambda leaf: [NamedSharding(mesh, s)
                                    for s in leaf.parts], specs)


def param_shardings(params, mesh):
    """A tree of NamedShardings mirroring ``params`` (a real ``Mesh``)."""
    return _shardings(param_pspecs(params, mesh), mesh)


# ------------------------------------------------------------------- batch
def batch_pspec(mesh, batch_size: int, ndim: int) -> P:
    """Batch-dim data parallelism; replicate when the batch can't split or
    the mesh has no data axis (a model-only serve submesh)."""
    dp = _present(mesh, data_axis(mesh))
    if dp is None or not _divides(mesh, dp, batch_size):
        return P(*([None] * ndim))
    return P(dp, *([None] * (ndim - 1)))


# ------------------------------------------------------------------ caches
def cache_pspec(path, leaf, mesh, batch: int) -> P:
    """PartitionSpec for one decode-state leaf (``model.init_decode_state``:
    the JAX package's keys and layouts).

    * KV caches ``[stack, B, S, KV, hd]`` — batch shards over data, and
      the *sequence* dim over ``model``;
    * recurrent states ``[stack, B, ...]`` / tail states ``[B, ...]`` —
      batch shards over data, the rest replicates;
    * scalars (``pos``) — replicated.
    """
    shape = tuple(leaf.shape)
    if not shape:
        return P()
    axes: list = [None] * len(shape)
    dp = _present(mesh, data_axis(mesh))
    names = _path_names(path)

    # Stacked leaves ([stack, B, ...]) carry batch at dim 1: KV/cross
    # caches, macro-block recurrent states, and any >=4-D leaf.  Tail
    # states and other per-batch leaves carry it at dim 0.  Checking the
    # layout before sizes avoids misdetection when stack depth == batch.
    stacked_key = bool(names) and (
        names[0] in ("kv", "kv_scales", "cross")
        or (names[0].startswith("m") and "_" in names[0]))
    tail_key = bool(names) and names[0].startswith("tail")
    bdim: Optional[int] = None
    if tail_key:
        bdim = 0 if shape[0] == batch else None
    elif ((stacked_key or len(shape) >= 4)
          and len(shape) >= 2 and shape[1] == batch):
        bdim = 1
    else:
        for i, d in enumerate(shape):
            if d == batch:
                bdim = i
                break
    if bdim is not None and dp is not None and _divides(mesh, dp, batch):
        axes[bdim] = dp

    if len(shape) == 5 and bdim == 1:  # [stack, B, S, KV, hd] cache layout
        mp = _present(mesh, MODEL_AXIS)
        if mp is not None and shape[2] > 1 and _divides(mesh, mp, shape[2]):
            axes[2] = mp
    return P(*axes)


def cache_shardings(state, mesh, batch: int):
    """A tree of NamedShardings for a decode-state tree."""
    return map_leaves(
        lambda leaf: [NamedSharding(mesh, cache_pspec(leaf.key, p, mesh,
                                                      batch))
                      for p in leaf.parts], state)


def paged_cache_pspec(leaf, mesh) -> P:
    """PartitionSpec for a paged KV page pool ``[stack, n_pages, page, KV,
    hd]`` (``model.init_paged_kv``; the int8 pool's float32 scale planes
    ``[..., KV, 1]`` follow the same rule): physical pages over ``data``,
    the within-page sequence over ``model`` where the page size divides
    it; any other leaf replicates."""
    shape = tuple(leaf.shape)
    if len(shape) != 5:
        return P(*([None] * len(shape)))
    return _validated(shape,
                      (None, data_axis(mesh), MODEL_AXIS, None, None),
                      mesh)


def paged_kv_shardings(kv, mesh):
    """NamedShardings for a page pool: a ``PagedKV`` (its pool fields; a
    None field stays None) or a tuple of pool tensors."""
    def one(x):
        if x is None or not isinstance(x, torch.Tensor):
            return x
        return NamedSharding(mesh, paged_cache_pspec(x, mesh))

    if dataclasses.is_dataclass(kv):
        return dataclasses.replace(kv, **{
            f.name: one(getattr(kv, f.name))
            for f in dataclasses.fields(kv)
            if isinstance(getattr(kv, f.name), torch.Tensor)})
    if isinstance(kv, (tuple, list)):
        return type(kv)(one(x) for x in kv)
    return one(kv)


# ------------------------------------------------------------------- serve
# The device-resident batcher's state: a decode-state subtree under
# "decode" (or a page pool under "pages"), flat per-slot arrays,
# per-request output rings, and a scalar queue head.
_SLOT_LEAVES = ("free", "req", "gen", "last", "hasf", "pos", "plen",
                "reg", "seed", "qidx")
_RING_LEAVES = ("out_tok", "out_len", "out_done", "out_drop", "out_tbl")


def serve_pspec(path, leaf, mesh, batch: int) -> P:
    """PartitionSpec for one serve-state leaf (the JAX device batcher's
    donated pytree, by name):

    * the ``decode`` subtree follows ``cache_pspec``, the paged ``pages``
      pool ``paged_cache_pspec``;
    * per-slot arrays (``free``/``req``/``gen``/``last``/``hasf``, the
      sampling ``seed`` and queue-index ``qidx``, the paged
      ``pos``/``plen``/``reg``, the ``[B, F]`` gate features, the
      ``[B, P]`` prompt buffer and the ``[B, n_ps]`` block table) shard
      their slot dim over data;
    * output rings (``out_tbl`` too) and the page refcounts (``pref``)
      replicate, and so do scalars (the queue ``head``).
    """
    names = _path_names(path)
    if names and names[0] == "decode":
        return cache_pspec(names[1:], leaf, mesh, batch)
    if names and names[0] == "pages":
        return paged_cache_pspec(leaf, mesh)
    shape = tuple(leaf.shape)
    name = names[-1] if names else ""
    if not shape or name == "head" or name in ("pfree", "pref") \
            or name in _RING_LEAVES:
        return P(*([None] * len(shape)))
    if name in _SLOT_LEAVES or name in ("feat", "pbuf", "tbl"):
        return batch_pspec(mesh, shape[0], len(shape))
    return P(*([None] * len(shape)))


def serve_state_shardings(state, mesh, batch: int):
    """A tree of NamedShardings for a serve-state tree."""
    return map_leaves(
        lambda leaf: [NamedSharding(mesh, serve_pspec(leaf.key, p, mesh,
                                                      batch))
                      for p in leaf.parts], state)


def queue_pspec(mesh, n_queue: int, ndim: int) -> P:
    """Spec for the device FIFO queue / the batched admission-gate launch:
    queue rows are data-parallel like any request batch."""
    return batch_pspec(mesh, n_queue, ndim)
