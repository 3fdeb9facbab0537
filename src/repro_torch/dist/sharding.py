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

**Tensor parallelism over ranks.**  With ``tp_params`` a rank mesh splits
the weights over its ``model`` group by whole heads, not by the JAX rules
(which can cut a head: qwen2-1.5b's ``wk`` has 256 columns, two heads,
which 4 chips would halve): :func:`tp_layout` says which blocks split
(:class:`TPLayout`), :class:`TensorParallel` is one rank's part of it and
:func:`tp_place` keeps that rank's slice of each leaf.  Query heads split
when ``m`` divides them, KV heads with them when ``m`` divides them too,
or each rank holds the one KV head its query heads read when the KV
heads divide ``m`` (duplicated over ``m / KV`` ranks); an attention block
whose heads divide neither way is replicated, as ``_validated`` drops an
axis that does not divide.  The MLP's and the shared experts' ``d_ff``,
the experts and the padded vocab split where ``m`` divides them.

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
           "TPLayout", "TensorParallel", "tp_layout", "tensor_parallel",
           "tp_place", "place", "data_axis", "param_spec", "param_pspecs",
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


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which blocks of a config split over a ``model`` group of ``m``
    ranks (:func:`tp_layout`) and the whole sizes their slices come from.
    ``q_heads`` / ``kv_heads`` are a rank's heads (every head where
    ``attn`` is False); ``kv_share`` ranks hold each KV head (1 unless the
    KV heads are duplicated)."""

    m: int
    head_dim: int
    n_q: int  # the config's query heads (q_heads)
    n_kv: int
    attn: bool
    q_heads: int
    kv_heads: int
    kv_share: int
    d_ff: int  # the MLP's (0: none, or experts)
    mlp: bool
    n_experts: int  # padded (0: no experts)
    experts: bool
    shared_d_ff: int
    shared: bool
    vocab_padded: int
    vocab: bool

    def blocks(self) -> str:
        """One line: each block and whether it splits or replicates."""
        def say(name, split, part=""):
            return f"{name} {'split' + part if split else 'replicated'}"

        out = [say("attention", self.attn,
                   f" ({self.q_heads} q / {self.kv_heads} kv heads a rank"
                   + (f", each kv head on {self.kv_share} ranks"
                      if self.kv_share > 1 else "") + ")")]
        if self.d_ff:
            out.append(say("mlp", self.mlp, f" (d_ff {self.d_ff // self.m}"
                           " a rank)"))
        if self.n_experts:
            out.append(say("experts", self.experts,
                           f" ({self.n_experts // self.m} a rank)"))
            out.append(say("router", False))
        if self.shared_d_ff:
            out.append(say("shared experts", self.shared,
                           f" (d_ff {self.shared_d_ff // self.m} a rank)"))
        out.append(say("embedding and head", self.vocab,
                       f" ({self.vocab_padded // self.m} rows a rank)"))
        return f"tensor parallel over {self.m} rank(s): " + "; ".join(out)


def tp_layout(cfg, m: int) -> TPLayout:
    """The head-aligned layout of ``cfg`` over a ``model`` group of ``m``
    ranks (the module docstring)."""
    m = int(m)
    if m < 1:
        raise ValueError(f"a model group holds at least one rank, got {m}")
    nq, nkv = cfg.q_heads, cfg.n_kv_heads
    attn = nq % m == 0 and (nkv % m == 0 or m % nkv == 0)
    if attn:
        q, kv = nq // m, (nkv // m if nkv % m == 0 else 1)
        share = 1 if nkv % m == 0 else m // nkv
    else:
        q, kv, share = nq, nkv, 1
    d_ff = 0 if cfg.n_experts else cfg.d_ff
    E = cfg.n_experts_padded
    shared = cfg.shared_d_ff if cfg.n_experts and cfg.n_shared_experts else 0
    return TPLayout(
        m=m, head_dim=cfg.head_dim_, n_q=nq, n_kv=nkv, attn=attn, q_heads=q,
        kv_heads=kv, kv_share=share, d_ff=d_ff,
        mlp=bool(d_ff) and d_ff % m == 0, n_experts=E,
        experts=bool(E) and E % m == 0, shared_d_ff=shared,
        shared=bool(shared) and shared % m == 0,
        vocab_padded=cfg.vocab_padded, vocab=cfg.vocab_padded % m == 0)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """Rank ``index`` of a ``model`` group of ``layout.m`` ranks
    (``group``; None: the world, or no world where only shapes are made):
    the slice of each leaf it holds (``slice_of``) and the whole sizes a
    column slice plans its product by."""

    layout: TPLayout
    index: int
    group: Any = None

    @property
    def m(self) -> int:
        return self.layout.m

    @property
    def kv_head(self) -> int:
        """This rank's first KV head."""
        lay = self.layout
        return (self.index * lay.kv_heads if lay.kv_share == 1
                else self.index // lay.kv_share)

    def slice_of(self, names: Sequence[str], shape: Sequence[int]
                 ) -> Optional[Tuple[int, int, int]]:
        """``(dim, start, length)`` of the leaf at ``names`` (the port's
        tree path, e.g. ``("layers", "mixer", "wq")``) that this rank
        holds, or None where it holds the leaf whole."""
        lay, r = self.layout, self.index
        name = names[-1] if names else ""
        nd = len(shape)
        hd = lay.head_dim
        if name == "embed" and nd == 2 and lay.vocab:
            n = shape[0] // lay.m
            return 0, r * n, n
        if name == "head" and nd == 2 and lay.vocab:
            n = shape[1] // lay.m
            return 1, r * n, n
        if "mixer" in names and lay.attn:
            q, kv = lay.q_heads * hd, lay.kv_heads * hd
            if name in ("wq", "bq"):
                return nd - 1, r * q, q
            if name in ("wk", "wv", "bk", "bv"):
                return nd - 1, self.kv_head * hd, kv
            if name == "wo":
                return 0, r * q, q
            return None
        if "moe" in names and "shared" not in names:
            if not lay.experts or name not in ("w_gate", "w_up", "w_down"):
                return None  # the router and norms replicate
            if nd == 3:  # [E, ., .]: the masters' layout and w_down
                n = shape[0] // lay.m
                return 0, r * n, n
            n = shape[1] // lay.m  # the flat [D, E * F] compute copy
            return 1, r * n, n
        split = lay.shared if "shared" in names else lay.mlp
        if split and ("mlp" in names or "shared" in names):
            if name in ("w_gate", "w_up"):
                n = shape[1] // lay.m
                return 1, r * n, n
            if name == "w_down":
                n = shape[0] // lay.m
                return 0, r * n, n
        return None

    # --- the step's collectives over the group (``dist.comm``)
    def join(self, partial: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The row-parallel join: every rank's float32 ``partial`` added in
        rank order (``comm.reduce_sum``), rounded once to ``dtype``."""
        from . import comm

        return comm.reduce_sum(partial, self.group).to(dtype)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """The rows of ``tokens`` from a vocab-parallel embedding (this
        rank's ``table`` rows): each rank looks up the tokens in its range,
        and each token's row is selected from its owner's part of a
        rank-ordered gather, never summed, so its bits are the whole
        table's row."""
        from . import comm

        rows = table.shape[0]
        t = tokens.long()
        own = (t - self.index * rows).clamp(0, rows - 1)
        parts = comm.gather(table[own][None], 0, self.group)  # [m, ..., D]
        owner = torch.div(t, rows, rounding_mode="floor").clamp(0, self.m - 1)
        at = owner[None, ..., None].expand(1, *t.shape, table.shape[1])
        return parts.gather(0, at)[0]

    def logits(self, local: torch.Tensor) -> torch.Tensor:
        """A vocab-parallel head's logits whole: every rank's columns
        gathered along the last dim in rank order."""
        from . import comm

        return comm.gather(local, local.dim() - 1, self.group)


def tensor_parallel(cfg, mesh: "RankMesh") -> Optional[TensorParallel]:
    """This rank's :class:`TensorParallel` of ``cfg`` over its ``model``
    group of the rank mesh; None where the group is one rank, which
    holds every leaf whole and has nothing to join (as ``seq_split``
    leaves its cache whole)."""
    m = int(mesh.shape.get(MODEL_AXIS, 1))
    if m == 1:
        return None
    return TensorParallel(tp_layout(cfg, m), mesh.axis_index(MODEL_AXIS)
                          if MODEL_AXIS in mesh.axis_names else 0,
                          mesh.model_group)


def tp_place(tree, tp: TensorParallel,
             device: Union[str, torch.device, None] = None, _path=()):
    """``tree`` (the port's params, compute copies or masters) with each
    leaf this rank's slice by ``tp.slice_of``, on ``device`` (None: where
    it is): a copy of the slice alone, so the whole leaf is not kept
    alive; a whole leaf already on ``device`` is the same tensor."""
    if isinstance(tree, dict):
        return {k: tp_place(v, tp, device, _path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tp_place(v, tp, device, _path) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    dev = tree.device if device is None else torch.device(device)
    cut = tp.slice_of(_path, tree.shape)
    if cut is None:
        return tree.to(dev)
    dim, start, n = cut
    return tree.narrow(dim, start, n).to(dev, copy=True).contiguous()


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
