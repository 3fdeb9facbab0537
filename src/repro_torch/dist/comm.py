"""The collectives of serving over ranks: a ``torch.distributed`` world, its
backend, and one fixed-order gather.

The JAX package has no such module: GSPMD inserts the collectives its
shardings need.  The port places a leaf on a mesh of ranks
(``dist.sharding.RankMesh``) and gathers what a step must see whole:

* :func:`init` starts the world from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
  arguments, always with a timeout, and gives each rank its device: a
  card of its own (``cuda:LOCAL_RANK``) when there are as many cards as
  ranks on the host, else the one card the ranks share, or the CPU;
* the backend follows from that placement before anything runs, and is
  printed: NCCL when each rank has its own card, gloo when the ranks run
  on the CPU or share one card.  A world that does not start, or a
  collective that fails, raises; nothing falls back to another backend
  and nothing is copied to the CPU around a collective;
* :func:`gather` concatenates every rank's slice of a tensor along one dim
  in rank order, bitwise the same on every rank (a gather copies, it
  never adds).  NCCL gathers into one buffer (``all_gather_into_tensor``,
  which a CUDA graph captures); gloo gathers with ``all_gather``, which
  takes a card's tensors too (gloo stages them through the host itself);
* :func:`reduce_sum` adds every rank's float32 tensor in rank order, the
  row-parallel join of tensor parallelism: a gather into one buffer, then
  ``parts[0] + parts[1] + ...`` elementwise, so every rank gets the same
  bits and a row's sum does not depend on the other rows (NCCL's
  ``all_reduce`` picks ring, tree or NVLS by the message's size, which
  would make a row's bits depend on the batch);
* :func:`new_groups` makes the groups of a mesh of ranks (one a data
  slice), every rank making every group in the same order;
* :class:`SharedClock` is one clock for the ranks of a group: one rank
  reads it and broadcasts the value, so that a decision taken from the
  time (a deadline, an eviction) is the same on every rank;
* :func:`exchange` gives every rank each rank's host object
  (``all_gather_object``), outside any CUDA graph capture.

``launches`` counts the gathers and sums issued since ``reset_counts``,
as the kernels' wrappers count their launches.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["TIMEOUT_S", "Placement", "choose_backend", "init", "shutdown",
           "active", "placement", "gather", "reduce_sum", "warm_up", "reset_counts",
           "launches", "new_groups", "SharedClock", "exchange"]

# every world waits this long at most for a peer, so a rank out of
# lockstep fails instead of hanging
TIMEOUT_S = 120.0

launches = 0  # gathers and sums issued since the last reset


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where this process serves: its rank, the world's size, its device
    and the backend that placement calls for."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    timeout_s: float = TIMEOUT_S


_PLACEMENT: Optional[Placement] = None


def choose_backend(device_type: str, ranks_on_host: int,
                   cards: int) -> Tuple[str, bool]:
    """``(backend, own_card)``: NCCL when each of the host's ranks has a
    card of its own, gloo when the ranks run on the CPU or share a card."""
    if device_type == "cpu":
        return "gloo", False
    if device_type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device_type!r}")
    if cards < 1:
        raise RuntimeError("CUDA is not available; run the ranks with "
                           "device='cpu'")
    own = ranks_on_host <= cards
    return ("nccl" if own else "gloo"), own


def _env_int(name: str, value: Optional[int]) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"no {name}: pass it, or start the process under "
                         "torchrun")
    return int(os.environ[name])


def init(device: Union[str, torch.device] = "cuda", *,
         rank: Optional[int] = None, world_size: Optional[int] = None,
         local_rank: Optional[int] = None,
         local_world_size: Optional[int] = None,
         init_method: Optional[str] = None,
         timeout_s: float = TIMEOUT_S, verbose: bool = True) -> Placement:
    """Join the world and return this rank's :class:`Placement`.

    Arguments left None come from torchrun's environment; ``init_method``
    defaults to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  ``device``
    is the device type the ranks run on.  Rank 0 prints the backend and
    why it was chosen."""
    global _PLACEMENT
    if _PLACEMENT is not None:
        raise RuntimeError(f"this process already serves as {_PLACEMENT}")
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              world_size))
    dtype = torch.device(device).type
    cards = torch.cuda.device_count() if dtype == "cuda" else 0
    backend, own = choose_backend(dtype, local_world_size, cards)
    if dtype == "cuda":
        dev = torch.device("cuda", local_rank if own else local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _PLACEMENT = Placement(rank, world_size, dev, backend, float(timeout_s))
    if verbose and rank == 0:
        why = ("each rank has a card of its own" if own else
               "the ranks share one card" if dtype == "cuda" else
               "the ranks run on the CPU")
        print(f"ranks: a world of {world_size} over {backend} ({why}); "
              f"rank 0 on {dev}", flush=True)
    return _PLACEMENT


def shutdown() -> None:
    """Leave the world (a no-op outside one).  The garbage is collected
    first: a CUDA graph that captured a collective holds its communicator,
    and NCCL waits for every such graph before it destroys one."""
    global _PLACEMENT
    if _PLACEMENT is not None:
        gc.collect()
        dist.destroy_process_group()
        _PLACEMENT = None


def active() -> bool:
    """Whether this process serves as a rank."""
    return _PLACEMENT is not None


def placement() -> Placement:
    if _PLACEMENT is None:
        raise RuntimeError("this process is not a rank: call comm.init "
                           "first")
    return _PLACEMENT


def reset_counts() -> None:
    global launches
    launches = 0


def warm_up(device: torch.device, group=None) -> None:
    """One collective outside any capture: NCCL builds its communicator
    at the first one, which a CUDA graph capture must not do."""
    t = torch.zeros(1, dtype=torch.int32, device=device)
    dist.all_reduce(t, group=group)


def _parts(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (of ``group``) in rank order, one collective:
    NCCL gathers into one buffer (``all_gather_into_tensor``, which a
    CUDA graph captures); gloo with ``all_gather``."""
    global launches
    launches += 1
    m = dist.get_world_size(group)
    t = t.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((m,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        return list(out.unbind(0))
    parts_ = [torch.empty_like(t) for _ in range(m)]
    dist.all_gather(parts_, t, group=group)
    return parts_


def gather(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (the
    ranks of ``group``), the same bits on every rank."""
    return torch.cat(_parts(t, group), dim=dim)


def reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's float32 ``t`` (of ``group``), added in rank
    order, ``((t_0 + t_1) + t_2) + ...`` elementwise: the same bits on
    every rank, and each element's independent of the tensor's shape."""
    if t.dtype != torch.float32:
        raise TypeError(f"reduce_sum adds float32 partials, got {t.dtype}")
    parts_ = _parts(t, group)
    if len(parts_) == 1:
        return parts_[0]
    out = parts_[0] + parts_[1]
    for p in parts_[2:]:
        out.add_(p)
    return out


def new_groups(rows: Sequence[Sequence[int]]) -> List[Any]:
    """One process group for each list of world ranks in ``rows``, in
    order.  ``new_group`` is collective over the world, so every rank makes
    every group, those it is not in too; a rank gets None for a group it is
    not in.  The groups keep the world's backend and timeout."""
    here = placement()
    timeout = datetime.timedelta(seconds=here.timeout_s)
    out = []
    for ranks in rows:
        ranks = [int(r) for r in ranks]
        g = dist.new_group(ranks=ranks, timeout=timeout)
        out.append(g if here.rank in ranks else None)
    return out


class SharedClock:
    """One clock for the ranks of ``group`` (None: the world): each call
    reads ``clock`` on world rank ``src`` alone and broadcasts the value
    (float64) over the group, so every rank takes a decision from the same
    time.  Every rank of the group calls it at the same points, the same
    number of times; a broadcast that fails raises."""

    def __init__(self, clock: Callable[[], float], group=None,
                 src: int = 0):
        here = placement()
        self.clock = clock
        self.group = group
        self.src = int(src)
        self._reads = here.rank == self.src
        # NCCL broadcasts a card's tensor; gloo the host's
        self._device = (here.device if dist.get_backend(group) == "nccl"
                        else torch.device("cpu"))

    def __call__(self) -> float:
        t = torch.empty(1, dtype=torch.float64, device=self._device)
        if self._reads:
            t.fill_(float(self.clock()))
        dist.broadcast(t, self.src, group=self.group)
        return float(t.item())


def exchange(obj: Any, group=None) -> list:
    """Every rank's ``obj`` in rank order (of ``group``), on every rank:
    ``all_gather_object``, a host-side exchange that syncs, so never inside
    a CUDA graph capture."""
    out: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
