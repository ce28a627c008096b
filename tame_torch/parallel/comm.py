"""The mesh's collectives: the one module of the port that calls
``torch.distributed``.

Backends: NCCL for CUDA tensors with one rank per card, gloo for CPU
tensors.  Gloo with CUDA tensors stages every collective through host
memory; it serves ranks that share one card (NCCL will not put two ranks
of one communicator on the same GPU) and is used only when the caller
names ``backend="gloo"``.  Nothing falls back: a failed NCCL init raises.

Every collective is counted by kind on the :class:`Collectives` object of
its mesh (``calls`` and ``bytes``), which ``comm_analysis`` and the
scripts read.  The bytes of a collective are those of its result: the
gathered tensor of an all-gather (padded pieces included), the tensor of
an all-reduce or a broadcast.
"""

from __future__ import annotations

import collections
import datetime
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def init_world(backend: str, rank: int, world_size: int, *, store=None,
               init_method: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Initialise the default process group of ``world_size`` ranks from a
    store (a ``FileStore``, say) or an ``init_method`` URL."""
    dist.init_process_group(backend, store=store, init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=timeout)


def init_single(backend: str) -> None:
    """A default process group of this process alone, on an in-memory
    store: no file, no port."""
    init_world(backend, 0, 1, store=dist.HashStore())


def file_store(path: str, world_size: int):
    return dist.FileStore(path, world_size)


def new_group(ranks: Sequence[int], backend: str):
    """A process group of ``ranks``; every rank of the world must call
    this, in the same order, for every group."""
    return dist.new_group(list(ranks), backend=backend)


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


class Collectives:
    """Padded all-gather, all-reduce and broadcast on the process groups of
    one mesh, named by axis (``"batch"``, ``"nodes"``, ``"time"``, and
    ``"mesh"`` for all of its ranks), with counts by kind."""

    def __init__(self, groups: Dict[str, object],
                 members: Dict[str, List[int]], backend: str,
                 device: torch.device):
        self.groups = groups      # axis -> this rank's group on it
        self.members = members    # axis -> the global ranks of that group
        self.backend = backend
        self.device = device
        # gloo reads host memory: stage CUDA tensors through it
        self.staged = backend == "gloo" and device.type == "cuda"
        self.calls: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()

    def stats(self) -> Dict[str, Dict[str, int]]:
        """``{kind: {"count": calls, "bytes": bytes}}`` so far."""
        return {k: {"count": self.calls[k], "bytes": self.bytes[k]}
                for k in self.calls}

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def _count(self, kind: str, t: torch.Tensor, copies: int = 1) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += copies * t.numel() * t.element_size()

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t.contiguous()

    def all_gather(self, x: torch.Tensor, axis: str,
                   shape: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Every member's ``x``, stacked in the group's rank order: (members,
        *x.shape).  ``shape`` pads ``x`` with zeros to a shape that every
        member shares (the members gather equal sizes); the caller trims
        each piece."""
        if shape is not None and tuple(x.shape) != tuple(shape):
            pad = x.new_zeros(shape)
            pad[tuple(slice(0, s) for s in x.shape)] = x
            x = pad
        x = self._in(x)
        out = x.new_empty(len(self.members[axis]) * x.numel())
        dist.all_gather_into_tensor(out, x.reshape(-1),
                                    group=self.groups[axis])
        self._count("all_gather", out)
        return self._out(out).view((-1,) + tuple(x.shape))

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of every member's ``x``; ``x`` is left as it was."""
        y = self._in(x)
        if y is x:
            y = x.clone()
        dist.all_reduce(y, group=self.groups[axis])
        self._count("all_reduce", y)
        return self._out(y)

    def broadcast(self, x: torch.Tensor, axis: str,
                  src: int = 0) -> torch.Tensor:
        """Member ``src``'s (group order) ``x`` on every member."""
        y = self._in(x)
        if y is x:
            y = x.clone()
        dist.broadcast(y, src=self.members[axis][src],
                       group=self.groups[axis])
        self._count("broadcast", y)
        return self._out(y)
