"""Meshes of ranks and explicit placement (counterpart of
:mod:`tame.parallel.mesh`).

A mesh arranges ranks of ``torch.distributed`` on the axes ``(batch,
nodes, time)``, keeping axes of size 1, with one process group per axis
and one over the whole mesh (:class:`~tame_torch.parallel.comm.Collectives`).
Each rank computes on its own device: its card (NCCL), the shared card
(gloo, staged through host memory) or the CPU (gloo).

* ``nodes`` splits the node axis n.  Rows go to ranks cyclically (row i on
  rank ``i % nodes``), so every node block of the block Gauss-Seidel sweep
  is spread over all ``nodes`` ranks, its shares differing by one row at
  most.  A rank holds its rows of the dyad weights; node i's update reads
  only row i of them and statistics of the means.
* ``time`` splits the AR(1) time axis T into contiguous chunks.
* ``batch`` splits HMC/NUTS chains and SMC particles into contiguous
  chunks.

JAX places global arrays and lets GSPMD partition the program; here the
placement is explicit.  :func:`shard_fit_inputs` returns :class:`Sharded`
values holding this rank's pieces, which the fit entry points recognise
and send to the sharded engines (:mod:`tame_torch.parallel.sharded_cavi`,
:mod:`tame_torch.parallel.sharded_family`); the warm inits, the ELBOs and
EM take them too (:mod:`tame_torch.parallel.sharded_init`,
:mod:`tame_torch.parallel.sharded_em`).
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from tame_torch.parallel import comm

AXES = ("batch", "nodes", "time")


class Mesh:
    """Ranks on the axes ``(batch, nodes, time)``: ``shape`` (axis ->
    size), ``ranks`` (the global ranks, an array of that shape), this
    rank's ``coord`` (axis -> index; None outside the mesh), its
    ``device``, the ``backend`` and the collectives ``comm``."""

    def __init__(self, ranks: np.ndarray, device: torch.device, backend: str,
                 collectives: comm.Collectives):
        self.ranks = ranks
        self.shape = dict(zip(AXES, ranks.shape))
        self.device = device
        self.backend = backend
        self.comm = collectives
        where = np.argwhere(ranks == comm.rank())
        self.coord = (dict(zip(AXES, map(int, where[0]))) if len(where)
                      else None)
        # the whole-mesh group orders its members by global rank
        self._by_group_rank = [dict(zip(AXES, map(int, np.argwhere(
            ranks == r)[0]))) for r in sorted(ranks.ravel().tolist())]

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def member(self) -> bool:
        return self.coord is not None

    def coord_of(self, group_rank: int) -> Dict[str, int]:
        """The coordinates of the whole-mesh group's member ``group_rank``
        (the order of :meth:`Collectives.all_gather` on ``"mesh"``)."""
        return self._by_group_rank[group_rank]

    def axis_index(self, axis: str, group_rank: int) -> int:
        """The index on ``axis`` of member ``group_rank`` of this rank's
        group on ``axis`` (the order of its all-gathers)."""
        member = self.comm.members[axis][group_rank]
        return int(np.argwhere(self.ranks == member)[0][AXES.index(axis)])

    def piece(self, axis: str, size: int, index: Optional[int] = None
              ) -> slice:
        """The slice of a dimension of length ``size`` split over ``axis``
        that rank ``index`` on it holds (this rank's by default)."""
        if index is None:
            index = self.coord[axis]
        return axis_slice(axis, size, self.shape[axis], index)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, ranks={self.ranks.ravel().tolist()}, "
                f"device={self.device}, backend={self.backend})")


def axis_slice(axis: str, size: int, parts: int, index: int) -> slice:
    """Piece ``index`` of ``parts`` of a dimension of length ``size``:
    cyclic on ``nodes`` (``index::parts``), contiguous chunks otherwise
    (the first ``size % parts`` one longer)."""
    if axis == "nodes":
        return slice(index, size, parts)
    q, rem = divmod(size, parts)
    lo = index * q + min(index, rem)
    return slice(lo, lo + q + (1 if index < rem else 0))


def slice_len(s: slice, size: int) -> int:
    return len(range(*s.indices(size)))


def _default_device(device) -> torch.device:
    """This rank's device: the given one, else its card (``LOCAL_RANK``,
    or the global rank modulo the cards); ``"cuda"`` without an index
    resolves the same way."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh needs a CUDA device for its ranks; "
                           "pass device='cpu' to compute on the CPU")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else comm.rank()
    return torch.device("cuda", index % torch.cuda.device_count())


def _backend(backend: Optional[str], device: torch.device) -> str:
    if backend is None:
        return "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend 'nccl' needs a CUDA device")
    return backend


def make_mesh(nodes: int = 1, time: int = 1, batch: int = 1,
              devices: Optional[Sequence[int]] = None, *, device=None,
              backend: Optional[str] = None) -> Mesh:
    """Build a mesh with axes ``(batch, nodes, time)`` over ``devices``
    (global ranks; the first ``nodes * time * batch`` of the world by
    default).  Every rank of the world calls it, members or not: it
    creates the process groups.

    ``device`` is this rank's device (its card by default, ``"cpu"`` to
    compute on the CPU); ``backend`` NCCL on a card, gloo on the CPU, or
    gloo named for ranks that share a card.  With no process group and a
    mesh of one rank it starts a one-rank group on an in-memory store, so
    ``make_mesh()`` works in a single process."""
    needed = nodes * time * batch
    dev = _default_device(device)
    backend = _backend(backend, dev)
    if not comm.is_initialized():
        if needed != 1:
            raise ValueError(f"mesh {batch}x{nodes}x{time} needs {needed} "
                             f"devices, have 1")
        comm.init_single(backend)
    ranks = (list(range(comm.world_size())) if devices is None
             else [int(r) for r in devices])
    if needed > len(ranks):
        raise ValueError(f"mesh {batch}x{nodes}x{time} needs {needed} "
                         f"devices, have {len(ranks)}")
    grid = np.asarray(ranks[:needed]).reshape(batch, nodes, time)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    me = comm.rank()
    groups, members = {}, {}
    for ax, axis in enumerate(AXES):
        others = [range(s) for i, s in enumerate(grid.shape) if i != ax]
        for idx in itertools.product(*others):
            sel = list(idx)
            sel.insert(ax, slice(None))
            line = sorted(grid[tuple(sel)].tolist())
            group = comm.new_group(line, backend)
            if me in line:
                groups[axis], members[axis] = group, line
    everyone = sorted(grid.ravel().tolist())
    group = comm.new_group(everyone, backend)
    if me in everyone:
        groups["mesh"], members["mesh"] = group, everyone
    return Mesh(grid, dev, backend,
                comm.Collectives(groups, members, backend, dev))


def auto_mesh(n_devices: Optional[int] = None, **kw) -> Mesh:
    """Factor the ranks into a (nodes, time) mesh: time gets 2 when the
    count is even and at least 4, nodes the rest."""
    if n_devices is None:
        n_devices = comm.world_size()
    time = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return make_mesh(nodes=n_devices // time, time=time, **kw)


# ---------------------------------------------------------------------------
# Placement specs
# ---------------------------------------------------------------------------

class Sharding(NamedTuple):
    """Where a tensor lives on a mesh: ``spec[k]`` names the mesh axis that
    dimension k is split over (None: whole on every rank)."""

    mesh: Mesh
    spec: tuple


def state_sharding(mesh: Mesh) -> Sharding:
    """Latent-state tensors (n, T, d): nodes x time."""
    return Sharding(mesh, ("nodes", "time", None))


def cov_sharding(mesh: Mesh) -> Sharding:
    """Covariance tensors (n, T, d, d)."""
    return Sharding(mesh, ("nodes", "time", None, None))


def obs_sharding(mesh: Mesh) -> Sharding:
    """The observation tensor (n, n, T, 2): rows over ``nodes`` (a rank
    holds its nodes' dyads, both directions, by reciprocity), time over
    ``time``; the partner axis whole, so each row's contraction against
    the means is local."""
    return Sharding(mesh, ("nodes", None, "time", None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def chain_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Per-chain or per-particle tensors with a leading chains axis:
    chains over ``batch``, the rest whole.  Chains are independent; SMC's
    weights and resampling gather over the axis."""
    return Sharding(mesh, ("batch",) + (None,) * (ndim - 1))


# ---------------------------------------------------------------------------
# Sharded values
# ---------------------------------------------------------------------------

class Sharded(NamedTuple):
    """A value split over a mesh: ``local`` is this rank's piece (a
    tensor, or a NamedTuple whose split fields hold pieces), ``sizes`` the
    global length of each split axis, ``spec`` the placement (a per-dim
    axis tuple for a tensor, ``{field: spec}`` for a NamedTuple).

    Other attributes read through to ``local``: a sharded fit result's
    ``elbo_history``, ``n_iter`` or ``converged`` are the same on every
    rank.  :meth:`full` gathers the whole value; every rank of the mesh
    must call it."""

    local: object
    mesh: Mesh
    sizes: dict
    spec: object

    def __getattr__(self, name):
        return getattr(self.local, name)

    def field(self, name: str) -> "Sharded":
        """The sharded value of one field of a sharded NamedTuple: a
        sharded fit result's ``state``, say, which ``result.state`` reads
        as this rank's pieces alone."""
        return Sharded(getattr(self.local, name), self.mesh, self.sizes,
                       self.spec[name])

    def full(self):
        return _gather_tree(self.mesh, self.local, self.spec, self.sizes)


def _gather_tree(mesh: Mesh, value, spec, sizes: dict):
    if isinstance(spec, dict):
        return value._replace(**{
            name: _gather_tree(mesh, getattr(value, name), sub, sizes)
            for name, sub in spec.items()})
    return gather(mesh, value, spec, sizes)


def gather(mesh: Mesh, x: torch.Tensor, spec: tuple,
           sizes: dict) -> torch.Tensor:
    """The whole tensor of which every rank holds the piece ``x`` placed by
    ``spec``: one padded all-gather over the mesh."""
    if not any(spec):
        return x
    full = [sizes[a] if a else x.shape[k] for k, a in enumerate(spec)]
    pad = [-(-sizes[a] // mesh.shape[a]) if a else x.shape[k]
           for k, a in enumerate(spec)]
    out = x.new_empty(full)
    for g, piece in enumerate(mesh.comm.all_gather(x, "mesh", pad)):
        coord = mesh.coord_of(g)
        idx = tuple(mesh.piece(a, sizes[a], coord[a]) if a else slice(None)
                    for a in spec)
        out[idx] = piece[tuple(slice(0, slice_len(s, n))
                               for s, n in zip(idx, full))]
    return out


def _fit_mesh(mesh: Mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a tame_torch.parallel mesh, got "
                        f"{type(mesh).__name__}")
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    if mesh.shape["batch"] != 1:
        raise ValueError("fits shard over 'nodes' and 'time'; build the "
                         "mesh with batch=1")


def _place(x, mesh: Mesh, idx: tuple) -> torch.Tensor:
    """This rank's piece of a host or device array: sliced before it moves
    to the rank's device, so no rank holds the whole array there."""
    t = torch.as_tensor(x)
    return t[idx].contiguous().to(mesh.device, torch.float32)


def place_mask(Y: Sharded, mask) -> torch.Tensor:
    """This rank's piece of a whole (n, n, T) observation mask (a host or
    device array; 1 = observed, symmetric), indexed as ``Y``'s piece:
    its rows and time slice, every partner.  Sliced before it moves to
    the rank's device, so no rank holds the whole mask there.  The
    entries of the rank's own dyads (i, i) are zeroed: the rows are not
    the first of the network, so the diagonal is where a row's id meets
    the partner's."""
    n, T = Y.sizes["nodes"], Y.sizes["time"]
    rows = Y.mesh.piece("nodes", n)
    ts = Y.mesh.piece("time", T) if Y.spec[2] == "time" else slice(None)
    m = _place(mask, Y.mesh, (rows, slice(None), ts))
    ids = torch.arange(n, device=m.device)
    off = (ids[rows][:, None] != ids[None, :]).to(m.dtype)
    return m * off[:, :, None]


def shard_fit_inputs(mesh: Mesh, Y, state=None):
    """Place CAVI (and Bernoulli, Poisson) fit inputs on the mesh:
    ``(Y_s, state_s)``, this rank's rows and time slice of ``Y`` (n, n, T,
    2) and of the state's ``X_mean``/``X_cov``, on this rank's device.
    ``fit_cavi``, ``fit_cavi_bernoulli`` and ``fit_cavi_poisson`` take
    them in place of tensors and run sharded.  Without a ``state``,
    ``state_s`` is None: ``cavi.warm_init_state(Y_s, params)`` makes one
    placed so, from each rank's rows alone."""
    from tame_torch.inference.cavi import CaviState

    _fit_mesh(mesh)
    n, _, T = Y.shape[:3]
    sizes = {"nodes": n, "time": T}
    rows, ts = mesh.piece("nodes", n), mesh.piece("time", T)
    Y_s = Sharded(_place(Y, mesh, (rows, slice(None), ts)), mesh, sizes,
                  obs_sharding(mesh).spec)
    if state is None:
        return Y_s, None
    local = CaviState(X_mean=_place(state.X_mean, mesh, (rows, ts)),
                      X_cov=_place(state.X_cov, mesh, (rows, ts)))
    spec = {"X_mean": state_sharding(mesh).spec,
            "X_cov": cov_sharding(mesh).spec}
    return Y_s, Sharded(local, mesh, sizes, spec)


def shard_smoothed_inputs(mesh: Mesh, Y, state=None):
    """Place smoothed-engine fit inputs on the mesh.  A node's update is a
    block-tridiagonal solve over its whole trajectory, so the smoothed
    family shards over ``nodes`` only: the observation rows and every
    per-node state tensor split on the node axis, time whole.  Without a
    ``state`` the second value is None (the warm inits make one from
    ``Y_s``)."""
    _fit_mesh(mesh)
    if mesh.shape["time"] != 1:
        raise ValueError(
            "the smoothed engine shards over 'nodes' only; build the mesh "
            "with time=1")
    n = Y.shape[0]
    sizes = {"nodes": n, "time": Y.shape[2]}
    Y_s = Sharded(_place(Y, mesh, (mesh.piece("nodes", n),)), mesh, sizes,
                  ("nodes", None, None, None))
    return Y_s, (None if state is None
                 else place_smoothed_state(mesh, state, sizes))


def smoothed_spec(state) -> dict:
    """The placement of a smoothed state's pieces: every field split on
    its node axis."""
    return {f: ("nodes",) + (None,) * (getattr(state, f).dim() - 1)
            for f in state._fields}


def place_smoothed_state(mesh: Mesh, state, sizes: dict) -> Sharded:
    """This rank's rows of a whole smoothed state (``SmoothedState``, on
    the host or a device) as :func:`shard_smoothed_inputs` places them."""
    from tame_torch.inference.smoothed import SmoothedState

    rows = (mesh.piece("nodes", sizes["nodes"]),)
    local = SmoothedState(*(_place(getattr(state, f), mesh, rows)
                            for f in SmoothedState._fields))
    return Sharded(local, mesh, sizes, smoothed_spec(local))


# ---------------------------------------------------------------------------
# Chains over the batch axis
# ---------------------------------------------------------------------------

class ChainShard(NamedTuple):
    """This rank's chains ``[lo, hi)`` of ``total`` on the mesh's ``batch``
    axis.  Draws are made for the whole batch and sliced (:meth:`draw`),
    so each chain sees the numbers it sees unsharded."""

    mesh: Mesh
    total: int
    lo: int
    hi: int

    def draw(self, fn, shape, **kw) -> torch.Tensor:
        """``fn((total,) + shape[1:], **kw)`` sliced to this rank's
        chains."""
        return fn((self.total,) + tuple(shape[1:]), **kw)[self.lo:self.hi]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's chains of ``x`` (leading axis), in chain order."""
        return self.mesh.comm.all_gather(x, "batch").flatten(0, 1)

    def wrap(self, result, fields: Sequence[str]) -> Sharded:
        """A result whose ``fields`` hold this rank's chains, as a
        :class:`Sharded` value."""
        spec = {f: ("batch",) + (None,) * (getattr(result, f).dim() - 1)
                for f in fields}
        return Sharded(result, self.mesh, {"batch": self.total}, spec)


def chain_shard(mesh, total: int) -> ChainShard:
    """The chains of a sampler's ``mesh=``: ``total`` split over the batch
    axis, which must divide it; nodes and time of size 1."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a tame_torch.parallel mesh, got "
                        f"{type(mesh).__name__}")
    if not mesh.member:
        raise ValueError("this rank is not in the mesh")
    if mesh.shape["nodes"] * mesh.shape["time"] != 1:
        raise ValueError("samplers shard chains over 'batch'; build the "
                         "mesh with nodes=1 and time=1")
    if total % mesh.shape["batch"]:
        raise ValueError(f"{total} chains do not split over a batch axis "
                         f"of {mesh.shape['batch']}")
    s = mesh.piece("batch", total)
    return ChainShard(mesh, total, s.start, s.stop)
