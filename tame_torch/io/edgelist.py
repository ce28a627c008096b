"""Real-data ingestion: longitudinal dyadic edge lists -> model tensors
(counterpart of :mod:`tame.io.edgelist`; the parsing is host work in numpy,
the port's own copy).

Conventions: ``Y[i, j, t] = [y_ij^t, y_ji^t]``, zero diagonal, reciprocity
``Y[i, j, t, 1] == Y[j, i, t, 0]``.  A dyad {i, j} at time t is observed
only when BOTH directions are present in the records (the likelihood is
over the bivariate dyad); directed records without their reverse are
dropped and counted.  ``Y`` and the mask come back as float32 tensors on
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def edgelist_to_tensors(senders: Sequence, receivers: Sequence,
                        times: Sequence, values: Sequence,
                        n_nodes: Optional[int] = None,
                        n_time: Optional[int] = None,
                        node_ids: Optional[Sequence] = None,
                        device="cuda",
                        ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Convert directed longitudinal records to ``(Y, mask, info)``.

    ``senders``/``receivers`` are node labels (any hashable; mapped to
    indices in first-appearance order unless ``node_ids`` fixes the
    ordering), ``times`` integer time indices in ``[0, n_time)``,
    ``values`` the directed weights.  Returns ``Y`` (n, n, T, 2) with
    unobserved entries 0, the symmetric observation ``mask`` (n, n, T) for
    the engines' ``mask=``, and ``info`` with ``index_of`` (label -> row),
    ``n_dropped_oneway`` and ``n_duplicates`` (later records overwrite
    earlier ones).
    """
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    times = np.asarray(times, dtype=np.int64)
    values = np.asarray(values, dtype=np.float32)
    if not (len(senders) == len(receivers) == len(times) == len(values)):
        raise ValueError("senders/receivers/times/values lengths differ")

    if node_ids is None:
        labels = list(dict.fromkeys(
            list(senders.tolist()) + list(receivers.tolist())))
    else:
        labels = list(node_ids)
    index_of = {lab: i for i, lab in enumerate(labels)}
    n = n_nodes if n_nodes is not None else len(labels)
    if len(labels) > n:
        raise ValueError(f"{len(labels)} distinct nodes > n_nodes={n}")
    T = n_time if n_time is not None else (int(times.max()) + 1
                                           if len(times) else 0)
    if len(times) and (times.min() < 0 or times.max() >= T):
        raise ValueError(f"times outside [0, {T})")

    si = np.array([index_of[s] for s in senders.tolist()], dtype=np.int64)
    ri = np.array([index_of[r] for r in receivers.tolist()], dtype=np.int64)
    if np.any(si == ri):
        raise ValueError("self-loops are not part of the AME model")

    directed = np.zeros((n, n, T), dtype=np.float32)
    seen = np.zeros((n, n, T), dtype=bool)
    # Keep the LAST of duplicate (sender, receiver, time) records
    # explicitly: the winner of a repeated fancy-index assignment is not
    # specified.
    lin = (si * n + ri) * T + times
    _, first_of_reversed = np.unique(lin[::-1], return_index=True)
    keep = len(lin) - 1 - first_of_reversed
    n_duplicates = len(lin) - len(keep)
    directed[si[keep], ri[keep], times[keep]] = values[keep]
    seen[si[keep], ri[keep], times[keep]] = True

    both = seen & np.swapaxes(seen, 0, 1)
    n_dropped = int((seen & ~both).sum())
    Y = np.zeros((n, n, T, 2), dtype=np.float32)
    Y[..., 0] = np.where(both, directed, 0.0)
    Y[..., 1] = np.where(both, np.swapaxes(directed, 0, 1), 0.0)
    return (torch.from_numpy(Y).to(device),
            torch.from_numpy(both.astype(np.float32)).to(device),
            {"index_of": index_of, "n_dropped_oneway": n_dropped,
             "n_duplicates": n_duplicates})


def tensors_to_edgelist(Y, mask=None) -> Tuple[torch.Tensor, ...]:
    """Inverse of :func:`edgelist_to_tensors`: directed records
    ``(senders, receivers, times, values)`` for every observed dyad
    direction (every off-diagonal entry without a mask), on ``Y``'s
    device."""
    Y = torch.as_tensor(Y)
    n, _, T, _ = Y.shape
    if mask is None:
        mask = (1.0 - torch.eye(n, device=Y.device))[:, :, None].expand(
            n, n, T)
    i, j, t = torch.nonzero(torch.as_tensor(mask, device=Y.device) > 0,
                            as_tuple=True)
    return i, j, t, Y[i, j, t, 0]


def load_edgelist_csv(path, *, sender_col: int = 0, receiver_col: int = 1,
                      time_col: int = 2, value_col: int = 3,
                      delimiter: str = ",", skip_header: int = 1,
                      **kwargs) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Read a CSV of directed records and convert via
    :func:`edgelist_to_tensors` (kwargs, ``device`` included, forwarded)."""
    rows = np.genfromtxt(path, delimiter=delimiter,
                         skip_header=skip_header, dtype=str)
    if rows.ndim == 1:
        rows = rows[None]
    return edgelist_to_tensors(
        rows[:, sender_col], rows[:, receiver_col],
        rows[:, time_col].astype(float).astype(int),
        rows[:, value_col].astype(float), **kwargs)
