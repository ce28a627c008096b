"""Bundled real datasets (counterpart of :mod:`tame.io.datasets`).

**Zachary's karate club** (Zachary, W. W., 1977, "An Information Flow
Model for Conflict and Fission in Small Groups", Journal of
Anthropological Research 33, 452-473): 34 members of a university karate
club, edge weights the number of social contexts in which two members
interacted, and the observed post-split factions ("Mr. Hi" vs
"Officer").  The data are the repository's ``data/karate.csv`` and
``data/karate_factions.csv``.  The network is undirected, so both
directions of each dyad carry the same count.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

_DATA_DIR = Path(__file__).resolve().parents[2] / "data"


class KarateClub(NamedTuple):
    Y: torch.Tensor         # (34, 34, 1, 2) reciprocal count tensor
    factions: torch.Tensor  # (34,) bool: True = "Mr. Hi", False = "Officer"
    n_nodes: int


def load_karate_club(data_dir=None, device="cuda") -> KarateClub:
    """Load the bundled karate-club network as the dyad tensor on
    ``device`` (the card unless the caller asks for the CPU).  Absent
    dyads are genuine zero counts: the whole off-diagonal is observed."""
    d = Path(data_dir) if data_dir is not None else _DATA_DIR
    obs = {}
    with open(d / "karate.csv") as f:
        for row in csv.DictReader(f):
            obs[(int(row["sender"]), int(row["receiver"]))] = \
                float(row["weight"])
    n = 1 + max(max(i, j) for i, j in obs)
    Y = np.zeros((n, n, 1, 2), np.float32)
    for (i, j), w in obs.items():
        if i != j:
            Y[i, j, 0, 0] = w
            Y[j, i, 0, 1] = w
    factions = np.zeros(n, bool)
    with open(d / "karate_factions.csv") as f:
        for row in csv.DictReader(f):
            factions[int(row["node"])] = row["club"] == "Mr. Hi"
    return KarateClub(Y=torch.from_numpy(Y).to(device),
                      factions=torch.from_numpy(factions).to(device),
                      n_nodes=n)
