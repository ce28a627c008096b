"""IO (counterpart of :mod:`tame.io`): the native tensor store, checkpoint
/ resume, edge-list ingestion and the bundled karate-club data."""

from tame_torch.io.async_ckpt import AsyncCheckpointer
from tame_torch.io.checkpoint import load_checkpoint, save_checkpoint
from tame_torch.io.datasets import KarateClub, load_karate_club
from tame_torch.io.edgelist import (
    edgelist_to_tensors,
    load_edgelist_csv,
    tensors_to_edgelist,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "AsyncCheckpointer",
    "edgelist_to_tensors",
    "tensors_to_edgelist",
    "load_edgelist_csv",
    "KarateClub",
    "load_karate_club",
]
