"""Fits and samplers sharded over ranks of ``torch.distributed``: meshes,
placement and start-up (counterpart of :mod:`tame.parallel`)."""

from tame_torch.parallel.distributed import (
    global_mesh,
    initialize_distributed,
    measure_scaling_efficiency,
    measure_weak_scaling,
)
from tame_torch.parallel.mesh import (
    auto_mesh,
    chain_sharding,
    cov_sharding,
    make_mesh,
    obs_sharding,
    replicated,
    shard_fit_inputs,
    shard_smoothed_inputs,
    state_sharding,
)

__all__ = [
    "auto_mesh",
    "chain_sharding",
    "global_mesh",
    "initialize_distributed",
    "measure_scaling_efficiency",
    "measure_weak_scaling",
    "cov_sharding",
    "make_mesh",
    "obs_sharding",
    "replicated",
    "shard_fit_inputs",
    "shard_smoothed_inputs",
    "state_sharding",
]
