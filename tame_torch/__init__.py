"""tame_torch — the temporal-AME inference engine on PyTorch and CUDA.

The port of :mod:`tame` (JAX on a TPU) to PyTorch on an NVIDIA H100.  Its
layout mirrors ``tame/`` (``config``, ``models``, ``ops``, ``inference``);
it imports ``torch`` and numpy and never JAX.  Tensors are float32 and
carry their own device; randomness comes from explicit
``torch.Generator`` objects.  The hand-written Hopper kernels
(``csrc/``) are built lazily at first use on a CUDA tensor; CPU tensors
take each kernel's plain PyTorch twin.

Quick start
-----------
>>> from tame_torch import TemporalAMEModel, TemporalAMEStructuredMFVI
>>> model = TemporalAMEModel(n_nodes=15, n_time=10, latent_dim=2)
>>> Y = model.generate_data(device="cuda")
>>> vi = TemporalAMEStructuredMFVI(model, factorization="good",
...                                learning_rate=0.7)
>>> history = vi.fit(max_iter=150, verbose=False)
"""

import torch

# Full float32 matrix products, the counterpart of the JAX package's
# Precision.HIGHEST pin: TF32 keeps ~3 decimal digits, too few for the
# data-sized sums of the CAVI statistics.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from tame_torch.config import InferenceConfig, ModelConfig  # noqa: E402
from tame_torch.inference import (  # noqa: E402
    TemporalAMECaviVI,
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)
from tame_torch.models import BaseAMEModel, TemporalAMEModel  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ModelConfig",
    "InferenceConfig",
    "BaseAMEModel",
    "TemporalAMEModel",
    "TemporalAMECaviVI",
    "TemporalAMENaiveMFVI",
    "TemporalAMEStructuredMFVI",
]
