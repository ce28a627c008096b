"""tame_torch — the temporal-AME inference engine on PyTorch and CUDA.

The port of :mod:`tame` (JAX on a TPU) to PyTorch on an NVIDIA H100.  Its
layout mirrors ``tame/`` (``config``, ``models``, ``ops``, ``inference``,
``io``, ``utils``, ``experiments``, ``visualization``, the command line
``cli`` with ``python -m tame_torch``, ``demo`` and the setup check
``quick_test``, and the scripts of the repo's root and ``scripts/`` under
``scripts``); it imports ``torch`` and numpy and never JAX.  Importing the
package imports neither ``experiments`` nor ``visualization`` (the plots
need matplotlib, imported only where a figure is drawn).  Tensors are float32 and
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
    EMResult,
    TemporalAMECaviVI,
    TemporalAMENaiveMFVI,
    TemporalAMESmoothedVI,
    TemporalAMEStructuredMFVI,
    em_update_params,
    exact_elbo,
    fit_cavi_smoothed,
    fit_em,
    warm_init_smoothed_state,
)
from tame_torch.models import (  # noqa: E402
    BaseAMEModel,
    StaticAMEModel,
    TemporalAMEModel,
)

__version__ = "0.1.0"

__all__ = [
    "ModelConfig",
    "InferenceConfig",
    "BaseAMEModel",
    "StaticAMEModel",
    "TemporalAMEModel",
    "TemporalAMECaviVI",
    "TemporalAMENaiveMFVI",
    "TemporalAMEStructuredMFVI",
    "TemporalAMESmoothedVI",
    "fit_cavi_smoothed",
    "warm_init_smoothed_state",
    "fit_em",
    "em_update_params",
    "EMResult",
    "exact_elbo",
]
