"""Variational inference engines (counterpart of :mod:`tame.inference`)."""

from tame_torch.inference import cavi
from tame_torch.inference.engine import (
    TemporalAMECaviVI,
    TemporalAMENaiveMFVI,
    TemporalAMEStructuredMFVI,
)

__all__ = [
    "cavi",
    "TemporalAMECaviVI",
    "TemporalAMENaiveMFVI",
    "TemporalAMEStructuredMFVI",
]
