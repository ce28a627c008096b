"""Host-side utilities (counterpart of :mod:`tame.utils`)."""
