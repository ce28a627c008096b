"""Core tensor ops and the hand-written CUDA kernels (counterpart of
:mod:`tame.ops`)."""
