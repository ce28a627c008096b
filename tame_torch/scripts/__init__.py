"""Measurement scripts of the port (counterparts of the JAX package's
``bench.py`` and ``scripts/*.py``).

Each module has a ``main(argv=None)`` that returns its results as a dict
and runs with ``python -m tame_torch.scripts.<name>``: on the card unless
``--device cpu`` is given (for the CPU tests, at sizes set by the flags).
Nothing runs at import.
"""
