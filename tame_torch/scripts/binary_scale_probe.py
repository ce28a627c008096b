"""The JJ-bound binary engine at scale: ``fit_cavi_bernoulli`` at n=1000,
T=20, r=2 (port of ``scripts/binary_scale_probe.py``).

    python -m tame_torch.scripts.binary_scale_probe [--n 1000 --T 20 --r 2]
    python -m tame_torch.scripts.binary_scale_probe --device cpu --n 12 \\
        --T 3 --r 1 --short 2 --long 3

Data from ``ModelConfig(seed=0)`` with ``family="bernoulli"``, random inits
at lr 0.8 with tolerance 0: ms/iteration by the slope of an 8- and a
40-iteration fit (host clock ending in a synchronize), the correlation of
the fitted log-odds with the generating ones, the tie accuracy, and
``torch.profiler`` over 3 iterations (device time by kernel kind and the
device's idle share).  The JJ weights change every iteration, so an
iteration is O(n^2 T) moment and contraction work plus one K1 launch (the
n T solves) and one K2 launch (the entropy).
"""

from __future__ import annotations

from typing import Optional, Sequence

from tame_torch.scripts import _common


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return _common.family_scale_probe("bernoulli", argv, lr=0.8)


if __name__ == "__main__":
    main()
