"""The guarded Poisson CVI engine at scale: ``fit_cavi_poisson`` at
n=1000, T=20, r=2 (port of ``scripts/poisson_scale_probe.py``).

    python -m tame_torch.scripts.poisson_scale_probe [--n 1000 --T 20 --r 2]
    python -m tame_torch.scripts.poisson_scale_probe --device cpu --n 12 \\
        --T 3 --r 1 --short 2 --long 3

Data from ``ModelConfig(seed=0)`` with ``family="poisson"``, random inits
at lr 0.7 with tolerance 0: ms/iteration by the slope of an 8- and a
40-iteration fit (host clock ending in a synchronize), whether the guard
diverged, its final step scale and rejected iterations (each costs one
extra moment pass), the correlation of the fitted log-rates with the
generating ones, the mean deviance, and ``torch.profiler`` over 3
iterations (device time by kernel kind and the device's idle share).
"""

from __future__ import annotations

from typing import Optional, Sequence

from tame_torch.scripts import _common


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return _common.family_scale_probe("poisson", argv, lr=0.7)


if __name__ == "__main__":
    main()
