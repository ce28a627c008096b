"""Setup checker: the port's files, its imports and a 3-iteration fit
(counterpart of the JAX package's root ``quick_test.py``).

    python -m tame_torch.quick_test                 # the fit on the card
    python -m tame_torch.quick_test --device cpu    # without a card

Exits 1 if any check fails (each failure is printed with its traceback);
without a card and without ``--device cpu`` it raises before checking.
"""

import argparse
import importlib.util
import sys
import traceback
from pathlib import Path

REQUIRED = [
    "tame_torch/__init__.py",
    "tame_torch/config.py",
    "tame_torch/cli.py",
    "tame_torch/demo.py",
    "tame_torch/models/temporal_ame.py",
    "tame_torch/models/static_ame.py",
    "tame_torch/models/likelihoods.py",
    "tame_torch/inference/cavi.py",
    "tame_torch/inference/engine.py",
    "tame_torch/inference/smoothed.py",
    "tame_torch/inference/em.py",
    "tame_torch/inference/hmc.py",
    "tame_torch/inference/nuts.py",
    "tame_torch/inference/smc.py",
    "tame_torch/inference/binary_cavi.py",
    "tame_torch/inference/poisson_cavi.py",
    "tame_torch/inference/family_smoothed.py",
    "tame_torch/inference/evidence.py",
    "tame_torch/io/datasets.py",
    "tame_torch/io/cstore.cpp",
    "data/karate.csv",
    "tame_torch/ops/_ext.py",
    "tame_torch/ops/dyad.py",
    "tame_torch/ops/cholesky.py",
    "tame_torch/ops/fused_fit.py",
    "tame_torch/ops/fused_smoother.py",
    "tame_torch/csrc/binding.cpp",
    "tame_torch/csrc/spd.cu",
    "tame_torch/csrc/fused_fit.cu",
    "tame_torch/csrc/fused_smoother.cu",
    "tame_torch/csrc/masked_contract.cu",
    "tame_torch/csrc/dual_contract.cu",
    "tame_torch/csrc/eta_contract.cu",
    "tame_torch/utils/alignment.py",
    "tame_torch/utils/metrics.py",
    "tame_torch/utils/diagnostics.py",
    "tame_torch/visualization/__init__.py",
    "tame_torch/experiments/utils.py",
    "tame_torch/scripts/bench.py",
]


def _check(label: str, fn) -> bool:
    """Run one check; print OK or the failure with its traceback."""
    try:
        fn()
    except Exception:  # noqa: BLE001 -- the checker reports every failure
        print(f"  [FAIL] {label}:")
        traceback.print_exc(file=sys.stdout)
        return False
    print(f"  [OK] {label}")
    return True


def _imports() -> None:
    import tame_torch
    from tame_torch.models import StaticAMEModel, TemporalAMEModel  # noqa
    from tame_torch.inference import (  # noqa
        TemporalAMENaiveMFVI, TemporalAMEStructuredMFVI)
    from tame_torch.inference import fit_em  # noqa
    from tame_torch.inference import (  # noqa
        TemporalAMEBernoulliVI, TemporalAMEPoissonVI, fit_smoothed_family)
    from tame_torch.inference.evidence import exact_elbo  # noqa
    from tame_torch.io import edgelist_to_tensors, load_karate_club  # noqa
    from tame_torch.models import random_dyad_mask  # noqa
    from tame_torch import cli, utils  # noqa
    from tame_torch.experiments import utils as exp_utils  # noqa
    print(f"  tame_torch {tame_torch.__version__} imports cleanly")


def _visualization() -> None:
    from tame_torch import visualization  # noqa


def _smoke_fit(device: str) -> None:
    from tame_torch.inference import TemporalAMENaiveMFVI
    from tame_torch.models import TemporalAMEModel

    model = TemporalAMEModel(n_nodes=5, n_time=3, latent_dim=1, seed=0,
                             device=device)
    model.generate_data()
    vi = TemporalAMENaiveMFVI(model, learning_rate=0.5)
    h = vi.fit(max_iter=3, verbose=False)
    if len(h["elbo"]) != 3:
        raise RuntimeError(f"the fit ran {len(h['elbo'])} iterations, not 3")


def main(argv=None) -> int:
    from tame_torch.scripts._common import add_device_flag, resolve_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_flag(parser)
    device = resolve_device(parser.parse_args(argv).device).type
    root = Path(__file__).resolve().parents[1]
    ok = True

    print("Checking files...")
    for rel in REQUIRED:
        exists = (root / rel).exists()
        print(f"  [{'OK' if exists else 'MISSING'}] {rel}")
        ok &= exists

    print("\nChecking imports...")
    ok &= _check("tame_torch imports", _imports)
    if importlib.util.find_spec("matplotlib") is None:
        print("  [SKIP] tame_torch.visualization: matplotlib is not "
              "installed (figures need it)")
    else:
        ok &= _check("tame_torch.visualization imports", _visualization)

    print(f"\nSmoke test (tiny model, device={device})...")
    ok &= _check("3-iteration fit ran", lambda: _smoke_fit(device))

    print("\n" + ("All checks passed." if ok else "CHECKS FAILED."))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
