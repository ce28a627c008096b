"""The one traffic generator: a closed loop of whole fits, one caller, as a
user's script runs them, driven by a traffic file's parameters.

Traffic file keys:

* ``kind``: the kind of fit, whose engine ``tbench/traffic/<kind>.py``
  builds (``smf_fits``, ``smoothed_fits``);
* ``init``: ``"random"`` (the engine's ``seed`` drawn per fit from the run's
  seed and the fit's index) or ``"warm"`` (the engine's data-driven start);
* ``corrected``: the engine's ``corrected`` keyword;
* ``pool``: networks drawn in set-up; fit k takes network k mod pool;
* ``draw_batch``: networks drawn per generator call;
* ``mask_frac``: the share of dyads hidden in each network (0: no mask);
* ``warmup_fits`` and ``warmup_iters``: set-up's fits, and their budget
  (null: the configuration's ``max_iter``);
* ``trace_fits``: fits under the profiler in a traced run.

The configuration file gives the model (``model``) and the fit's settings
(``fit``: learning rate, tolerance, ``max_iter``, update mode, precision,
diagnostics, block count).  Each fit builds its engine anew through the
public entry point on the model whose ``Y`` is the benchmark's network,
runs ``fit`` to the stop and waits for the device.  The program's model
has to hold every number of the configuration's ``model`` group, and its
matrix products the TF32 setting of the ``fit`` group, or the stream
refuses to start.
"""

from __future__ import annotations

import math
import time
from contextlib import nullcontext
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from tbench import datagen, spec
from tbench.reference.model import build_params

# Kernel launch counters of the program: (name, module, function).
COUNTERS = (("K1", "tame_torch.ops.cholesky", "spd_solve_inv_kernel"),
            ("K2", "tame_torch.ops.cholesky", "logdet_spd_kernel"),
            ("K3", "tame_torch.ops.fused_fit", "fused_fit_kernel"),
            ("K4", "tame_torch.ops.fused_smoother", "fused_smoother_kernel"),
            ("K5", "tame_torch.ops.masked_contract",
             "packed_rows_contract_kernel"))


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed from the run's seed and integer tags."""
    ss = np.random.SeedSequence([seed % 2**64, *tags])
    hi, lo = (int(v) for v in ss.generate_state(2, np.uint32))
    return (hi << 31) | (lo >> 1)


def launch_counts() -> dict:
    """The program's kernel launch counters as they stand (None for one
    that is gone)."""
    import importlib

    out = {}
    for name, module, fn in COUNTERS:
        try:
            out[name] = getattr(getattr(importlib.import_module(module), fn),
                                "launches")
        except (ImportError, AttributeError):
            out[name] = None
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: (None if before[k] is None or after[k] is None
                else after[k] - before[k]) for k in before}


def held_to_config(model, model_cfg: dict, fit_cfg: dict) -> None:
    """Raise ``ValueError`` where the program's model differs from a number
    of the configuration's ``model`` group that it holds (its
    constructor's keywords, or a default it cannot be given), or where
    its matrix products run with TF32 against the ``fit`` group's
    ``tf32``."""
    held = vars(model.config)
    for key, value in model_cfg.items():
        if key in held and held[key] != value:
            raise ValueError(f"the program's model holds {key}="
                             f"{held[key]!r}, the configuration {value!r}")
    if torch.backends.cuda.matmul.allow_tf32 != fit_cfg["tf32"]:
        raise ValueError("matrix products run with TF32 "
                         f"{torch.backends.cuda.matmul.allow_tf32}, the "
                         f"configuration states tf32 {fit_cfg['tf32']}")


class FitRecord(NamedTuple):
    index: int
    network: int
    engine_seed: int
    seconds: float
    n_iter: int
    elbo: List[float]
    X: Optional[torch.Tensor]   # final means (n, T, d)
    failed: bool
    error: Optional[str]
    launches: dict


class FitStream:
    """The pool of networks a run draws in set-up, and its fits."""

    def __init__(self, cell, seed: int, device: torch.device):
        from tame_torch import TemporalAMEModel

        self.cell, self.seed, self.device = cell, seed, device
        self.model_cfg, self.fit_cfg = cell.config["model"], cell.config["fit"]
        self.traffic = cell.traffic
        m = self.model_cfg
        n, T, r = m["n_nodes"], m["n_time"], m["latent_dim"]
        params = build_params(m)
        pool, batch = self.traffic["pool"], self.traffic["draw_batch"]
        gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 0))
        self.Y = [y for k in range(0, pool, batch) for y in
                  datagen.sample_networks(params, gen, min(batch, pool - k),
                                          n, T)[0].unbind(0)]
        frac = self.traffic["mask_frac"]
        self.masks = None
        if frac > 0:
            mgen = torch.Generator(device=device).manual_seed(
                derive_seed(seed, 1))
            self.masks = list(datagen.sample_masks(mgen, pool, n, T,
                                                   frac).unbind(0))
        self.model = TemporalAMEModel(
            n, T, r, ar_coefficient=m["ar_coefficient"],
            rho_additive=m["rho_additive"],
            rho_multiplicative=m["rho_multiplicative"],
            rho_dyadic=m["rho_dyadic"],
            process_noise_scale=m["process_noise_scale"], device=device)
        held_to_config(self.model, m, self.fit_cfg)
        self.kind = spec.traffic_kind(self.traffic["kind"])
        self.spans = None   # a traced run sets torch.profiler.record_function

    def engine_seed(self, k: int) -> int:
        return derive_seed(self.seed, 2 if k >= 0 else 3, abs(k))

    def network(self, k: int) -> int:
        return k % len(self.Y)

    def mask(self, k: int) -> Optional[torch.Tensor]:
        return None if self.masks is None else self.masks[self.network(k)]

    def _span(self, name: str):
        return self.spans(name) if self.spans else nullcontext()

    def run_fit(self, k: int, max_iter: Optional[int] = None,
                keep: bool = True) -> FitRecord:
        """Fit k, timed on the host clock from the engine's construction to
        the end of its device work."""
        f = self.fit_cfg
        self.model.Y = self.Y[self.network(k)]
        before = launch_counts()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        error, hist, vi = None, None, None
        try:
            with self._span("tbench.fit"):
                with self._span("tbench.engine_init"):
                    vi = self.kind.engine(self, k)
                with self._span("tbench.engine_fit"):
                    hist = vi.fit(max_iter=max_iter or f["max_iter"],
                                  tolerance=f["tolerance"], verbose=False)
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
        except Exception as exc:  # a fit that raises is a failed fit
            error = f"{type(exc).__name__}: {exc}"
        seconds = time.perf_counter() - t0
        elbo = [] if hist is None else list(hist["elbo"])
        failed = error is not None or not all(map(math.isfinite, elbo))
        X = vi.X_mean.detach() if (keep and vi is not None and not failed) \
            else None
        return FitRecord(index=k, network=self.network(k),
                         engine_seed=self.engine_seed(k), seconds=seconds,
                         n_iter=len(elbo), elbo=elbo, X=X, failed=failed,
                         error=error, launches=_delta(before, launch_counts()))

    def warm_up(self) -> None:
        """Set-up's fits, at the shapes of the window's (negative indices:
        their own engine seeds)."""
        t = self.traffic
        for i in range(t["warmup_fits"]):
            self.run_fit(-1 - i, max_iter=t["warmup_iters"], keep=False)
