"""The reference's replay of a smoothed-family fit (traffic kind
``smoothed_fits``): the data-driven warm start, then damped block updates
of whole node trajectories (:func:`tbench.reference.fits.smoothed_step`)
and the ELBO after every iteration."""

import torch

from tbench.reference import fits
from tbench.reference.judge import refuse_unless
from tbench.reference.model import warm_init_mean
from tbench.roofline.counts import smoothed_iteration_flops

# The settings the replay implements; a cell that states another is refused.
REPLAYS = {"fit": {"dtype": ("float32",), "tf32": (False,),
                   "mixed_precision": (False,), "diag_mode": ("exact",),
                   "update_mode": ("block",)},
           "traffic": {"init": ("warm",), "mask_frac": (0.0,)}}


def check(config: dict, traffic: dict) -> None:
    refuse_unless(config, traffic, REPLAYS)


def start(data, params, pri, prec, config, traffic, engine_seed):
    """``(X, step)``: the means, updated in place, and one iteration that
    returns the ELBO after it.  The warm start draws nothing from the
    fit's seed."""
    fit = config["fit"]
    T, n, _ = data.Y0.shape
    d = params.d
    X = warm_init_mean(data.Y0.permute(1, 2, 0),
                       config["model"]["latent_dim"], prec)
    eye = torch.eye(d, dtype=prec.dtype, device=X.device)
    st = fits.SmoothedState(
        X=X, cov=(0.5 * eye).expand(n, T, d, d).clone(),
        cross=X.new_zeros((n, T - 1, d, d)), logdets=X.new_zeros(n))

    def step():
        fits.smoothed_step(st, data, params, pri, prec, fit["learning_rate"],
                           fit["num_blocks"], traffic["corrected"])
        return fits.smoothed_elbo(st, data, params, pri, prec)
    return X, step


def iteration_flops(n: int, T: int, d: int, num_blocks: int) -> float:
    return smoothed_iteration_flops(n, T, d, num_blocks)
