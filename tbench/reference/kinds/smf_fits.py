"""The reference's replay of a Good structured mean-field fit (traffic
kind ``smf_fits``): the engines' random start from the fit's seed, then
damped block coordinate ascent (:func:`tbench.reference.fits.smf_step`)
and its ELBO after every iteration."""

from tbench.reference import fits
from tbench.reference.judge import refuse_unless
from tbench.reference.model import random_init
from tbench.roofline.counts import fit_flops

# The settings the replay implements; a cell that states another is refused.
REPLAYS = {"fit": {"dtype": ("float32",), "tf32": (False,),
                   "mixed_precision": (False,), "diag_mode": ("exact",),
                   "update_mode": ("block",)},
           "traffic": {"init": ("random",)}}


def check(config: dict, traffic: dict) -> None:
    refuse_unless(config, traffic, REPLAYS)
    n, blocks = config["model"]["n_nodes"], config["fit"]["num_blocks"]
    # the Good-SMF engine takes no block count: its fit splits the nodes
    # into the largest divisor of n that is at most 16
    default = next(k for k in range(min(16, n), 0, -1) if n % k == 0)
    if blocks != default:
        raise ValueError(f"num_blocks {blocks}: a Good-SMF fit at n={n} "
                         f"runs {default} blocks")


def start(data, params, pri, prec, config, traffic, engine_seed):
    """``(X, step)``: the means, updated in place, and one iteration that
    returns the ELBO after it."""
    fit = config["fit"]
    T, n, _ = data.Y0.shape
    mean, cov = random_init(engine_seed, n, T, params.d, fit["init_scale"],
                            fit["cov_init_scale"])
    dev = data.Y0.device
    X = mean.to(prec.dtype).to(dev)
    cov = cov.to(prec.dtype).to(dev)

    def step():
        fits.smf_step(X, cov, data, params, pri, prec, fit["learning_rate"],
                      fit["num_blocks"], traffic["corrected"])
        return fits.smf_elbo(X, cov, data, params, pri, prec)
    return X, step


def iteration_flops(n: int, T: int, d: int, num_blocks: int) -> float:
    return fit_flops(n, T, d, num_blocks, 1)
