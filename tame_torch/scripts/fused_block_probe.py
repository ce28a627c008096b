"""K3 on the default engine path in block mode (port of
``scripts/fused_block_probe.py``).

    python -m tame_torch.scripts.fused_block_probe [--sizes 15,100]

For each n (T=10, r=2, lr 1.0, 30 iterations, tolerance 0, block updates
with the default block count): the default ``fit_cavi`` must run as one K3
launch (its launch counter, where the JAX script read
``cavi.LAST_FIT_USED_FUSED``), and match the unfused loop
(``fused=False``) to ELBO 1e-4 relative and max |dX_mean| 1e-3.  n=100,
T=10 with 10 blocks is near the top of K3's shared-memory envelope.  On
``--device cpu`` there is no K3: ``fused=True`` runs its twin.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from tame_torch.inference import cavi
from tame_torch.models import TemporalAMEModel
from tame_torch.ops import fused_fit
from tame_torch.scripts import _common


def check(device: torch.device, n: int, T: int, r: int, lr: float,
          max_iter: int) -> dict:
    model = TemporalAMEModel(n_nodes=n, n_time=T, latent_dim=r, seed=42,
                             device=device)
    Y = model.generate_data()
    params = model.params.to(device)
    init = cavi.init_state(torch.Generator(device=device).manual_seed(0), n,
                           T, 2 + 2 * r, "full", 0.1, 0.5)
    kw = dict(structure="full", update_mode="block", max_iter=max_iter,
              learning_rate=lr, tolerance=0.0)
    on_card = device.type == "cuda"
    before = fused_fit.fused_fit_kernel.launches
    fz, wall = _common.timed(lambda: cavi.fit_cavi(
        Y, params, init, fused="auto" if on_card else True, **kw), device)
    launches = fused_fit.fused_fit_kernel.launches - before
    print(f"n={n}: K3 launches {launches}, {wall} s, final ELBO "
          f"{fz.elbo_history[max_iter - 1].item()}", flush=True)
    if on_card:
        _common.require(launches == 1, "the default block path did not run "
                        "as one K3 launch")
    ref = cavi.fit_cavi(Y, params, init, fused=False, **kw)
    eh_r = ref.elbo_history[:max_iter].numpy()
    eh_f = fz.elbo_history[:max_iter].numpy()
    rel = float(np.nanmax(np.abs(eh_r - eh_f) / np.abs(eh_r)))
    dm = (ref.X_mean - fz.X_mean).abs().max().item()
    print(f"n={n}: ELBO rel err {rel}, max|dX_mean| {dm}", flush=True)
    _common.require(rel < 1e-4 and dm < 1e-3,
                    f"K3 and the unfused loop disagree at n={n}")
    return {"k3_launches": launches, "wall_s": wall, "elbo_rel_err": rel,
            "max_dx_mean": dm}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", default="15,100",
                        help="comma-separated node counts")
    parser.add_argument("--T", type=int, default=10)
    parser.add_argument("--r", type=int, default=2)
    parser.add_argument("--max-iter", type=int, default=30)
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    print(_common.describe(device), flush=True)
    out = {n: check(device, n, args.T, args.r, 1.0, args.max_iter)
           for n in (int(s) for s in args.sizes.split(","))}
    print("OK", flush=True)
    return out


if __name__ == "__main__":
    main()
