"""Masked (missing-data) fits at the north-star scale: n=2000, T=50, r=4,
30 % of the dyads hidden (port of ``scripts/masked_scale_probe.py``).

    python -m tame_torch.scripts.masked_scale_probe [--packed]

The per-iteration slope, (wall(40) - wall(8)) / 32 iterations, of

  dense      - no mask, production flags (stats diagnostics, bf16 weights);
  masked-old - the mask with exact diagnostics and float32 contractions;
  masked-new - the mask on the production flags (bf16 mask, masked stats);

then, with ``--packed``, masked-new with ``TAME_PACKED_MASK=1`` (every
masked contraction through K5), and dense and masked-new with
``elbo_every=4``.  Then the observed and held-out reconstruction MSE of the
masked-new fit.  8-block updates, lr 0.8, tolerance 0; host clock ending
in a synchronize.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Optional, Sequence

import torch

from tame_torch.inference import cavi
from tame_torch.models import random_dyad_mask
from tame_torch.ops import dyad as dyad_ops
from tame_torch.ops import masked_contract
from tame_torch.scripts import _common


@contextlib.contextmanager
def packed_mask():
    """``TAME_PACKED_MASK=1`` inside the block; the old value restored."""
    old = os.environ.get("TAME_PACKED_MASK")
    os.environ["TAME_PACKED_MASK"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["TAME_PACKED_MASK"]
        else:
            os.environ["TAME_PACKED_MASK"] = old


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _common.size_flags(parser)
    parser.add_argument("--num-blocks", type=int, default=8)
    parser.add_argument("--missing", type=float, default=0.3,
                        help="fraction of dyads hidden")
    parser.add_argument("--short", type=int, default=8)
    parser.add_argument("--long", type=int, default=40)
    parser.add_argument("--packed", action="store_true",
                        help="also time masked-new through K5 "
                             "(TAME_PACKED_MASK=1)")
    _common.add_device_flag(parser)
    args = parser.parse_args(argv)
    device = _common.resolve_device(args.device)
    n, T, r = args.n, args.T, args.r
    print(_common.describe(device), flush=True)
    cfg, params, Y = _common.north_star(device, n, T, r)
    mask = random_dyad_mask(torch.Generator(device=device).manual_seed(1),
                            n, T, args.missing)

    def slope(tag, seed, **kw):
        def run(i, iters):
            init = cavi.init_state(
                torch.Generator(device=device).manual_seed(100 + seed + i),
                n, T, cfg.d, "full", 0.1, 0.5)
            return cavi.fit_cavi(Y, params, init, structure="full",
                                 update_mode="block",
                                 num_blocks=args.num_blocks, max_iter=iters,
                                 learning_rate=0.8, tolerance=0.0, **kw)

        out, ms = _common.slope_ms(run, args.short, args.long, device)
        print(f"{tag}: {ms} ms/iteration", flush=True)
        return out, ms

    prod = dict(mixed_precision=True, diag_mode="stats")
    res = {}
    _, res["dense"] = slope("dense (stats+mp)", 0, **prod)
    _, res["masked_old"] = slope("masked-old (exact, f32)", 10, mask=mask)
    out, res["masked_new"] = slope("masked-new (stats+mp, bf16 mask)", 50,
                                   mask=mask, **prod)
    print(f"masked-new / dense: {res['masked_new'] / res['dense']} "
          f"(masked-old / dense: {res['masked_old'] / res['dense']})",
          flush=True)
    if args.packed:
        before = masked_contract.packed_rows_contract_kernel.launches
        with packed_mask():
            _, res["masked_packed"] = slope(
                "masked (stats+mp, int8 packed mask, K5)", 20, mask=mask,
                **prod)
        if device.type == "cuda":
            _common.require(
                masked_contract.packed_rows_contract_kernel.launches > before,
                "the packed-mask fits did not run K5")
        print(f"masked-packed / dense: "
              f"{res['masked_packed'] / res['dense']}", flush=True)
    _, res["dense_every4"] = slope("dense (stats+mp, elbo_every=4)", 30,
                                   elbo_every=4, **prod)
    _, res["masked_new_every4"] = slope(
        "masked-new (stats+mp, elbo_every=4)", 40, mask=mask, elbo_every=4,
        **prod)
    print(f"elbo_every=4 masked / dense: "
          f"{res['masked_new_every4'] / res['dense_every4']}; masked every 4 "
          f"vs dense every 1: {res['masked_new_every4'] / res['dense']}",
          flush=True)

    e2 = (Y[..., 0] - dyad_ops.dyadic_fwd_temporal(out.X_mean, r)) ** 2
    held = dyad_ops.offdiag_mask(n, Y.dtype, device)[:, :, None] * (1 - mask)
    res["mse_observed"] = ((e2 * mask).sum() / mask.sum()).item()
    res["mse_held_out"] = ((e2 * held).sum() / held.sum()).item()
    print(f"observed MSE {res['mse_observed']}  held-out MSE "
          f"{res['mse_held_out']} (R noise floor 0.1)", flush=True)
    return res


if __name__ == "__main__":
    main()
