"""K6 (``dual_contract``) and K5 (``masked_contract``) timed beside their
twins, the library calls for the same functions and their bounds.

    python3 tame_torch/scripts/contract_probe.py [--root TREE --tag TAG]
        [--res-usage] [--bits-out F | --bits-against F] [--out FILE]

K6 at every ``--k6 T,n,m`` (default ``chip_smoke.py``'s shapes: T=50,
n=2000, m=8; T=3, n=20, m=4; T=3, n=37, m=13; T=50, n=2000, m=40) and K5
at ``chip_smoke.py``'s four cases on an n=2000, T=50 mask with 30 % of
the dyads hidden (``--n``, ``--T`` shrink it): one block-phase stripe
(16 blocks, bs=125) against the K=57 precision panel and a K=56 panel,
the ragged n=20, T=3 mask in 4 stripes, and the whole mask as one stripe.

Kernel times are device times: launches replayed from one CUDA graph,
median of ``--repeats`` replays, divided by the launches.  K5's block
stripes are replayed **in rotation** over the 16 stripes of the mask, as a
block sweep reads them, so each 12.5 MB stripe arrives cold (one stripe
replayed alone stays in the 50 MB L2; ``warm_ms`` times that too).
``call_ms`` is one wrapper call between two CUDA events, the host's time
to reach the launch included.  Beside each kernel: its twin, the library
call on bf16 copies made beforehand (two ``bmm`` for K6, one for K5) and
the bound (``chip_smoke.bound``, each input byte read once and each
output byte written once).

``--bits-out FILE`` saves both kernels' outputs at fixed inputs (K5 at
the four cases above, K6 at its shapes), and ``--bits-against FILE``
compares this tree's with them bit for bit.  ``--res-usage`` compiles
``csrc/dual_contract.cu`` and ``csrc/masked_contract.cu`` of the tree
alone with ``nvcc -Xptxas -v`` and prints each kernel's registers.

``--root`` imports ``tame_torch`` from another tree, such as a ``git
archive`` of an earlier commit (run the file by its path then, not with
``-m``), so two trees' kernels are timed in turns in one call; a shape
the tree's kernel refuses is reported as refused.  On ``--device cpu``
there is no kernel and no library yardstick: the twins are timed on the
host clock.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Optional, Sequence

MISSING_FRAC = 0.3          # chip_smoke.py's and masked_scale_probe's mask
K6_SHAPES = ((50, 2000, 8), (3, 20, 4), (3, 37, 13), (50, 2000, 40))


def rotating_graph_ms(fns, reps: int, launches: int = 32) -> float:
    """Device milliseconds per launch of the calls ``fns`` made in turn:
    ``spd_probe.graph_ms`` of one pass over them, replayed
    ``launches / len(fns)`` times from one CUDA graph."""
    from tame_torch.scripts.spd_probe import graph_ms

    return graph_ms(lambda: [fn() for fn in fns], reps,
                    max(1, launches // len(fns))) / len(fns)


def k6_inputs(T: int, n: int, m: int, device):
    import torch

    from tame_torch.ops import dual_contract as dc

    g = torch.Generator(device=device).manual_seed(T * n + m)
    Wp = dc.pad_data(torch.randn(T, n, n, device=device, generator=g))
    return Wp, torch.randn(T, n, m, device=device, generator=g)


def time_k6(T: int, n: int, m: int, device, repeats: int) -> dict:
    import torch

    from chip_smoke import bound, nbytes
    from tame_torch.ops import dual_contract as dc
    from tame_torch.scripts.spd_probe import _cuda_ms, _host_ms

    Wp, Z = k6_inputs(T, n, m, device)
    out = {"T": T, "n": n, "m": m}
    if device.type != "cuda":
        out["twin_host_ms"] = _host_ms(lambda: dc.dual_contract_twin(Wp, Z),
                                       repeats)
        return out
    try:
        row, col = dc.dual_contract_kernel(Wp, Z)
    except ValueError as err:  # an earlier tree's K6 refuses m > 16
        out["refused"] = str(err)
        return out
    row_t, col_t = dc.dual_contract_twin(Wp, Z)
    again = dc.dual_contract_kernel(Wp, Z)
    Wb, Zb = Wp[..., :n], Z.to(torch.bfloat16)
    out.update(
        rel_err=max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in ((row, row_t), (col, col_t))),
        deterministic=bool(torch.equal(again[0], row)
                           and torch.equal(again[1], col)),
        ms=rotating_graph_ms([lambda: dc.dual_contract_kernel(Wp, Z)],
                             repeats, 20),
        call_ms=_cuda_ms(lambda: dc.dual_contract_kernel(Wp, Z), repeats),
        twin_ms=_cuda_ms(lambda: dc.dual_contract_twin(Wp, Z), repeats),
        library_ms=_cuda_ms(lambda: (
            torch.bmm(Wb, Zb, out_dtype=torch.float32),
            torch.bmm(Wb.transpose(1, 2), Zb, out_dtype=torch.float32)),
            repeats),
        **bound(nbytes(Wp, Z, row, col), 4.0 * T * n * n * m, "bf16"))
    return out


def k5_cases(device, n: int = 2000, T: int = 50):
    """``chip_smoke.py``'s four K5 cases from fixed seeds:
    ``(label, stripes, panel)``, where the first two take one block stripe
    of a 16-block mask and carry all 16 for the rotation."""
    import torch

    from tame_torch.inference import cavi
    from tame_torch.models import random_dyad_mask
    from tame_torch.ops import masked_contract as mc

    mask = random_dyad_mask(torch.Generator(device=device).manual_seed(1),
                            n, T, MISSING_FRAC)
    g = torch.Generator(device=device).manual_seed(2)
    U, V = (0.5 * torch.randn(n, T, 4, device=device, generator=g)
            for _ in range(2))
    p57 = cavi._masked_panel(U, V)
    p56 = torch.randn(n, T, 56, device=device, generator=g)
    small = random_dyad_mask(g, 20, 3, MISSING_FRAC)
    blocks = list(mc.pack_mask(mask, 16))
    bs = n // 16
    return [(f"n={n} bs={bs} K=57", blocks, p57),
            (f"n={n} bs={bs} K=56", blocks, p56),
            ("n=20 T=3 K=5 nb=4", list(mc.pack_mask(small, 4)),
             torch.randn(20, 3, 5, device=device, generator=g)),
            (f"n={n} one stripe K=57", [mc.pack_mask(mask, 1)[0]], p57)]


def time_k5(label: str, stripes, Z, device, repeats: int) -> dict:
    import torch

    from chip_smoke import bound, nbytes
    from tame_torch.ops import masked_contract as mc
    from tame_torch.scripts.spd_probe import _cuda_ms, _host_ms

    Mp = stripes[0]
    out = {"case": label, "stripes": len(stripes)}
    if device.type != "cuda":
        out["twin_host_ms"] = _host_ms(
            lambda: mc.packed_rows_contract_twin(Mp, Z), repeats)
        return out
    got = mc.packed_rows_contract_kernel(Mp, Z)
    ref = mc.packed_rows_contract_twin(Mp, Z)
    Mb = Mp[..., :Z.shape[0]].to(torch.bfloat16)
    Zb = Z.to(torch.bfloat16).transpose(0, 1).contiguous()
    out.update(
        rel_err=((got - ref).abs().max() / ref.abs().max()).item(),
        ms=rotating_graph_ms(
            [lambda M=M: mc.packed_rows_contract_kernel(M, Z)
             for M in stripes], repeats, max(20, 2 * len(stripes))),
        warm_ms=rotating_graph_ms(
            [lambda: mc.packed_rows_contract_kernel(Mp, Z)], repeats, 20),
        call_ms=_cuda_ms(lambda: mc.packed_rows_contract_kernel(Mp, Z),
                         repeats),
        twin_ms=_cuda_ms(lambda: mc.packed_rows_contract_twin(Mp, Z),
                         repeats),
        library_ms=_cuda_ms(
            lambda: torch.bmm(Mb, Zb, out_dtype=torch.float32), repeats),
        **bound(nbytes(Mp, Z, got),
                2.0 * Mp.shape[0] * Mp.shape[1] * Z.shape[0] * Z.shape[2],
                "bf16"))
    return out


def kernel_outputs(device, k6_shapes, n: int = 2000, T: int = 50) -> dict:
    """K5 at :func:`k5_cases` (every stripe of the small mask, the first
    of the others) and K6 at ``k6_shapes`` it takes, on the CPU, from
    inputs made on ``device`` from fixed seeds."""
    from tame_torch.ops import dual_contract as dc
    from tame_torch.ops import masked_contract as mc

    out = {}
    for label, stripes, Z in k5_cases(device, n, T):
        take = stripes if len(stripes) == 4 else stripes[:1]
        out[f"K5 {label}"] = {
            f"stripe {k}": mc.packed_rows_contract(M, Z).cpu()
            for k, M in enumerate(take)}
    for T_, n_, m in k6_shapes:
        Wp, Z = k6_inputs(T_, n_, m, device)
        try:
            row, col = dc.dual_contract_padded(Wp, Z)
        except ValueError:  # an earlier tree's K6 refuses m > 16
            continue
        out[f"K6 T={T_} n={n_} m={m}"] = {"row": row.cpu(), "col": col.cpu()}
    return out


def compare_bits(mine: dict, theirs: dict) -> dict:
    """Per case and output held by both: equal bit for bit, else the
    largest absolute difference."""
    import torch

    return {case: {name: (True if torch.equal(t, theirs[case][name])
                          else (t - theirs[case][name]).abs().max().item())
                   for name, t in outs.items()}
            for case, outs in mine.items() if case in theirs}


def _shape(text: str) -> tuple:
    T, n, m = (int(v) for v in text.split(","))
    return T, n, m


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=None,
                        help="tree to import tame_torch from (default: this "
                             "file's)")
    parser.add_argument("--tag", default="", help="label for the output")
    parser.add_argument("--k6", type=_shape, nargs="+",
                        default=list(K6_SHAPES), metavar="T,n,m")
    parser.add_argument("--n", type=int, default=2000,
                        help="nodes of K5's mask (a multiple of 16)")
    parser.add_argument("--T", type=int, default=50)
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--res-usage", action="store_true")
    parser.add_argument("--out", default=None, help="also write the JSON here")
    parser.add_argument("--bits-out", default=None,
                        help="save K5/K6's outputs here")
    parser.add_argument("--bits-against", default=None,
                        help="compare K5/K6's outputs with those saved here")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    root = pathlib.Path(args.root or pathlib.Path(__file__).parents[2])
    root = root.resolve()
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))

    import tame_torch
    from tame_torch.ops import _ext
    from tame_torch.scripts import _common

    _common.require(pathlib.Path(tame_torch.__file__).resolve().parents[1]
                    == root, f"tame_torch was imported from "
                    f"{tame_torch.__file__}, not from {root}")
    device = _common.resolve_device(args.device)
    res = {"tag": args.tag, "root": str(root),
           "device": _common.describe(device), "k6": [], "k5": []}
    print(res["device"], flush=True)
    if device.type == "cuda":
        t0 = time.perf_counter()
        _ext.load()
        res["build_s"] = time.perf_counter() - t0
    for T, n, m in args.k6:
        row = time_k6(T, n, m, device, args.repeats)
        res["k6"].append(row)
        print(f"{args.tag} K6 {json.dumps(row)}", flush=True)
    for label, stripes, Z in k5_cases(device, args.n, args.T):
        row = time_k5(label, stripes, Z, device, args.repeats)
        res["k5"].append(row)
        print(f"{args.tag} K5 {json.dumps(row)}", flush=True)
    if args.bits_out or args.bits_against:
        import torch

        outs = kernel_outputs(device, args.k6, args.n, args.T)
        if args.bits_out:
            torch.save(outs, args.bits_out)
        if args.bits_against:
            res["bits"] = compare_bits(outs, torch.load(args.bits_against))
            print(f"{args.tag} bits against {args.bits_against}: "
                  f"{json.dumps(res['bits'])}", flush=True)
    if device.type == "cuda" and args.res_usage:
        from tame_torch.scripts.spd_probe import res_usage

        res["res_usage"] = [row for src in ("dual_contract.cu",
                                            "masked_contract.cu")
                            for row in res_usage(root, src)]
        for row in res["res_usage"]:
            print(f"{args.tag} {json.dumps(row)}", flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res) + "\n")
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
