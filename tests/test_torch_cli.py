"""The port's command line (``python -m tame_torch``) against ``tame``'s on
the CPU: the same parser apart from ``--device``; ``fit`` for every
method, with and without hidden dyads, on the same data, masks and inits
(``tests/_host_parity.py``), printing the same iterations, final ELBO,
MSE and held-out metrics; checkpoint-then-resume equal to a one-shot run
bit for bit; every other subcommand end to end; the device default; and
that ``--help`` imports neither JAX nor ``tame`` nor matplotlib.
"""

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (the conftest pins it to the CPU)
import numpy as np
import pytest
import torch

import tame.cli as jcli
import tame.utils as jutils
import tame_torch.cli as tcli
import tame_torch.utils as tutils
from _host_parity import rel, share_draws

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SMALL = ["--n-nodes", "10", "--n-time", "4"]


def _spec(parser: argparse.ArgumentParser) -> dict:
    """Every subcommand's options: strings, destination, default, choices,
    nargs, type and help (``--device`` and ``-h`` left out)."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: sorted(
        (tuple(a.option_strings), a.dest, repr(a.default),
         tuple(a.choices) if a.choices else None, a.nargs,
         getattr(a.type, "__name__", None), a.help)
        for a in p._actions if a.dest not in ("help", "device"))
        for name, p in sub.choices.items()}


def test_parser_matches_tame():
    port, ref = tcli.build_parser(), jcli.build_parser()
    assert _spec(port) == _spec(ref)
    sub = next(a for a in port._actions
               if isinstance(a, argparse._SubParsersAction))
    for name, p in sub.choices.items():
        dev = next(a for a in p._actions if a.dest == "device")
        assert dev.default == "cuda" and tuple(dev.choices) == ("cuda",
                                                                "cpu"), name
    args = port.parse_args(["sensitivity", "--values", "10", "20"])
    assert args.values == [10.0, 20.0]


class _Recorder:
    """Wraps a package's ``print_diagnostic_summary`` to keep the history
    and the estimate each ``fit`` reports."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        orig = module.print_diagnostic_summary

        def wrapped(name, history, **kw):
            self.calls.append({k: list(v) for k, v in history.items()})
            return orig(name, history, **kw)

        monkeypatch.setattr(module, "print_diagnostic_summary", wrapped)


HELD_OUT = re.compile(r"(Observed|Held-out)-dyad ([a-zA-Z ]+): (\S+)")


def _run(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("missing", ["0", "0.3"])
@pytest.mark.parametrize("method", ["good", "naive", "bad", "smoothed",
                                    "binary", "poisson"])
def test_fit_matches_tame(method, missing, monkeypatch, capsys):
    share_draws(monkeypatch)
    jrec = _Recorder(monkeypatch, jutils)
    trec = _Recorder(monkeypatch, tutils)
    held = {}
    orig = tcli._held_out_metrics

    def metrics(*a):
        held.update(orig(*a))
        return held

    monkeypatch.setattr(tcli, "_held_out_metrics", metrics)
    argv = ["fit", *SMALL, "--latent-dim", "1", "--method", method,
            "--max-iter", "40", "--missing-frac", missing]
    jout = _run(jcli.main, argv, capsys)
    tout = _run(tcli.main, argv + CPU, capsys)
    (jh,), (th,) = jrec.calls, trec.calls
    assert len(th["elbo"]) == len(jh["elbo"])
    for key in jh:
        assert rel(th[key][-1], jh[key][-1]) < 1e-4, key
    jlines, tlines = HELD_OUT.findall(jout), HELD_OUT.findall(tout)
    assert [m[:2] for m in tlines] == [m[:2] for m in jlines]
    assert len(jlines) == (2 if missing != "0" else 0)
    for (kind, _, printed) in jlines:
        full = held["observed" if kind == "Observed" else "held_out"]
        quantum = 0.5 * 10.0 ** -len(printed.split(".")[1])
        assert abs(full - float(printed)) <= 1e-4 * abs(full) + quantum
    for pattern in (r"Number of iterations: (\d+)",
                    r"Final ELBO:\s+(\S+)"):
        assert re.search(pattern, tout) and re.search(pattern, jout)


def test_checkpoint_then_resume_equals_one_shot(tmp_path, capsys):
    from tame_torch.io import load_checkpoint

    base = ["fit", *SMALL, "--method", "good", "--tolerance", "0"] + CPU
    a, b = str(tmp_path / "resumed"), str(tmp_path / "one_shot")
    _run(tcli.main, base + ["--checkpoint", a, "--checkpoint-every", "5",
                            "--max-iter", "10"], capsys)
    _run(tcli.main, base + ["--checkpoint", a, "--resume", "--max-iter",
                            "20"], capsys)
    _run(tcli.main, base + ["--checkpoint", b, "--max-iter", "20"], capsys)
    ra, rb = load_checkpoint(a), load_checkpoint(b)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, np.asarray(v)

    fa, fb = dict(flat(ra)), dict(flat(rb))
    assert fa.keys() == fb.keys() and len(fa["history/elbo"]) == 20
    for k in fa:
        assert fa[k].tobytes() == fb[k].tobytes(), k
    manifest = json.loads((tmp_path / "resumed" / "manifest.json")
                          .read_text())
    assert manifest["format"] in ("tamestore", "npy")


def test_fit_rejects_seq_with_missing_dyads(capsys):
    argv = ["fit", *SMALL, "--update-mode", "seq", "--missing-frac", "0.2"]
    assert tcli.main(argv + CPU) == jcli.main(argv) == 1
    assert tcli.main(["fit", *SMALL, "--method", "smoothed",
                      "--update-mode", "seq"] + CPU) == 1


END_TO_END = {
    "sample nuts": (["sample", "--n-nodes", "6", "--n-time", "3",
                     "--latent-dim", "1", "--num-chains", "2",
                     "--num-warmup", "10", "--num-samples", "10"],
                    r"NUTS: 2 chains x 10 samples, mean accept = 0\.\d+"),
    "sample hmc poisson": (["sample", "--sampler", "hmc", "--family",
                            "poisson", "--n-nodes", "6", "--n-time", "3",
                            "--latent-dim", "1", "--num-chains", "2",
                            "--num-warmup", "10", "--num-samples", "10"],
                           r"HMC: 2 chains x 10 samples, mean accept"),
    "sample smc": (["sample", "--sampler", "smc", "--n-nodes", "6",
                    "--n-time", "3", "--latent-dim", "1",
                    "--num-particles", "32"],
                   r"SMC: 32 particles, \d+ adaptive stages, "
                   r"log-evidence = -?\d+\.\d\d, final ESS"),
    "learn": (["learn", *SMALL, "--n-em", "2"],
              r"Learned after 2 EM iterations: phi=\S+  sigma2=\S+  rho="),
    "learn bernoulli masked": (["learn", *SMALL, "--n-em", "2", "--family",
                                "bernoulli", "--missing-frac", "0.2"],
                               r"Learned after 2 EM iterations: phi=\S+$"),
    "three-way": (["three-way", *SMALL, "--max-iter", "20", "--no-save"],
                  r"Method Comparison"),
    "mult-strength": (["mult-strength", *SMALL, "--max-iter", "20",
                       "--no-save"],
                      r"Strong multiplicative final MSE: Naive MF="),
    "sensitivity": (["sensitivity", "--values", "6", "8",
                     "--n-replicates", "2", "--max-iter", "20",
                     "--no-save"],
                    r"N_NODES = 8\n=+\n  Naive MF: MSE = "),
    "binary-compare": (["binary-compare", *SMALL, "--max-iter", "20",
                        "--no-save"],
                       r"Smoothed binary\s+0\.\d{4}\s+0\.\d{4}"),
}


@pytest.mark.parametrize("name", list(END_TO_END))
def test_subcommand_end_to_end(name, capsys):
    argv, pattern = END_TO_END[name]
    out = _run(tcli.main, argv + CPU, capsys)
    assert re.search(pattern, out, re.M), out[-2000:]


def test_demo_end_to_end(tmp_path, capsys):
    out = _run(tcli.main, ["demo", "--lr", "0.7", "--max-iter", "30",
                           "--outdir", str(tmp_path)] + CPU, capsys)
    assert "Step 9: Verdict" in out and "4 figures saved" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "contributions.png", "convergence.png", "three_way.png",
        "trajectories.png"]


def test_bench_dispatches_to_the_port(monkeypatch):
    from tame_torch.scripts import bench

    seen = []
    monkeypatch.setattr(bench, "main", lambda argv=None: seen.append(argv))
    assert tcli.main(["bench"] + CPU) == 0
    assert seen == [["--device", "cpu"]]


def test_unknown_command_exits_as_tame(capsys):
    codes = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(["no-such-command"])
        codes.append(e.value.code)
    err = capsys.readouterr().err
    assert codes == [2, 2]
    assert err.count("invalid choice: 'no-such-command'") == 2


def test_runs_on_the_card_by_default():
    """Every subcommand runs on the card unless --device cpu is given;
    without a card the default raises before any work."""
    args = tcli.build_parser().parse_args(["fit"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["fit", *SMALL])


def test_help_imports_neither_jax_nor_tame_nor_matplotlib():
    probe = ("import json, runpy, sys\n"
             "sys.argv = ['tame_torch', '--help']\n"
             "try:\n"
             "    runpy.run_module('tame_torch', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    code = e.code\n"
             "print(json.dumps({'code': code, 'loaded': [m for m in "
             "('jax', 'tame', 'matplotlib') if m in sys.modules]}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage: tame_torch" in proc.stdout
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "code": 0, "loaded": []}
