"""The port's plots (``tame_torch.visualization``, 21 exports) against
``tame``'s on the CPU: one case per export, the same inputs as numpy
arrays for ``tame`` and as tensors for the port (one of them requiring
grad), and the drawn data compared: line data, collection offsets and
arrays, images, bar geometry, texts, titles and labels, within 1e-6.
Also: ``save_path`` writes a file, and the errors ``tame`` raises are
raised.
"""

from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import tame.visualization as jviz  # noqa: E402
import tame_torch.visualization as tviz  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-6


def _arrays(rng):
    """The shared numpy inputs (float32, as the engines hand them out)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    X_true = f(7, 5, 6)
    X_est = (X_true + 0.2 * f(7, 5, 6)).astype(np.float32)
    Y = f(7, 7, 5, 2)
    cov = np.einsum("ntij,ntkj->ntik", f(7, 5, 6, 6), f(7, 5, 6, 6)) + \
        np.eye(6, dtype=np.float32)
    return dict(X_true=X_true, X_est=X_est, Y=Y, cov=cov.astype(np.float32),
                M=f(7, 5, 4), M6=f(7, 5, 6), chains=f(3, 40, 2, 3),
                logd=f(3, 40), add=np.abs(f(5)), mult=np.abs(f(5)))


def _history(scale=1.0):
    return {"elbo": [-100.0 * scale, -90.0 * scale, -85.0 * scale],
            "reconstruction_error": [0.5 * scale, 0.4 * scale, 0.35]}


def _results(a, conv, vi):
    out = {}
    for i, name in enumerate(["Naive MF", "Good SMF", "Bad SMF"]):
        out[name] = {"history": _history(1.0 + 0.1 * i),
                     "X_est": conv(a["X_est"] + 0.05 * i),
                     "vi": vi(conv(a["cov"] * (1.0 + i))),
                     "runtime": 1.5 + i, "iterations": 3 + i,
                     "method_name": name}
    out["Bad SMF"]["vi"] = None     # an unavailable correlation panel
    return out


def _smc(a, conv):
    return SimpleNamespace(
        n_stages=4, beta_history=conv(np.array([0.01, 0.1, 0.5, 1.0, np.nan],
                                               np.float32)),
        ess_history=conv(np.array([60.0, 40.0, 50.0, 55.0, np.nan],
                                  np.float32)),
        accept_history=conv(np.array([0.5, 0.6, 0.7, 0.8, np.nan],
                                     np.float32)),
        log_weights=conv(np.zeros(64, np.float32)),
        n_resamples=2, log_evidence=conv(np.array(-123.4, np.float32)))


def _correlation_panels(viz, results):
    fig = plt.figure(figsize=(9, 6))
    gs = fig.add_gridspec(3, 3)
    viz.add_correlation_panels_to_figure(fig, gs, results, list(results),
                                         row_index=2, t_plot=1, node_plot=2)
    return fig


# name -> a function of (viz, a, conv, vi) that draws the figure
CASES = {
    "plot_convergence": lambda v, a, c, vi: v.plot_convergence(
        _history(), title="conv"),
    "plot_network": lambda v, a, c, vi: v.plot_network(
        c(a["Y"]), time_index=2, component=1, title="net"),
    "plot_latent_space": lambda v, a, c, vi: v.plot_latent_space(
        c(a["M"]), time_index=3, labels=np.arange(7) * 2, title="lat"),
    "plot_contribution_breakdown": lambda v, a, c, vi:
        v.plot_contribution_breakdown(0.8, 0.2, title="bd"),
    "plot_parameter_comparison": lambda v, a, c, vi:
        v.plot_parameter_comparison(c(a["X_true"]), c(a["X_est"])),
    "plot_residuals": lambda v, a, c, vi: v.plot_residuals(
        c(a["Y"]), c(a["Y"] * 0.9), title="res"),
    "plot_state_trajectories": lambda v, a, c, vi:
        v.plot_state_trajectories(c(a["X_true"]), node_indices=[0, 3],
                                  title="traj"),
    "plot_temporal_contributions": lambda v, a, c, vi:
        v.plot_temporal_contributions(c(a["add"]), c(a["mult"]),
                                      title="tc"),
    "plot_trajectory_comparison": lambda v, a, c, vi:
        v.plot_trajectory_comparison(c(a["X_true"]), c(a["X_est"]),
                                     node_index=2),
    "plot_network_evolution": lambda v, a, c, vi: v.plot_network_evolution(
        c(a["Y"]), title="evo"),
    "plot_latent_trajectory_2d": lambda v, a, c, vi:
        v.plot_latent_trajectory_2d(c(a["M6"]), plot_type="V",
                                    projection="pca"),
    "plot_prediction_horizon": lambda v, a, c, vi:
        v.plot_prediction_horizon({1: 0.2, 3: 0.5, 2: 0.3}),
    "plot_method_comparison": lambda v, a, c, vi: v.plot_method_comparison(
        _results(a, c, vi)),
    "plot_convergence_comparison": lambda v, a, c, vi:
        v.plot_convergence_comparison(_results(a, c, vi), log_scale=True),
    "plot_reconstruction_comparison": lambda v, a, c, vi:
        v.plot_reconstruction_comparison(_results(a, c, vi)),
    "plot_parameter_recovery_grid": lambda v, a, c, vi:
        v.plot_parameter_recovery_grid(c(a["X_true"]), _results(a, c, vi)),
    "plot_computational_efficiency": lambda v, a, c, vi:
        v.plot_computational_efficiency(_results(a, c, vi)),
    "plot_three_way_comparison": lambda v, a, c, vi:
        v.plot_three_way_comparison(_results(a, c, vi),
                                    X_true=c(a["X_true"])),
    "add_correlation_panels_to_figure": lambda v, a, c, vi:
        _correlation_panels(v, _results(a, c, vi)),
    "plot_chain_diagnostics": lambda v, a, c, vi: v.plot_chain_diagnostics(
        c(a["chains"]), logdensities=c(a["logd"])),
    "plot_smc_diagnostics": lambda v, a, c, vi: v.plot_smc_diagnostics(
        _smc(a, c)),
}


def test_every_export_has_a_case():
    assert sorted(CASES) == sorted(jviz.__all__) == sorted(tviz.__all__)
    assert len(CASES) == 21


def _drawn(fig) -> list:
    """Everything a figure shows, per axes: texts and numeric data."""
    out = [("suptitle", fig._suptitle.get_text() if fig._suptitle else "")]
    for ax in fig.axes:
        out.append(("texts", ax.get_title(), ax.get_xlabel(),
                    ax.get_ylabel(), ax.get_xscale(), ax.get_yscale(),
                    [t.get_text() for t in ax.texts],
                    [t.get_text() for t in ax.get_xticklabels()]))
        for line in ax.get_lines():
            out.append(("line", np.asarray(line.get_xydata(), float)))
        for col in ax.collections:
            offsets = np.asarray(col.get_offsets(), float)
            arr = col.get_array()
            out.append(("collection", offsets, None if arr is None
                        else np.asarray(arr, float)))
        for im in ax.images:
            out.append(("image", np.asarray(im.get_array(), float)))
        for p in ax.patches:
            if hasattr(p, "get_height"):
                out.append(("bar", np.array([p.get_x(), p.get_y(),
                                             p.get_width(),
                                             p.get_height()], float)))
    return out


def _same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0] and len(x) == len(y)
        for u, w in zip(x[1:], y[1:]):
            if isinstance(u, np.ndarray):
                np.testing.assert_allclose(w, u, rtol=TOL, atol=TOL,
                                           equal_nan=True)
            else:
                assert u == w


def _share_chain_diagnostics(monkeypatch) -> None:
    """The chain-diagnostics plot computes R-hat and ESS itself; the port's
    take float64 on the host where ``tame``'s take float32, which moves
    the ESS histogram's bin edges by ~1e-6.  Those functions are held to
    ``tame``'s in ``tests/test_torch_utils.py``; here both plots are fed
    ``tame``'s values, so the figure alone is compared."""
    import tame.utils.diagnostics as jd
    import tame_torch.utils.diagnostics as td

    for name in ("split_rhat", "effective_sample_size"):
        ref = getattr(jd, name)
        monkeypatch.setattr(td, name, lambda x, ref=ref: torch.from_numpy(
            np.asarray(ref(np.asarray(x)))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_draws_what_tame_draws(name, monkeypatch):
    a = _arrays(np.random.default_rng(0))
    build = CASES[name]
    if name == "plot_chain_diagnostics":
        _share_chain_diagnostics(monkeypatch)
    plt.close("all")
    ref = _drawn(build(jviz, a, np.asarray, lambda c: SimpleNamespace(
        X_cov=c)))

    first = [True]

    def conv(x):
        t = torch.from_numpy(np.array(x))
        if first[0] and t.is_floating_point() and t.ndim > 0:
            first[0] = False            # the first array requires grad
            t = t.clone().requires_grad_(True)
        return t

    got = _drawn(build(tviz, a, conv, lambda c: SimpleNamespace(X_cov=c)))
    plt.close("all")
    _same(ref, got)


def test_save_path_writes_a_file(tmp_path):
    a = _arrays(np.random.default_rng(1))
    path = tmp_path / "traj.png"
    tviz.plot_state_trajectories(torch.from_numpy(a["X_true"]),
                                 save_path=str(path))
    path2 = tmp_path / "evo.png"
    tviz.plot_network_evolution(torch.from_numpy(a["Y"]),
                                save_path=str(path2))
    plt.close("all")
    assert path.stat().st_size > 0 and path2.stat().st_size > 0


@pytest.mark.parametrize("call", [
    lambda v, M, M6: v.plot_latent_space(M6),
    lambda v, M, M6: v.plot_latent_space(M, plot_U=False, plot_V=False),
    lambda v, M, M6: v.plot_latent_trajectory_2d(M6),
    lambda v, M, M6: v.plot_latent_trajectory_2d(M, plot_type="W"),
])
def test_raises_what_tame_raises(call):
    a = _arrays(np.random.default_rng(2))
    with pytest.raises(ValueError) as ref:
        call(jviz, a["M"], a["M6"])
    with pytest.raises(ValueError) as got:
        call(tviz, torch.from_numpy(a["M"]), torch.from_numpy(a["M6"]))
    plt.close("all")
    assert str(got.value).split("(")[0] == str(ref.value).split("(")[0]
