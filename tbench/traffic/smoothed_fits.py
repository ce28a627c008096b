"""Traffic kind ``smoothed_fits``: each fit is the smoothed-family engine,
``TemporalAMESmoothedVI``, from the start the traffic's ``init`` names,
with the configuration's block count."""


# The program's functions a traced run wraps in the benchmark's spans.
WRAPPED = (("tame_torch.inference.smoothed", "fit_cavi_smoothed",
            "tbench.fit_fn"),
           ("tame_torch.inference.smoothed", "smoothed_step_block",
            "tbench.step"),
           ("tame_torch.inference.cavi", "residual_stats", "tbench.diag"))


def engine(stream, k: int):
    from tame_torch import TemporalAMESmoothedVI

    t, f = stream.traffic, stream.fit_cfg
    return TemporalAMESmoothedVI(
        stream.model, learning_rate=f["learning_rate"],
        init_scale=f["init_scale"], seed=stream.engine_seed(k),
        corrected=t["corrected"], init_mode=t["init"],
        update_mode=f["update_mode"], num_blocks=f["num_blocks"],
        mixed_precision=f["mixed_precision"], diag_mode=f["diag_mode"],
        mask=stream.mask(k))
