"""Traffic kind ``smf_fits``: each fit is the Good structured mean-field
engine, ``TemporalAMEStructuredMFVI(factorization="good")``, from its
random start (the engine's ``seed``, drawn per fit) or warm, as the
traffic's ``init`` says; its block count is the engine's own (the
configuration's ``num_blocks`` states it)."""


# The program's functions a traced run wraps in the benchmark's spans.
WRAPPED = (("tame_torch.inference.cavi", "fit_cavi", "tbench.fit_fn"),
           ("tame_torch.inference.cavi", "cavi_step_block", "tbench.step"),
           ("tame_torch.inference.cavi", "residual_stats", "tbench.diag"))
# Where the fault tests plant their faults: the block step, the fit
# function (the answer as it leaves it) and the stopping rule.
FAULT_TARGETS = {"step": ("tame_torch.inference.cavi", "cavi_step_block"),
                 "fit": ("tame_torch.inference.cavi", "fit_cavi"),
                 "rule": ("tame_torch.inference.cavi", "_StopRule")}


def engine(stream, k: int):
    from tame_torch import TemporalAMEStructuredMFVI

    t, f = stream.traffic, stream.fit_cfg
    return TemporalAMEStructuredMFVI(
        stream.model, factorization="good",
        learning_rate=f["learning_rate"], init_scale=f["init_scale"],
        cov_init_scale=f["cov_init_scale"], seed=stream.engine_seed(k),
        update_mode=f["update_mode"], corrected=t["corrected"],
        mixed_precision=f["mixed_precision"], diag_mode=f["diag_mode"],
        init_mode=t["init"], mask=stream.mask(k))
