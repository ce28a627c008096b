"""Traffic kind ``smf_prod_fits``: the Good structured mean-field fits of
kind ``smf_fits`` (the same engine, spans and fault targets) at the
production flags its configuration states: bf16 dyad weights and
sufficient-statistics diagnostics, on masked networks.  The reference
replays them with the flags' roundings
(``tbench/reference/kinds/smf_prod_fits.py``)."""

from tbench import spec

_SMF = spec.traffic_kind("smf_fits")

# The program's functions a traced run wraps in the benchmark's spans.
WRAPPED = _SMF.WRAPPED
# Where the fault tests plant their faults: the block step, the fit
# function (the answer as it leaves it) and the stopping rule.
FAULT_TARGETS = _SMF.FAULT_TARGETS
engine = _SMF.engine
