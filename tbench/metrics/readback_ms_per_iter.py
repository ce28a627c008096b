"""Host milliseconds per iteration reading device memory in the fit path
(``loop.readback``: the loops' ELBO and MSE, K3's history), the host
waiting for the device."""

from tbench.metrics._program import per_iter_ms


def read(run):
    return per_iter_ms(run, "loop.readback")
