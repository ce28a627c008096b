"""The benchmark's own draw of networks and observation masks from the
temporal AME model: a frozen copy of the generative arithmetic, in plain
PyTorch on the generator's device, batched over networks.

Per network: X^0 = z L0' with L0 L0' = Sigma0; X^t = X^{t-1} Phi' + e_t L_Q'
for t = 1..T-1; each ordered slot (i, j, t) draws (mu_ij, mu_ji) + R^(1/2) z
and the upper triangle is mirrored, so ``Y[i, j, t] = (y_ij, y_ji)`` with
``Y[i, j, t, 1] == Y[j, i, t, 0]`` and a zero diagonal.  A mask hides each
unordered dyad at each time independently with probability ``frac``
(symmetric, zero diagonal).  Everything is float32.
"""

from __future__ import annotations

import torch

from tbench.reference.model import Params


def sample_networks(params: Params, gen: torch.Generator, count: int, n: int,
                    T: int):
    """``count`` networks ``Y (count, n, n, T, 2)`` and their latent states
    ``X (count, n, T, d)``, float32 on ``gen``'s device."""
    dev = gen.device
    p = params.to(dtype=torch.float32, device=dev)
    d = p.d
    r = (d - 2) // 2
    L0 = torch.linalg.cholesky(p.Sigma0)
    LQ = torch.linalg.cholesky(p.Q)
    LR = torch.linalg.cholesky(p.R)
    x = torch.randn(count, n, d, generator=gen, device=dev) @ L0.T
    eps = torch.randn(T, count, n, d, generator=gen, device=dev) @ LQ.T
    xs = [x]
    for t in range(1, T):
        x = x @ p.Phi.T + eps[t]
        xs.append(x)
    X = torch.stack(xs, 2)                                  # (B, n, T, d)
    a, b = X[..., 0], X[..., 1]
    U, V = X[..., 2:2 + r], X[..., 2 + r:]
    fwd = (a[:, :, None, :] + b[:, None, :, :]
           + torch.einsum("bitr,bjtr->bijt", U, V))         # (B, n, n, T)
    del xs, eps
    Y = torch.stack([fwd, fwd.transpose(1, 2)], -1)
    del fwd
    Y += torch.randn(Y.shape, generator=gen, device=dev) @ LR.T
    i = torch.arange(n, device=dev)
    upper = (i[:, None] < i[None, :])[None, :, :, None, None]
    mirrored = Y.transpose(1, 2).flip(-1)
    Y = torch.where(upper, Y, mirrored)
    Y[:, i, i] = 0.0
    return Y, X


def sample_masks(gen: torch.Generator, count: int, n: int, T: int,
                 frac: float) -> torch.Tensor:
    """``count`` observation masks ``(count, n, n, T)`` of {0, 1} float32:
    each unordered dyad at each time observed with probability
    ``1 - frac``."""
    dev = gen.device
    u = torch.rand(count, n, n, T, generator=gen, device=dev)
    upper = torch.triu(torch.ones(n, n, device=dev), diagonal=1)
    keep = (u > frac).float() * upper[None, :, :, None]
    return keep + keep.transpose(1, 2)
