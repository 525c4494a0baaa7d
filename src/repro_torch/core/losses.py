"""Test metrics and losses (port of :mod:`repro.core.losses`, paper
Appendix F.1).

The headline evaluation metric is the signature-feature MMD: the feature map
ψ is the depth-``m`` truncated path signature of the time-augmented path;
MMD = ‖E ψ(P) − E ψ(Q)‖.  The reference's ``lax.scan`` over segments is a
loop here, with the same operations in the same order.
"""

from __future__ import annotations

import torch

from ..data.synthetic import _linspace


def _segment_exp(dy: torch.Tensor, depth: int):
    """Truncated signature of a linear segment: exp⊗(dy) levels 1..depth.

    Level k is ``dy^⊗k / k!`` with shape ``batch + (d,)*k``."""
    d = dy.shape[-1]
    batch = dy.shape[:-1]
    levels = [dy]
    for k in range(2, depth + 1):
        prev = levels[-1]  # batch + (d,)*(k-1)
        levels.append(prev[..., None] * dy.reshape(batch + (1,) * (k - 1) + (d,)) / k)
    return levels


def signature(path: torch.Tensor, depth: int = 3) -> torch.Tensor:
    """Depth-``depth`` truncated signature of ``path`` (T+1, ..., d).

    Chen's relation over segments: S ← S ⊗ exp(Δy).  Returns the flattened
    levels 1..depth, shape (..., d + d² + … + d^depth)."""
    d = path.shape[-1]
    dys = path[1:] - path[:-1]  # (T, ..., d)
    batch_shape = path.shape[1:-1]
    S = [path.new_zeros(batch_shape + (d,) * k) for k in range(1, depth + 1)]
    for dy in dys:
        E = _segment_exp(dy, depth)
        out = []
        for k in range(1, depth + 1):
            # level k of S ⊗ E:  E_k + S_k + Σ_{i=1..k-1} S_i ⊗ E_{k-i}
            acc = E[k - 1] + S[k - 1]
            for i in range(1, k):
                a = S[i - 1].reshape(batch_shape + (d,) * i + (1,) * (k - i))
                b = E[k - i - 1].reshape(batch_shape + (1,) * i + (d,) * (k - i))
                acc = acc + a * b
            out.append(acc)
        S = out
    return torch.cat([s.reshape(batch_shape + (-1,)) for s in S], -1)


def time_augment(ys: torch.Tensor, t1: float = 1.0) -> torch.Tensor:
    """Prepend a time channel: (T+1, ..., y) -> (T+1, ..., 1+y)."""
    T = ys.shape[0] - 1
    ts = _linspace(0.0, t1, T + 1, ys.dtype, ys.device)
    tt = ts.reshape((T + 1,) + (1,) * (ys.dim() - 1)).expand(ys.shape[:-1] + (1,))
    return torch.cat([tt, ys], -1)


def signature_mmd(y_p: torch.Tensor, y_q: torch.Tensor, depth: int = 3) -> torch.Tensor:
    """MMD between two path samples (T+1, batch, y) with signature features."""
    fp = signature(time_augment(y_p), depth)
    fq = signature(time_augment(y_q), depth)
    diff = torch.mean(fp, 0) - torch.mean(fq, 0)
    return torch.sqrt(torch.sum(diff * diff) + 1e-12)


def wasserstein_losses(fake_score: torch.Tensor, real_score: torch.Tensor):
    """``(gen_loss, disc_loss) = (−E[fake], E[fake] − E[real])`` (eq. (3))."""
    gen_loss = -torch.mean(fake_score)
    disc_loss = torch.mean(fake_score) - torch.mean(real_score)
    return gen_loss, disc_loss
