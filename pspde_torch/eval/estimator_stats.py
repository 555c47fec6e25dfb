"""Single-pass loss-estimator statistics (counterpart of
``pspde/eval/estimator_stats.py``, the "Compare relative errors of losses"
notebook): roll the forward process out once without gradients and
compare the statistical relative errors of the cross-entropy-type
estimators, which grow ~ c^d in the dimension, with the log-variance
estimator's, which does not (BASELINE.md, last row).

The ensemble runs in ``n_chunks`` rollouts one after another; each reduces
on the device to 13 float32 column sums, accumulated in float64 on the
host, so K is bounded by time, not by memory.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..rollout.sde import HJBRolloutConfig, hjb_rollout


class _NegH:
    """The problem with h negated: the notebook accumulates Y with +h, as
    it studies the estimators' integrand, not the trained solver."""

    def __init__(self, problem):
        self._p = problem
        self.T = problem.T
        self.sigma_struct = problem.sigma_struct

    def b(self, x):
        return self._p.b(x)

    def running_cost(self, x, t):
        return self._p.running_cost(x, t)

    def g(self, x):
        return self._p.g(x)

    def h(self, t, x, y, z):
        return -self._p.h(t, x, y, z)


@torch.no_grad()
def loss_estimator_statistics(problem, control_fn: Callable, K: int,
                              delta_t: float,
                              generator: Optional[torch.Generator] = None,
                              outlier_cutoff: float = 100.0,
                              adaptive: bool = False, detach: bool = False,
                              n_chunks: int = 1,
                              noise_fn: Optional[Callable] = None
                              ) -> Dict[str, float]:
    """Means and variances of the plain weight exp(-g), the naive
    cross-entropy estimator Y exp(-g), the detached reweighting Y exp(-g +
    Y) and its outlier-filtered version (|.| < ``outlier_cutoff``), and the
    log-variance loss value (its variance from the fourth central moment).
    ``control_fn`` (X, n, t) -> (Z, None).  Chunk c of ceil(K / n_chunks)
    paths draws its noise from ``generator``, or takes ``noise_fn(c, n)``
    at step n."""
    N = int(np.floor(problem.T / delta_t))
    Kc = -(-K // n_chunks)
    neg = _NegH(problem)
    cfg = HJBRolloutConfig(N=N, delta_t=delta_t, adaptive_forward=adaptive,
                           detach_forward=detach, track_u_l2=False)
    dev = problem.X_0.device

    def chunk_sums(c):
        X0 = problem.X_0.to(torch.float32).expand(Kc, problem.d)
        out = hjb_rollout(cfg, neg, control_fn, X0,
                          torch.zeros((Kc,), device=dev),
                          generator=generator,
                          noise_fn=(None if noise_fn is None
                                    else lambda n: noise_fn(c, n)))
        Y, gX = out.Y, problem.g(out.X)
        w = torch.exp(-gX)
        ce = Y * w
        ced = Y * torch.exp(-gX + Y)
        mask = (torch.abs(ced) < outlier_cutoff).to(torch.float32)
        r = Y - gX
        cols = torch.stack([w, w * w, ce, ce * ce, ced, ced * ced,
                            ced * mask, mask, ced * ced * mask,
                            r, r * r, r ** 3, r ** 4], dim=-1)
        return torch.sum(cols, dim=0)

    sums = np.zeros(13, dtype=np.float64)
    for c in range(n_chunks):
        sums += chunk_sums(c).cpu().numpy().astype(np.float64)
    n = float(n_chunks * Kc)

    def mean_var(s1, s2, count=n):
        mu = s1 / count
        var = (s2 / count - mu * mu) * count / max(count - 1.0, 1.0)
        return mu, var

    m_w, v_w = mean_var(sums[0], sums[1])
    m_ce, v_ce = mean_var(sums[2], sums[3])
    m_ced, v_ced = mean_var(sums[4], sums[5])
    n_sel = max(sums[7], 1.0)
    m_sel, v_sel = mean_var(sums[6], sums[8], n_sel)
    m_r = sums[9] / n
    # central moments of r from its raw moments
    c2 = sums[10] / n - m_r ** 2
    c4 = (sums[12] / n - 4 * m_r * sums[11] / n
          + 6 * m_r ** 2 * sums[10] / n - 3 * m_r ** 4)
    var_r = c2 * n / max(n - 1.0, 1.0)
    return {
        "mean_g": m_w, "var_g": v_w,
        "mean_CE": m_ce, "var_CE": v_ce,
        "mean_CE_detach": m_ced, "var_CE_detach": v_ced,
        "mean_CE_detach_selection": abs(m_sel),
        "std_CE_detach_selection": float(np.sqrt(max(v_sel, 0.0))),
        "mean_var": var_r,
        "var_var": c4 - var_r ** 2,
    }


def relative_error(stats: Dict[str, float], which: str) -> float:
    """sqrt(var_which) / |mean_which| of ``loss_estimator_statistics``."""
    return float(np.sqrt(max(stats[f"var_{which}"], 0.0))
                 / abs(stats[f"mean_{which}"]))


__all__ = ["loss_estimator_statistics", "relative_error"]
