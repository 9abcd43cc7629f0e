"""ChangeDetector: Welch's t-test steady-state vs transition classifier.

Port of ``repro/core/change_detector.py``.  Neighbouring observation
windows are compared per feature with Welch's unequal-variance t-test; a
window is a *transition* when the fraction of significantly changed
features reaches a quorum.  The same routine runs on-line (stream), in
batch over a window series, and off-line as the WorkloadDB matcher.

Everything is float32, as in the reference (JAX with x64 off).  The
critical value's constant part (``_erfinv`` of ``1 - alpha``) is formed on
the host in float32 with correctly rounded log and sqrt, so it is the same
number on the CPU and on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.windows import WindowSeries
from repro_torch.kernels.dispatch import resolve_device

_F32 = np.float32


def welch_t(mean1, var1, n1, mean2, var2, n2):
    """Per-feature Welch t statistic and Welch–Satterthwaite dof."""
    v1 = var1 / n1
    v2 = var2 / n2
    denom = torch.sqrt(torch.clamp_min(v1 + v2, 1e-12))
    t = (mean1 - mean2) / denom
    dof = torch.square(v1 + v2) / torch.clamp_min(
        v1 * v1 / max(n1 - 1, 1) + v2 * v2 / max(n2 - 1, 1), 1e-12)
    return t, dof


def _f32_log(v) -> np.float32:
    return _F32(np.log(np.float64(_F32(v))))


def _f32_sqrt(v) -> np.float32:
    return _F32(np.sqrt(np.float64(_F32(v))))


def _erfinv(x: float) -> np.float32:
    """Winitzki's approximation at a host scalar, in float32 — the
    reference's ``_erfinv`` as it evaluates on a Python float: ``jnp.pi``
    and ``a`` enter as Python floats, every array op is float32."""
    a = 0.147
    ln = _f32_log(max(1.0 - x * x, 1e-12))
    t1 = _F32(2.0 / (np.pi * a)) + ln / _F32(2.0)
    return _F32(np.sign(x)) * _f32_sqrt(_f32_sqrt(t1 * t1 - ln / _F32(a)) - t1)


def _t_crit(dof, alpha: float):
    """Two-sided critical value; normal approximation with small-dof
    inflation (Cornish–Fisher style), avoiding a scipy dependency."""
    z = _f32_sqrt(2.0) * _erfinv(1.0 - alpha)
    c1 = z * z + _F32(1.0)
    # a 0-dim tensor numerator keeps this a true division (a Python scalar
    # over a tensor would be computed as a reciprocal times the scalar);
    # filled on the device, not copied from the host, so a monitor step
    # makes no synchronising host-to-device copy
    q = torch.full((), float(c1), dtype=torch.float32,
                   device=dof.device) / (4.0 * torch.clamp_min(dof, 1.0))
    return float(z) * (1.0 + q)


def _sig_quorum(t, dof, mask, alpha: float, quorum: float):
    """(pairs, F) Welch statistics -> per-pair transition flags."""
    sig = torch.abs(t) > _t_crit(dof, alpha)
    nf = sig.shape[-1]
    if mask is not None:
        sig = sig & mask[None, :]
        denom = torch.clamp_min(torch.sum(mask), 1)
    else:
        denom = nf
    return torch.mean(sig.to(torch.float32), dim=-1) * nf / denom >= quorum


def _batch_flags(mean, var, mask, *, n: int, alpha: float, quorum: float):
    """Vectorized neighbour-pair Welch test over a whole window series."""
    t, dof = welch_t(mean[:-1], var[:-1], n, mean[1:], var[1:], n)
    return _sig_quorum(t, dof, mask, alpha, quorum)


def stream_flags(prev_mean, prev_var, mean, var, has_prev: bool, mask, *,
                 n: int, alpha: float, quorum: float):
    """Transition flags for a batch of consecutive windows given the carry
    of the previous window; ``has_prev`` masks the first flag when no
    previous window exists yet."""
    am = torch.cat([prev_mean[None], mean])
    av = torch.cat([prev_var[None], var])
    t, dof = welch_t(am[:-1], av[:-1], n, am[1:], av[1:], n)
    flags = _sig_quorum(t, dof, mask, alpha, quorum)
    if not has_prev:
        flags[0] = False
    return flags


def _as_f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@dataclass
class ChangeDetector:
    alpha: float = 0.01        # per-feature significance
    quorum: float = 0.25       # fraction of features that must change
    feature_mask: np.ndarray | None = None   # optionally ignore features
    device: object = None      # None -> CUDA

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _mask(self):
        return None if self.feature_mask is None else torch.as_tensor(
            np.asarray(self.feature_mask, bool), device=self.device)

    def pair_significant(self, m1, v1, n1, m2, v2, n2):
        """True if windows differ (vector over features -> scalar bool)."""
        d = self.device
        t, dof = welch_t(_as_f32(m1, d), _as_f32(v1, d), n1,
                         _as_f32(m2, d), _as_f32(v2, d), n2)
        return _sig_quorum(t[None], dof[None], self._mask(), self.alpha,
                           self.quorum)[0]

    def online(self, prev, cur):
        """prev/cur: (mean, var, n) tuples for two windows -> bool."""
        (m1, v1, n1), (m2, v2, n2) = prev, cur
        return bool(self.pair_significant(m1, v1, n1, m2, v2, n2))

    def batch(self, ws: WindowSeries) -> np.ndarray:
        """Transition flags for a window series: window t is flagged when
        it differs from window t-1."""
        flags = _batch_flags(_as_f32(ws.mean, self.device),
                             _as_f32(ws.var, self.device), self._mask(),
                             n=ws.count, alpha=self.alpha,
                             quorum=self.quorum)
        return np.concatenate([[False], flags.cpu().numpy()])

    def stream(self, prev, mean, var, n: int) -> np.ndarray:
        """Batched on-line flags: ``prev`` is the (mean, var, n) carry of
        the last emitted window (or None), ``mean``/``var`` are (B, F)."""
        d = self.device
        if prev is None:
            pm = torch.zeros(np.shape(mean)[-1], dtype=torch.float32,
                             device=d)
            pv = pm
        else:
            pm, pv = _as_f32(prev[0], d), _as_f32(prev[1], d)
        flags = stream_flags(pm, pv, _as_f32(mean, d), _as_f32(var, d),
                             prev is not None, self._mask(), n=n,
                             alpha=self.alpha, quorum=self.quorum)
        return flags.cpu().numpy()

    def match_characterization(self, c1: dict, c2: dict) -> bool:
        """Off-line WorkloadDB matcher: same workload if NOT significantly
        different (Algorithm 2)."""
        s1 = np.asarray(c1["std"], np.float32)
        s2 = np.asarray(c2["std"], np.float32)
        return not bool(self.pair_significant(
            c1["mean"], s1 * s1, c1["n"], c2["mean"], s2 * s2, c2["n"]))
