"""Trajectory statistics of the projected-energy streams.

The port's copy of ``fries_tpu/stats.py`` (numpy only, so the port's tools
need nothing of the JAX package): the mean projected-energy error +- 2 sigma
(mEh) and the statistical efficiency 1 / (variance * integrated
autocorrelation time) of projnum / projden.  The integrated autocorrelation
time is emcee's ``integrated_time`` (FFT autocorrelation, Sokal's adaptive
window, c = 2).
"""

from __future__ import annotations

import numpy as np


def autocorr_fft(x: np.ndarray) -> np.ndarray:
    """Normalized autocorrelation function via FFT (emcee.autocorr.function_1d)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = 1 << (2 * len(x) - 1).bit_length()
    xc = x - x.mean()
    f = np.fft.fft(xc, n=n)
    acf = np.fft.ifft(f * np.conjugate(f))[: len(x)].real
    if acf[0] == 0:
        return np.zeros_like(acf)
    return acf / acf[0]


def integrated_time(x: np.ndarray, c: float = 2.0) -> float:
    """Sokal-windowed integrated autocorrelation time (emcee semantics):
    tau(M) = 1 + 2 sum_{k<=M} rho_k with the smallest window M >= c*tau(M)."""
    rho = autocorr_fft(x)
    taus = 2.0 * np.cumsum(rho) - 1.0
    m = np.arange(len(taus))
    win = m >= c * taus
    if win.any():
        return float(taus[np.argmax(win)])
    return float(taus[-1])


def trajectory_stats(proj_num, proj_den, exact_corr: float | None = None,
                     burn_in: int = 0, c: float = 2.0) -> dict:
    """Reference calc_stats.py pipeline.

    Returns dict(e_corr, error_mEh (vs exact if given), two_sigma_mEh,
    iat, efficiency).
    """
    proj_num = np.asarray(proj_num, dtype=np.float64)
    proj_den = np.asarray(proj_den, dtype=np.float64)
    n = min(len(proj_num), len(proj_den))
    proj_num = proj_num[burn_in:n]
    proj_den = proj_den[burn_in:n]
    num_mean = proj_num.mean()
    den_mean = proj_den.mean()
    # linearized energy-estimator trajectory (calc_stats.py:24)
    corr_traj = proj_num / den_mean - num_mean * proj_den / den_mean**2
    iat = max(integrated_time(corr_traj, c=c), 1.0)
    var = corr_traj.var()
    e_corr = num_mean / den_mean
    se = np.sqrt(var * iat / len(proj_den))
    out = {
        "e_corr": float(e_corr),
        "two_sigma_mEh": float(2e3 * se),
        "iat": float(iat),
        "efficiency": float(1.0 / max(var * iat, 1e-300)),
    }
    if exact_corr is not None:
        out["error_mEh"] = float((e_corr - exact_corr) * 1e3)
    return out
