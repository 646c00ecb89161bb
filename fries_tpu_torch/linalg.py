"""Dense linear algebra for subspace iteration, on the host in f64, and a
Lanczos ground state on the device.

Counterpart of ``fries_tpu/linalg.py``.  The subspace matrices are n_trial
x n_trial (a handful of states), so :func:`get_svals`, :func:`gen_eig`,
:func:`inv`, :func:`qr` and the triangular inverses take and return numpy
arrays and run LAPACK on the host: the card and the CPU then share one QR
sign convention, and a restart costs one small host round trip every
``restart_int`` steps.  :func:`lanczos_ground_state` keeps its Krylov basis
on the device of the operator it is given.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import linalg as sla


def get_svals(mat):
    """Singular values, descending."""
    return np.linalg.svd(np.asarray(mat, np.float64), compute_uv=False)


def inv(mat):
    return np.linalg.inv(np.asarray(mat, np.float64))


def qr(mat):
    """Reduced QR factorization (Q, R)."""
    return np.linalg.qr(np.asarray(mat, np.float64))


def gen_eig(h_mat, d_mat):
    """Real generalized eigenproblem h x = lambda d x (non-symmetric, like
    the reference's dggev).  Returns (evals, evecs) sorted by real part."""
    evals, evecs = sla.eig(np.asarray(h_mat, np.float64), np.asarray(d_mat, np.float64))
    order = np.argsort(evals.real)
    return evals[order], evecs[:, order]


def inv_triangular_upper(mat):
    """Inverse of an upper-triangular matrix (a triangular solve)."""
    mat = np.asarray(mat, np.float64)
    return sla.solve_triangular(mat, np.eye(mat.shape[0]), lower=False)


def inv_r_factor(mat):
    """R^-1 of the QR factorization of ``mat``: multiplying a block of
    vectors by R^-1 orthonormalizes it in the QR sense."""
    r = sla.qr(np.asarray(mat, np.float64), mode="r")[0]
    return inv_triangular_upper(r)


def subspace_energies(h_traj, d_traj, burn_in: int = 0):
    """State energies from h/d matrix trajectories: the matrices averaged
    over the iterations after ``burn_in``, then :func:`gen_eig`."""
    h_avg = np.mean(np.asarray(h_traj)[burn_in:], axis=0)
    d_avg = np.mean(np.asarray(d_traj)[burn_in:], axis=0)
    evals, _ = gen_eig(h_avg, d_avg)
    return np.sort(evals.real)


def lanczos_ground_state(matvec, dim: int, m: int = 80, v0=None, seed: int = 0,
                         tol: float = 1e-10, device=None):
    """Matrix-free Lanczos ground state of a symmetric operator.

    ``matvec(v) -> H v`` over float64 tensors of length ``dim`` on
    ``device`` (default: that of ``v0`` when it is a tensor, else the
    CPU).  The Krylov basis is kept and every new vector is
    reorthogonalized against it twice (block Gram-Schmidt), so the lowest
    Ritz value is reliable to about machine precision for a well-separated
    ground state.  ``v0`` defaults to a standard normal vector of
    ``np.random.default_rng(seed)``, the reference's start.  Returns (e0,
    the Ritz vector as a tensor on ``device``)."""
    from scipy.linalg import eigh_tridiagonal

    if device is None:
        device = v0.device if torch.is_tensor(v0) else torch.device("cpu")
    if v0 is None:
        v0 = np.random.default_rng(seed).standard_normal(dim)
    v = torch.as_tensor(v0, dtype=torch.float64, device=device).clone()
    basis = torch.zeros((m + 1, dim), dtype=torch.float64, device=device)
    basis[0] = v / torch.linalg.norm(v)
    alphas, betas = [], []
    for j in range(m):
        w = matvec(basis[j])
        a = float(basis[j] @ w)
        alphas.append(a)
        w = w - a * basis[j]
        if j > 0:
            w = w - betas[-1] * basis[j - 1]
        for _ in range(2):
            w = w - basis[:j + 1].T @ (basis[:j + 1] @ w)
        b = float(torch.linalg.norm(w))
        if b < tol:
            break
        betas.append(b)
        basis[j + 1] = w / b
    evals, evecs = eigh_tridiagonal(alphas, betas[: len(alphas) - 1])
    coeff = torch.as_tensor(evecs[:, 0], dtype=torch.float64, device=device)
    return float(evals[0]), coeff @ basis[:len(alphas)]
