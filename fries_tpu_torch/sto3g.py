"""Minimal-basis (STO-3G, s-type) molecular integrals for hydrogen systems.

Counterpart of ``fries_tpu/sto3g.py``: closed-form contracted-Gaussian
s-orbital integrals (overlap, kinetic, nuclear attraction, ERIs; the
McMurchie-Davidson formulas at l = 0, Szabo & Ostlund appendix A) for H_n
geometries, a damped closed-shell Roothaan RHF, and the H-chain
Hamiltonian in a Löwdin-orthogonalized or canonical RHF basis.  The
primitive sums run as broadcast tensor operations in float64 on the
device given (entry points default to the card).

Anchor: H2 at R = 1.4 bohr in STO-3G has the textbook FCI total energy
-1.13728 Ha (Szabo & Ostlund Table 3.15: E_HF = -1.11671, E_corr =
-0.02056).
"""

from __future__ import annotations

import numpy as np
import torch

from fries_tpu_torch.ops import molecule as mol

F64 = torch.float64

# STO-3G hydrogen 1s: exponents (zeta=1.24 scaled) and contraction coeffs
_H_EXPS = np.array([3.42525091, 0.62391373, 0.16885540])
_H_COEFS = np.array([0.15432897, 0.53532814, 0.44463454])


def _f0(x):
    """Boys function F0(x) = (1/2) sqrt(pi/x) erf(sqrt(x)), F0(0) = 1."""
    small = x < 1e-12
    xs = torch.where(small, 1.0, x)
    return torch.where(small, 1.0, 0.5 * torch.sqrt(np.pi / xs) * torch.special.erf(torch.sqrt(xs)))


def _prims(centers, device):
    """Contracted s-AOs as primitive tensors (alpha, center, coef including
    the primitive normalization (2a/pi)^(3/4)), AO-major, 3 per AO."""
    n = len(centers)
    alphas = np.tile(_H_EXPS, n)
    coefs = np.tile(_H_COEFS * (2.0 * _H_EXPS / np.pi) ** 0.75, n)
    cents = np.repeat(centers, len(_H_EXPS), axis=0)
    t = lambda x: torch.tensor(x, dtype=F64, device=device)
    return t(alphas), t(cents), t(coefs)


def integrals(centers, charges=None, device="cuda"):
    """AO-basis (S, T, V, ERI-chemist) for s-type STO-3G functions at
    ``centers`` ((n, 3) bohr) with nuclear ``charges`` (default all 1)."""
    centers = np.atleast_2d(np.asarray(centers, float))
    n = len(centers)
    charges = np.ones(n) if charges is None else np.asarray(charges, float)
    al, ce, co = _prims(centers, device)
    k3 = len(_H_EXPS)
    a, b = al[:, None], al[None, :]
    p = a + b
    ab2 = ((ce[:, None, :] - ce[None, :, :]) ** 2).sum(-1)
    k = torch.exp(-a * b / p * ab2)
    s_p = (np.pi / p) ** 1.5 * k
    t_p = a * b / p * (3.0 - 2.0 * a * b / p * ab2) * s_p
    pc = (a[..., None] * ce[:, None, :] + b[..., None] * ce[None, :, :]) / p[..., None]
    v_p = torch.zeros_like(s_p)
    for cc, z in zip(torch.tensor(centers, dtype=F64, device=device), charges):
        pc2 = ((pc - cc) ** 2).sum(-1)
        v_p = v_p - z * 2.0 * np.pi / p * k * _f0(p * pc2)
    w = co[:, None] * co[None, :]
    contract = lambda m: (w * m).reshape(n, k3, n, k3).sum((1, 3))

    # (ij|kl) chemist ERIs over primitive pairs (i, j) x (k, l), contracted
    q = p.reshape(-1)
    qcen = pc.reshape(-1, 3)
    kq = (k * w).reshape(-1)
    pq2 = ((qcen[:, None, :] - qcen[None, :, :]) ** 2).sum(-1)
    p1, p2 = q[:, None], q[None, :]
    val = (2.0 * np.pi ** 2.5 / (p1 * p2 * torch.sqrt(p1 + p2))
           * kq[:, None] * kq[None, :] * _f0(p1 * p2 / (p1 + p2) * pq2))
    eri = val.reshape(n, k3, n, k3, n, k3, n, k3).sum((1, 3, 5, 7))
    return contract(s_p), contract(t_p), contract(v_p), eri


def nuclear_repulsion(centers, charges=None):
    centers = np.atleast_2d(np.asarray(centers, float))
    n = len(centers)
    charges = np.ones(n) if charges is None else charges
    e = 0.0
    for i in range(n):
        for j in range(i):
            e += charges[i] * charges[j] / np.linalg.norm(centers[i] - centers[j])
    return e


def rhf(s, hcore_ao, eri_chem, n_elec, max_iter=300, tol=1e-10, damp=0.3):
    """Closed-shell restricted Hartree-Fock in the AO basis (tensors on one
    device).  Returns (C, e_hf_electronic): MO coefficients (AO x MO,
    occupied first) and the converged electronic HF energy.  Plain
    Roothaan iterations with density damping."""
    n_occ = n_elec // 2
    evals, evecs = torch.linalg.eigh(s)
    x = evecs @ torch.diag(evals ** -0.5) @ evecs.T
    c = None
    d = torch.zeros_like(s)
    e_old = 0.0
    for it in range(max_iter):
        g = (torch.einsum("ijkl,kl->ij", eri_chem, d)
             - 0.5 * torch.einsum("ikjl,kl->ij", eri_chem, d))
        f = hcore_ao + g
        e_el = float(0.5 * torch.sum(d * (hcore_ao + f)))
        _, cp = torch.linalg.eigh(x.T @ f @ x)
        c = x @ cp
        d_new = 2.0 * c[:, :n_occ] @ c[:, :n_occ].T
        d = d_new if it == 0 else (1.0 - damp) * d_new + damp * d
        if abs(e_el - e_old) < tol and it > 1:
            break
        e_old = e_el
    return c, e_el


def h_chain(bond_length: float, n_atoms: int = 2, basis: str = "lowdin", device="cuda"):
    """Linear H_n chain at uniform ``bond_length`` (bohr) ->
    (MolecularHamiltonian, core_energy).  ``basis="lowdin"`` uses
    symmetric-orthogonalized AOs (S^{-1/2}; no SCF, FCI energy identical);
    ``basis="rhf"`` canonical RHF molecular orbitals.  eris physicist
    ``<pq|rs>``."""
    centers = np.zeros((n_atoms, 3))
    centers[:, 2] = bond_length * np.arange(n_atoms)
    s, t, v, eri_chem = integrals(centers, device=device)
    if basis == "rhf":
        x, _ = rhf(s, t + v, eri_chem, n_atoms)
    else:
        evals, evecs = torch.linalg.eigh(s)
        x = evecs @ torch.diag(evals ** -0.5) @ evecs.T  # Löwdin S^{-1/2}
    hcore = x.T @ (t + v) @ x
    eri = torch.einsum("ijkl,ip,jq,kr,ls->pqrs", eri_chem, x, x, x, x)
    ham = mol.MolecularHamiltonian(
        hcore=hcore.contiguous(), eris=eri.permute(0, 2, 1, 3).contiguous(),
        symm=torch.zeros(n_atoms, dtype=torch.int64, device=hcore.device),
        n_orb=n_atoms, n_elec=n_atoms)
    return ham, nuclear_repulsion(centers)
