"""FCIDUMP reading and writing.

Counterpart of the FCIDUMP part of ``fries_tpu/io.py``: NORB/NELEC/MS2/ORBSYM
header, chemist-notation integral records filled over all 8 symmetry images,
and MOLPRO -> XOR-group irrep conversion (``convert_symm``).  The record body
is parsed with numpy alone.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from fries_tpu_torch.ops import molecule as mol

# MOLPRO irrep label (1-based) -> XOR-group label, per point group
_SYMM_MAPS = {
    "d2h": [0, 7, 6, 1, 5, 2, 3, 4],
    "c2v": [0, 2, 3, 1],
    "c2h": [0, 2, 3, 1],
    "d2": [0, 3, 2, 1],
    "cs": [0, 1],
    "c2": [0, 1],
    "ci": [0, 1],
    "c1": [0],
}


def convert_symm(labels: np.ndarray, point_group: str) -> np.ndarray:
    pg = point_group.lower()
    if pg not in _SYMM_MAPS:
        raise ValueError(f"point group {point_group} not recognized")
    mapping = _SYMM_MAPS[pg]
    labels = np.asarray(labels, np.int64)
    if labels.min() < 1 or labels.max() > len(mapping):
        raise ValueError(
            f"irrep label out of range 1..{len(mapping)} for {point_group}")
    return np.asarray([mapping[l - 1] for l in labels], np.int64)


def invert_symm(labels: np.ndarray, point_group: str) -> np.ndarray:
    """XOR-group labels -> MOLPRO 1-based labels."""
    inv = {v: i + 1 for i, v in enumerate(_SYMM_MAPS[point_group.lower()])}
    return np.asarray([inv[int(l)] for l in labels], np.int64)


def _parse_body(body: str, n_orb: int):
    """Integral records -> (hcore, chemist eris, core energy)."""
    rec = np.asarray(body.split(), dtype=object)
    rec = rec[: len(rec) // 5 * 5].reshape(-1, 5)
    val = rec[:, 0].astype(np.float64)
    idx = rec[:, 1:].astype(np.int64)
    i, j, k, l = idx.T
    hcore = np.zeros((n_orb, n_orb))
    eris = np.zeros((n_orb,) * 4)
    core = (i == 0) & (j == 0) & (k == 0) & (l == 0)
    core_energy = float(val[core][-1]) if core.any() else 0.0
    one = (~core) & (k == 0) & (l == 0) & (j != 0)
    hcore[i[one] - 1, j[one] - 1] = val[one]
    hcore[j[one] - 1, i[one] - 1] = val[one]
    two = (k != 0) & (l != 0)
    a, b, c, d, v = i[two] - 1, j[two] - 1, k[two] - 1, l[two] - 1, val[two]
    for p, q in ((a, b), (b, a)):
        for r, s in ((c, d), (d, c)):
            eris[p, q, r, s] = v
            eris[r, s, p, q] = v
    return hcore, eris, core_energy


def parse_fcidump(path, point_group: str = "C1", device=None):
    """Parse an FCIDUMP file into (MolecularHamiltonian, core_energy)."""
    raw = Path(path).read_text()
    header_end = raw.find("&END")
    if header_end < 0:
        header_end = raw.find("/")
    header = raw[:header_end]
    body = raw[raw.find("\n", header_end) + 1:]

    def field(name):
        m = re.search(name + r"\s*=\s*([0-9]+)", header)
        return int(m.group(1)) if m else None

    n_orb, n_elec, ms2 = field("NORB"), field("NELEC"), field("MS2")
    if ms2 not in (None, 0):
        raise ValueError("MS2 != 0 not supported")
    m = re.search(r"ORBSYM\s*=\s*([0-9,\s]+)", header)
    orbsym = [int(x) for x in m.group(1).replace("\n", " ").split(",") if x.strip()]
    if len(orbsym) != n_orb:
        raise ValueError("ORBSYM length does not match NORB")
    symm = convert_symm(np.asarray(orbsym), point_group)
    hcore, eris_chem, core_energy = _parse_body(body, n_orb)
    eris_phys = np.ascontiguousarray(np.transpose(eris_chem, (0, 2, 1, 3)))
    ham = mol.MolecularHamiltonian(
        hcore=torch.as_tensor(hcore, device=device),
        eris=torch.as_tensor(eris_phys, device=device),
        symm=torch.as_tensor(symm, device=device),
        n_orb=n_orb,
        n_elec=n_elec,
    )
    return ham, core_energy


def write_fcidump(ham: mol.MolecularHamiltonian, path, point_group: str = "C1",
                  core_energy: float = 0.0, threshold: float = 0.0):
    """Write the unique chemist-notation integrals of a Hamiltonian (a frozen
    core is downfolded into the active space first)."""
    n = ham.tot_orb
    h = ham.hcore.cpu().numpy()
    eris_chem = np.transpose(ham.eris.cpu().numpy(), (0, 2, 1, 3))
    if ham.n_frozen:
        f = ham.n_frozen // 2
        core_energy = core_energy + 2.0 * np.trace(h[:f, :f]) + (
            2.0 * np.einsum("iijj->", eris_chem[:f, :f, :f, :f])
            - np.einsum("ijji->", eris_chem[:f, :f, :f, :f]))
        h = (h + 2.0 * np.einsum("pqii->pq", eris_chem[:, :, :f, :f])
             - np.einsum("piiq->pq", eris_chem[:, :f, :f, :]))[f:, f:]
        eris_chem = eris_chem[f:, f:, f:, f:]
        n = ham.n_orb
    orbsym = invert_symm(ham.symm.cpu().numpy(), point_group)
    pair = lambda a, b: (max(a, b) * (max(a, b) + 1)) // 2 + min(a, b)
    with open(path, "w") as out:
        out.write(
            f"&FCI NORB={n},NELEC={ham.n_elec},MS2=0,\n"
            "ORBSYM=" + ",".join(str(int(s)) for s in orbsym) + ",\n"
            "ISYM=1,\n&END\n")
        for i in range(n):
            for j in range(i + 1):
                p1 = pair(i, j)
                for k in range(n):
                    for l in range(k + 1):
                        if pair(k, l) > p1:
                            continue
                        v = eris_chem[i, j, k, l]
                        if abs(v) > threshold:
                            out.write(f"{v:.16e} {i+1} {j+1} {k+1} {l+1}\n")
        for i in range(n):
            for j in range(i + 1):
                if abs(h[i, j]) > threshold:
                    out.write(f"{h[i, j]:.16e} {i+1} {j+1} 0 0\n")
        out.write(f"{core_energy:.16e} 0 0 0 0\n")
