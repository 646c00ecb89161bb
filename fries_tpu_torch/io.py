"""FCIDUMP reading and writing, vector files and npy appends.

Counterpart of the FCIDUMP, vector-reader and npy parts of
``fries_tpu/io.py``: NORB/NELEC/MS2/ORBSYM header, chemist-notation integral
records filled over all 8 symmetry images, MOLPRO -> XOR-group irrep
conversion (``convert_symm``); determinant / value text files and Dice
output (the subspace trial vectors); the Hubbard-Holstein parameter file
(``parse_hh_input``); the HF input directory (``parse_hf_input`` /
``write_hf_dir``); whole-file and last-line numeric readers (``load_rdm``,
``load_last_line``); and ``npy_append`` for the h/d matrix trajectories.
Determinants come back as (N, W) uint32 words, as the reference returns
them.

The FCIDUMP record body, determinant files of masks up to 64 bits and value
files go through the native reader (:mod:`fries_tpu_torch.native`) or a
numpy / Python path, by the reference's switch ``native``: None takes the
native reader when it builds (``FRIES_NATIVE=0`` turns it off), True
requires it, False takes Python.  The first read of each kind logs which
reader ran, and :data:`READS` counts the reads by reader.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path

import numpy as np
import torch

from fries_tpu_torch import dets
from fries_tpu_torch import native as fnative
from fries_tpu_torch.ops import molecule as mol

READS = {"native": 0, "python": 0}
"""Reads by reader (FCIDUMP bodies, determinant and value files)."""
_LOGGED: set = set()


def _reader(native, what: str):
    """The native library for a read of ``what`` under the switch
    ``native`` (None: when it builds; True: required; False: never), or
    None for the Python path."""
    so = None
    if native is not False:
        so, why = fnative.lib()
        if so is None and native is True:
            raise RuntimeError(f"the native {what} reader is unavailable: {why}")
    which = "python" if so is None else "native"
    READS[which] += 1
    if (what, which) not in _LOGGED:
        _LOGGED.add((what, which))
        logging.getLogger(__name__).info("%s: the %s reader", what, which)
    return so

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


def parse_fcidump(path, point_group: str = "C1", device=None, native=None):
    """Parse an FCIDUMP file into (MolecularHamiltonian, core_energy); the
    record body by the native reader or numpy (``native``, as the module
    says)."""
    raw = Path(path).read_bytes()
    header_end = raw.find(b"&END")
    if header_end < 0:
        header_end = raw.find(b"/")
    header = raw[:header_end].decode()
    body_off = raw.find(b"\n", header_end) + 1

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
    so = _reader(native, "FCIDUMP")
    if so is not None:
        hcore, eris_chem, core_energy = fnative.parse_fcidump_body(so, path, body_off, n_orb)
    else:
        hcore, eris_chem, core_energy = _parse_body(raw[body_off:].decode(), n_orb)
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


# ---------------------------------------------------------------------------
# HF-directory input
# ---------------------------------------------------------------------------

def parse_hf_input(hf_dir, device=None):
    """Parse an HF input directory: sys_params.txt (keyed n_elec, n_frozen,
    n_orb, eps, hf_energy), symm.txt, hcore.txt and eris.txt (the dense
    physicist-notation n^4 CSV), frozen orbitals included.  Returns
    (MolecularHamiltonian, {"eps", "hf_energy", "n_frozen"})."""
    hf_dir = Path(hf_dir)
    p = _read_keyed_params(hf_dir / "sys_params.txt",
                           ["n_elec", "n_frozen", "n_orb", "eps", "hf_energy"])
    n_elec, n_frz, n_orb = int(p["n_elec"]), int(p["n_frozen"]), int(p["n_orb"])
    tot = n_orb + n_frz // 2
    # trailing commas ("0,\n") are allowed: parse token by token
    symm = np.asarray((hf_dir / "symm.txt").read_text().replace(",", " ").split(), np.int64)
    hcore = np.genfromtxt(hf_dir / "hcore.txt", delimiter=",").reshape(-1)[:tot * tot]
    eris = np.genfromtxt(hf_dir / "eris.txt", delimiter=",").reshape(-1)[:tot**4]
    ham = mol.MolecularHamiltonian(
        hcore=torch.as_tensor(hcore.reshape(tot, tot), device=device),
        eris=torch.as_tensor(eris.reshape((tot,) * 4), device=device),
        symm=torch.as_tensor(symm[n_frz // 2:], device=device),
        n_orb=n_orb, n_elec=n_elec - n_frz, n_frozen=n_frz)
    return ham, {"eps": float(p["eps"]), "hf_energy": float(p["hf_energy"]),
                 "n_frozen": n_frz}


def write_hf_dir(ham: mol.MolecularHamiltonian, hf_dir, eps: float, hf_energy: float):
    """Write an HF input directory that :func:`parse_hf_input` reads back
    (symm.txt covers every orbital, frozen ones with irrep 0; ``hf_energy``
    is the electronic HF energy)."""
    hf_dir = Path(hf_dir)
    hf_dir.mkdir(parents=True, exist_ok=True)
    tot, n_frz = ham.tot_orb, ham.n_frozen
    (hf_dir / "sys_params.txt").write_text(
        f"n_elec\n{ham.n_elec + n_frz}\nn_frozen\n{n_frz}\n"
        f"n_orb\n{ham.n_orb}\neps\n{eps}\nhf_energy\n{hf_energy:.10f}\n")
    symm_full = np.zeros(tot, np.int64)
    symm_full[n_frz // 2:] = ham.symm.cpu().numpy()
    np.savetxt(hf_dir / "symm.txt", symm_full, fmt="%d")
    np.savetxt(hf_dir / "hcore.txt", ham.hcore.cpu().numpy(), delimiter=",")
    np.savetxt(hf_dir / "eris.txt", ham.eris.cpu().numpy().reshape(tot * tot, tot * tot),
               delimiter=",")


# ---------------------------------------------------------------------------
# vector files
# ---------------------------------------------------------------------------

def _read_keyed_params(path, keys):
    """A file of alternating key and value lines -> {key: value string};
    raises when one of ``keys`` is missing."""
    lines = [l.strip() for l in Path(path).read_text().splitlines() if l.strip()]
    out = {lines[i]: lines[i + 1] for i in range(0, len(lines) - 1, 2)}
    missing = [k for k in keys if k not in out]
    if missing:
        raise ValueError(f"missing parameters {missing} in {path}")
    return out


def parse_hh_input(path):
    """A Hubbard-Holstein parameter file -> {n_elec, lat_len, n_dim, eps, u,
    omega, g, gs_energy}.  The energy origin is ``gs_energy``, or
    ``hf_energy`` as some files spell it (0 when neither is given)."""
    p = _read_keyed_params(path, ["n_elec", "lat_len", "n_dim", "eps", "U", "omega", "g"])
    return {
        "n_elec": int(p["n_elec"]),
        "lat_len": int(p["lat_len"]),
        "n_dim": int(p["n_dim"]),
        "eps": float(p["eps"]),
        "u": float(p["U"]),
        "omega": float(p["omega"]),
        "g": float(p["g"]),
        "gs_energy": float(p.get("gs_energy", p.get("hf_energy", 0.0))),
    }


def read_dets(path, n_bits, native=None):
    """Determinants stored as decimal bit masks, one per line -> (N, W)
    uint32 words, for any width: masks of at most 64 bits by the native
    reader's u64 parse (``native``, as the module says), wider ones as
    Python ints."""
    n_words = dets.n_words(n_bits)
    so = _reader(native, "determinant") if n_bits <= 64 else None
    if so is not None:
        masks = fnative.parse_u64(so, path)
        return np.stack([(masks >> np.uint64(32 * w)).astype(np.uint32)
                         for w in range(n_words)], -1).reshape(-1, n_words)
    masks = [int(x) for x in Path(path).read_text().split()]
    return np.asarray([[(m >> (32 * w)) & dets.WORD_MASK for w in range(n_words)]
                       for m in masks], np.uint32).reshape(-1, n_words)


def _read_floats(path, native=None):
    """Every whitespace-separated float of a file, by the native reader or
    numpy (``native``, as the module says)."""
    so = _reader(native, "value")
    if so is not None:
        return fnative.parse_doubles(so, path)
    return np.asarray(Path(path).read_text().split(), np.float64)


def load_vec_txt(prefix, n_bits, native=None):
    """<prefix>dets + <prefix>vals text files -> (keys (N, W), vals (N,))."""
    keys = read_dets(str(prefix) + "dets", n_bits, native)
    vals = _read_floats(str(prefix) + "vals", native)
    n = min(len(keys), len(vals))
    return keys[:n], vals[:n]


def save_vec_txt(prefix, keys, vals, n_bits):
    """Write (keys (N, W) words, vals) as <prefix>dets / <prefix>vals."""
    keys = np.asarray(keys)
    with open(str(prefix) + "dets", "w") as f:
        for row in keys:
            f.write(f"{sum(int(x) << (32 * w) for w, x in enumerate(row))}\n")
    with open(str(prefix) + "vals", "w") as f:
        for v in np.asarray(vals):
            f.write(f"{float(v)!r}\n")


def load_vec_dice(path, n_orb, n_bits, state: int = 0):
    """One state's determinants from a Dice/SHCI output file: orbital
    strings of '2' (doubly occupied), 'a' / 'b' (alpha / beta) and '0';
    coefficients below 1e-6 are dropped."""
    lines = Path(path).read_text().splitlines()
    state_rows = [i for i, l in enumerate(lines) if l.startswith("State :")]
    if state >= len(state_rows):
        raise ValueError(f"state {state} not found in {path}")
    start = state_rows[state] + 1
    end = state_rows[state + 1] if state + 1 < len(state_rows) else len(lines)
    n_words = dets.n_words(n_bits)
    keys, vals = [], []
    for line in lines[start:end]:
        parts = line.split()
        if len(parts) < 3:
            continue
        try:
            val = float(parts[1])
        except ValueError:
            continue
        if abs(val) < 1e-6:
            continue
        mask, orb = 0, 0
        for ch in "".join(parts[2:]):
            if ch == "2":
                mask |= (1 << orb) | (1 << (orb + n_orb))
            elif ch == "a":
                mask |= 1 << orb
            elif ch == "b":
                mask |= 1 << (orb + n_orb)
            elif ch != "0":
                continue
            orb += 1
        keys.append([(mask >> (32 * w)) & dets.WORD_MASK for w in range(n_words)])
        vals.append(val)
    return (np.asarray(keys, np.uint32).reshape(-1, n_words),
            np.asarray(vals, np.float64))


def load_rdm(path, native=None):
    """Every whitespace-separated number of a file as a flat f64 array."""
    return _read_floats(path, native)


def load_last_line(path):
    """The last nonblank line of a comma-separated stream as f64 values
    (empty when the file has none)."""
    lines = [l for l in Path(path).read_text().splitlines() if l.strip()]
    return np.asarray(lines[-1].split(",") if lines else [], np.float64)


# ---------------------------------------------------------------------------
# npy append
# ---------------------------------------------------------------------------

_NPY_HEADER_LEN = 128  # fixed so the shape can be rewritten in place


def _npy_write_header(f, dtype, shape):
    magic = b"\x93NUMPY\x01\x00"
    hdr = ("{'descr': '%s', 'fortran_order': False, 'shape': %s, }"
           % (np.lib.format.dtype_to_descr(dtype), repr(tuple(shape))))
    pad = _NPY_HEADER_LEN - len(magic) - 2 - len(hdr) - 1
    if pad < 0:
        raise ValueError("npy header too long")
    f.write(magic)
    f.write(np.uint16(_NPY_HEADER_LEN - len(magic) - 2).tobytes())
    f.write((hdr + " " * pad + "\n").encode("latin1"))


def npy_append(path, arr):
    """Append ``arr`` as one record along the leading axis of the .npy file
    at ``path`` (created with shape (1,) + arr.shape); loads with
    ``np.load``."""
    arr = np.ascontiguousarray(arr)
    if not Path(path).exists():
        with open(path, "wb") as f:
            _npy_write_header(f, arr.dtype, (1,) + arr.shape)
            f.write(arr.tobytes())
        return
    with open(path, "r+b") as f:
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = np.lib.format._read_array_header(f, version)
        if fortran or dtype != arr.dtype or tuple(shape[1:]) != arr.shape:
            raise ValueError(
                f"npy_append: existing {path} has shape {shape} dtype {dtype},"
                f" incompatible with record {arr.shape} {arr.dtype}")
        f.seek(0)
        _npy_write_header(f, arr.dtype, (shape[0] + 1,) + arr.shape)
        f.seek(0, 2)
        f.write(arr.tobytes())
