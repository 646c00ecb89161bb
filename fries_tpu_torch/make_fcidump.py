"""Write a real molecule's FCIDUMP from the port's own STO-3G integrals
(:mod:`fries_tpu_torch.gto`, :mod:`fries_tpu_torch.sto3g`), so that every
CLI workload runs on a real molecule, as the reference's production
workflow reads FCIDUMPs:

    python -m fries_tpu_torch.make_fcidump water --out FCIDUMP_h2o
    python -m fries_tpu_torch.cli frisys_mol --fcidump_path FCIDUMP_h2o ...

Systems: ``water`` (7 orbitals, 10 electrons), ``n2`` (10, 14; r 2.074
bohr), ``lih`` (6, 4; r 3.015 bohr), ``h<N>`` chains on RHF orbitals (r 1.8
bohr).  ``--frozen`` folds that many doubly occupied core orbitals into the
core energy (H chains have no core and refuse it).

Counterpart of ``tools/make_fcidump.py``, with its systems, flags and
printed line.  The integrals are built on the card unless ``--device cpu``
is given; without a card the command stops.
"""

from __future__ import annotations

import argparse
import sys

from fries_tpu_torch import cli, gto, io, sto3g


def build(name: str, r=None, frozen: int = 0, device="cuda"):
    """(MolecularHamiltonian, core energy) of a system of the module's
    table on ``device``."""
    name = name.lower()
    if name == "water":
        return gto.water(n_frozen=frozen, device=device)
    if name == "n2":
        return gto.n2(r=r or 2.074, n_frozen=frozen, device=device)
    if name == "lih":
        return gto.lih(r=r or 3.015, n_frozen=frozen, device=device)
    if name.startswith("h") and name[1:].isdigit():
        if frozen:
            raise SystemExit("H chains have no core to freeze (--frozen 0)")
        return sto3g.h_chain(r or 1.8, int(name[1:]), basis="rhf", device=device)
    raise SystemExit(f"unknown system {name!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m fries_tpu_torch.make_fcidump",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("system", help="water | n2 | lih | h<N> (H chain)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--r", type=float, default=None, help="bond length (bohr); default per system")
    ap.add_argument("--frozen", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ham, core = build(args.system, args.r, args.frozen, cli._device(args))
    io.write_fcidump(ham, args.out, core_energy=core)
    print(f"wrote {args.out}: NORB={ham.n_orb} NELEC={ham.n_elec} core={core:.9f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
