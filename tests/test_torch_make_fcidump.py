"""The port's FCIDUMP writer (``fries_tpu_torch.make_fcidump``) against
``tools/make_fcidump.py`` for LiH, H4 and water with one frozen core: the
header, NORB, NELEC and the core energy equal; the integrals equal to 1e-10
once the port's MOs are carried onto the script's by
``scf.gauge_alignment`` (MO signs: both RHF solutions of the same AO
integrals); dense-FCI E0 from each file equal to 1e-9; the command line, without a
card and with ``--frozen`` on an H chain."""

import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu import gto as jgto  # noqa: E402
from fries_tpu import sto3g as jsto3g  # noqa: E402
from fries_tpu_torch import gto, io, make_fcidump, scf, sto3g  # noqa: E402

import dense_fci  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {"lih": [], "h4": [], "water": ["--frozen", "1"]}
GEOMETRY = {"lih": (("Li", "H"), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 3.015]])),
            "water": gto.WATER_GEOM}


def script_main(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "tools_make_fcidump", os.path.join(REPO, "tools", "make_fcidump.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["make_fcidump.py", *argv])
    mod.main()


@pytest.fixture(scope="module", params=sorted(CASES))
def files(request, tmp_path_factory):
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    with pytest.MonkeyPatch.context() as mp:
        script_main([name, "--out", str(tmp / "script"), *CASES[name]], mp)
    make_fcidump.main([name, "--out", str(tmp / "port"), *CASES[name], "--device", "cpu"])
    return name, tmp / "script", tmp / "port"


def header(path):
    text = path.read_text()
    return text[:text.index("&END")]


def test_header_and_core(files):
    _, ref, got = files
    assert header(got) == header(ref)
    (hr, cr), (hg, cg) = io.parse_fcidump(ref), io.parse_fcidump(got)
    assert (hg.n_orb, hg.n_elec) == (hr.n_orb, hr.n_elec)
    assert abs(cg - cr) < 1e-10


def mo_coefficients(name):
    """(port C, script C, AO overlap, MO energies) of the system's RHF in
    both packages, from the AO integrals."""
    if name in GEOMETRY:
        sym, cen = GEOMETRY[name]
        s, t, v, eri, _ = gto.integrals(sym, cen, device="cpu")
        js, jt, jv, jeri, _ = jgto.integrals(sym, cen)
        n_elec = sum(gto.BASIS[x][0] for x in sym)
    else:
        n = int(name[1:])
        cen = np.zeros((n, 3))
        cen[:, 2] = 1.8 * np.arange(n)
        s, t, v, eri = sto3g.integrals(cen, device="cpu")
        js, jt, jv, jeri = (np.asarray(x) for x in jsto3g.integrals(cen))
        n_elec = n
    c, _ = sto3g.rhf(s, t + v, eri, n_elec)
    jc, _ = jsto3g.rhf(np.asarray(js), np.asarray(jt) + np.asarray(jv), np.asarray(jeri),
                       n_elec)
    d = 2.0 * c[:, :n_elec // 2] @ c[:, :n_elec // 2].T
    f = t + v + torch.einsum("ijkl,kl->ij", eri, d) - 0.5 * torch.einsum("ikjl,kl->ij", eri, d)
    return c, torch.as_tensor(np.asarray(jc)), s, torch.diagonal(c.T @ f @ c)


def test_integrals_after_gauge_alignment(files):
    name, ref, got = files
    c, jc, s, mo_e = mo_coefficients(name)
    o, off = scf.gauge_alignment(c, jc, s, mo_e, np.zeros(len(mo_e), int))
    assert off < 1e-8
    f = int(dict(zip(CASES[name][::2], CASES[name][1::2])).get("--frozen", 0))
    o = o[f:, f:]
    (hr, _), (hg, _) = io.parse_fcidump(ref), io.parse_fcidump(got)
    h, eris = scf.rotate_mo_integrals(hg.hcore, hg.eris, o)
    torch.testing.assert_close(h, hr.hcore, rtol=0, atol=1e-10)
    torch.testing.assert_close(eris, hr.eris, rtol=0, atol=1e-10)


def test_dense_fci_energies(files):
    _, ref, got = files
    e = []
    for path in (ref, got):
        ham, core = io.parse_fcidump(path)
        n_a = ham.n_elec // 2
        h, _ = dense_fci.build_hamiltonian(ham.hcore.numpy(), ham.eris.numpy(), ham.n_orb,
                                           n_a, ham.n_elec - n_a)
        e.append(np.linalg.eigvalsh(h)[0] + core)
    assert abs(e[0] - e[1]) < 1e-9


def test_command_line(tmp_path, capsys):
    assert make_fcidump.main(["h4", "--out", str(tmp_path / "f"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(f"wrote {tmp_path / 'f'}: NORB=4 NELEC=4 core=")
    with pytest.raises(SystemExit, match="no core to freeze"):
        make_fcidump.main(["h4", "--out", str(tmp_path / "g"), "--frozen", "1", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            make_fcidump.main(["water", "--out", str(tmp_path / "h")])
        assert not (tmp_path / "h").exists()
