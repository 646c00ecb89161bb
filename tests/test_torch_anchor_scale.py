"""The port's exact anchor (``fries_tpu_torch.anchor_scale``) against
``tools/anchor_scale.py`` on the same ``synth.make_system`` (the JAX
package's, carried across by ``convert``): the enumerated basis word for
word, H v on three seeded vectors (rtol 1e-12, and against the dense FCI
matrix of ``tests/dense_fci.py``), the Lanczos energy (1e-10 of the
script's, 1e-9 of dense FCI), what ``main`` hands ``frisys.build`` (the
config, the seed and the Ritz trial, captured from both mains; the port's
``--run_seed`` in place of the seed), and a 6-orbital ``main`` of 200
iterations on the CPU that exits 0."""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from fries_tpu import synth as jsynth  # noqa: E402
from fries_tpu.drivers import frisys as jfs  # noqa: E402
from fries_tpu_torch import anchor_scale, cisd, convert  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs  # noqa: E402

import dense_fci  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "tools_anchor_scale", os.path.join(REPO, "tools", "anchor_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def systems(n_orb, n_elec, seed=5):
    j = jsynth.make_system(n_orb, n_elec, seed=seed, scale_two=0.1)
    t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), np.asarray(j.symm),
                            n_orb, n_elec)
    return j, t


@pytest.mark.parametrize("sector", [(8, 2, 2), (6, 3, 3)])
def test_full_basis_words(script, sector):
    want = np.asarray(script.full_basis_words(*sector)).astype(np.int64)
    got = anchor_scale.full_basis_words(*sector).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def eight(script):
    """The 8-orbital / 4-electron system (784 determinants): both
    packages' H v and the dense FCI matrix in the basis's key order."""
    j, t = systems(8, 4)
    jbasis = script.full_basis_words(8, 2, 2)
    jhv, _ = script.make_full_matvec(j, jbasis)
    tbasis = anchor_scale.full_basis_words(8, 2, 2)
    thv, _ = anchor_scale.make_full_matvec(t, tbasis)
    h, masks = dense_fci.build_hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), 8, 2, 2)
    order = np.argsort(masks)
    assert np.array_equal(np.asarray(masks)[order], tbasis[:, 0].numpy())
    return jbasis, jhv, thv, h[np.ix_(order, order)]


def test_matvec(eight):
    _, jhv, thv, h = eight
    rng = np.random.default_rng(0)
    for _ in range(3):
        v = rng.standard_normal(h.shape[0])
        got = thv(torch.as_tensor(v)).numpy()
        np.testing.assert_allclose(got, np.asarray(jhv(jnp.asarray(v))), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, h @ v, rtol=1e-12, atol=1e-11)


M = 40   # Lanczos steps at 6 orbitals / 4 electrons (225 determinants)


@pytest.fixture(scope="module")
def six(script, tmp_path_factory):
    """The script's exact_energy of the 6-orbital system, saved where its
    main reads its cache."""
    j, _ = systems(6, 4)
    e0, ritz, basis = script.exact_energy(j, 2, 2, m=M)
    path = tmp_path_factory.mktemp("anchor") / "lanczos.npz"
    np.savez(path, e0=e0, ritz=np.asarray(ritz), basis=np.asarray(basis))
    h, _ = dense_fci.build_hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), 6, 2, 2)
    return float(e0), path, np.linalg.eigvalsh(h)[0]


def test_exact_energy(six):
    want, _, dense = six
    _, t = systems(6, 4)
    got, ritz, basis = anchor_scale.exact_energy(t, 2, 2, m=M)
    assert abs(got - want) < 1e-10
    assert abs(got - dense) < 1e-9
    assert basis.shape == (225, 1) and ritz.shape == (225,)


class Captured(Exception):
    pass


ARGS = ["--n_orb", "6", "--n_elec", "4", "--trial_k", "16", "--vec_nonz", "100",
        "--matr_samp", "400", "--capacity", "4096", "--lanczos_m", str(M)]


def captured(monkeypatch, module, fn):
    got = {}

    def build(ham, cfg, seed, **kw):
        got.update(cfg=cfg, seed=seed, **kw)
        raise Captured
    monkeypatch.setattr(module, "build", build)
    with pytest.raises(Captured):
        fn()
    return got


def test_main_hands_frisys_the_scripts_inputs(script, six, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["anchor_scale.py", *ARGS, "--cache", str(six[1])])
    ref = captured(monkeypatch, jfs, script.main)
    got = captured(monkeypatch, tfs, lambda: anchor_scale.main(
        [*ARGS, "--device", "cpu"], log=lambda s: None))
    assert got["seed"] == ref["seed"] == 6
    fields = {f.name for f in dataclasses.fields(tfs.FrisysConfig)}
    for f in dataclasses.fields(jfs.FrisysConfig):
        if f.name in fields:
            assert getattr(got["cfg"], f.name) == getattr(ref["cfg"], f.name), f.name
    # the trial: the 16 largest |c| of the Ritz vector, scaled to max |c| = 1
    # (up to the Ritz vector's sign); ties broken by cisd.largest's rule
    rv = np.asarray(ref["trial"][1])
    gw, gv = np.asarray(got["trial"][0]), np.asarray(got["trial"][1])
    np.testing.assert_allclose(np.sort(np.abs(gv)), np.sort(np.abs(rv)), rtol=1e-9)
    data = np.load(six[1])
    ww, wv = cisd.largest(data["basis"].astype(np.int64), data["ritz"], 16)
    np.testing.assert_array_equal(gw, ww)
    sign = np.sign(gv[0] * wv[0])
    np.testing.assert_allclose(gv, sign * wv / np.abs(wv).max(), rtol=1e-9, atol=1e-12)


def test_run_seed_draws_another_realization(monkeypatch):
    got = captured(monkeypatch, tfs, lambda: anchor_scale.main(
        [*ARGS, "--device", "cpu", "--run_seed", "9"], log=lambda s: None))
    assert got["seed"] == 9


def test_small_main_exits_zero():
    lines = []
    rc = anchor_scale.main(["--n_orb", "6", "--n_elec", "4", "--trial_k", "16", "--vec_nonz",
                            "60", "--matr_samp", "200", "--capacity", "1024", "--lanczos_m",
                            str(M), "--device", "cpu", "--iters", "200", "--burn", "50",
                            "--block", "100"], log=lines.append)
    assert rc == 0, lines[-2:]
    assert "dim=225" in lines[0]
