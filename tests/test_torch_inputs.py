"""The port's remaining inputs and host helpers against the reference
package: the HF input directory (``io.parse_hf_input`` / ``write_hf_dir``,
frozen orbitals included, and ``--hf_path`` on the command line),
``dice_dots``, the trajectory statistics (``stats``), and ``arena.grow``,
``arena.one_norm`` and ``compress.compress_vector``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import dense_fci  # noqa: E402
from fries_tpu import cli as jcli, compress as jcomp, io as jio, stats as jstats  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu.runtime import arena as jar  # noqa: E402
from fries_tpu_torch import cli, compress, convert, io as tio, stats, synth  # noqa: E402
from fries_tpu_torch.runtime import arena as tar  # noqa: E402

SYMM6 = np.array([0, 0, 1, 0, 1, 0])


def frozen_system(n_frozen):
    """A reference Hamiltonian of 5 active orbitals and 4 active electrons
    over 5 + n_frozen / 2 orbitals."""
    tot = 5 + n_frozen // 2
    h, eris = dense_fci.random_integrals(np.random.default_rng(9), tot)
    return jmol.MolecularHamiltonian(hcore=jnp.asarray(h), eris=jnp.asarray(eris),
                                     symm=jnp.asarray(SYMM6[-5:].astype(np.int32)),
                                     n_orb=5, n_elec=4, n_frozen=n_frozen)


@pytest.mark.parametrize("n_frozen", [0, 2])
def test_hf_dir_matches_reference(tmp_path, n_frozen):
    """The reference's directory read by the port, and the port's read by the
    reference: equal integrals, sizes and parameters."""
    j = frozen_system(n_frozen)
    jio.write_hf_dir(j, tmp_path / "ref", eps=0.01, hf_energy=-7.25)
    t, params = tio.parse_hf_input(tmp_path / "ref")
    j2, jparams = jio.parse_hf_input(tmp_path / "ref")
    assert params == jparams == {"eps": 0.01, "hf_energy": -7.25, "n_frozen": n_frozen}
    assert (t.n_orb, t.n_elec, t.n_frozen, t.tot_orb) == (5, 4, n_frozen, 5 + n_frozen // 2)
    np.testing.assert_array_equal(t.hcore.numpy(), np.asarray(j2.hcore))
    np.testing.assert_array_equal(t.eris.numpy(), np.asarray(j2.eris))
    np.testing.assert_array_equal(t.symm.numpy(), np.asarray(j2.symm))
    np.testing.assert_allclose(t.hcore.numpy(), np.asarray(j.hcore), rtol=1e-15)
    assert float(tmol_hf(t)) == pytest.approx(float(jmol.hf_reference(j2)[2]), rel=1e-13)
    tio.write_hf_dir(t, tmp_path / "port", eps=0.01, hf_energy=-7.25)
    back, back_params = jio.parse_hf_input(tmp_path / "port")
    assert back_params == jparams and back.n_frozen == n_frozen
    np.testing.assert_array_equal(np.asarray(back.eris), t.eris.numpy())
    np.testing.assert_array_equal(np.asarray(back.symm), t.symm.numpy())


def tmol_hf(t):
    from fries_tpu_torch.ops import molecule as tmol

    return tmol.hf_reference(t)[2]


def test_cli_hf_path_equals_fcidump(tmp_path):
    """frisys_mol on an HF directory runs the run of the same Hamiltonian's
    FCIDUMP, stream for stream within rtol 1e-12; with a frozen core it runs
    too."""
    t = synth.make_system(6, 4, symm=SYMM6, seed=2)
    tio.write_fcidump(t, tmp_path / "FCIDUMP", point_group="D2h")
    tio.write_hf_dir(t, tmp_path / "hf", eps=0.02, hf_energy=0.0)
    base = ["frisys_mol", "--epsilon", "0.02", "--vec_nonz", "40", "--mat_nonz", "100",
            "--max_dets", "256", "--max_iter", "10", "--save_interval", "5", "--target",
            "200", "--seed", "3", "--device", "cpu"]
    cli.main(base + ["--fcidump_path", str(tmp_path / "FCIDUMP"), "--point_group", "D2h",
                     "--result_dir", str(tmp_path / "a")])
    cli.main(base + ["--hf_path", str(tmp_path / "hf"), "--result_dir", str(tmp_path / "b")])
    for name in cli._STREAMS.values():   # the FCIDUMP's text rounds the last bit
        np.testing.assert_allclose(np.loadtxt(tmp_path / "b" / name),
                                   np.loadtxt(tmp_path / "a" / name), rtol=1e-12, err_msg=name)
    jio.write_hf_dir(frozen_system(2), tmp_path / "frozen", eps=0.02, hf_energy=0.0)
    cli.main(base + ["--hf_path", str(tmp_path / "frozen"), "--result_dir", str(tmp_path / "c")])
    assert np.isfinite(np.loadtxt(tmp_path / "c" / "projnum.txt")).all()
    with pytest.raises(SystemExit, match="--fcidump_path or --hf_path"):
        cli.main(base + ["--result_dir", str(tmp_path / "d")])


DICE = {
    "a.dice": ("State :   0\n0  0.9746  2 2 0 0 0\n1  -0.100  2 a b 0 0\n"
               "2  0.0000001  2 0 2 0 0\nState :   1\n0  0.8  a b 2 0 0\n1  0.3  2 2 0 0 0\n"),
    "b.dice": ("State :   0\n0  0.5  2 2 0 0 0\n1  0.25  a b 2 0 0\n2  -0.4  2 a b 0 0\n"
               "State :   1\n0  0.9  2 0 2 0 0\n1  -0.2  a b 2 0 0\n"
               "State :   2\n0  1.0  b a 2 0 0\n"),
}


def test_dice_dots_matches_reference(tmp_path, monkeypatch):
    """The overlap matrix of two Dice files (written as tests/test_io.py
    writes one), dice_dots.txt byte for byte."""
    for name, text in DICE.items():
        (tmp_path / name).write_text(text)
    args = ["dice_dots", "--vecs1", str(tmp_path / "a.dice"), "--vecs2",
            str(tmp_path / "b.dice"), "--n_orb", "5", "--n_states1", "2", "--n_states2", "3"]
    for who, main in (("ref", jcli.main), ("port", cli.main)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        main(args)
    ref = (tmp_path / "ref" / "dice_dots.txt").read_text()
    assert (tmp_path / "port" / "dice_dots.txt").read_text() == ref
    mats = np.loadtxt(tmp_path / "port" / "dice_dots.txt", delimiter=",")
    np.testing.assert_allclose(mats[0], [0.9746 * 0.5 + 0.1 * 0.4, 0.0, 0.0])
    assert mats[1, 1] == pytest.approx(-0.16)


def test_stats_match_reference():
    g = np.random.default_rng(3)
    x = np.zeros(4000)
    for i in range(1, len(x)):   # an AR(1) series, autocorrelation time ~ 19
        x[i] = 0.9 * x[i - 1] + g.standard_normal()
    num, den = -0.3 + 0.01 * x, 1.0 + 0.001 * g.standard_normal(len(x))
    assert stats.integrated_time(x) == jstats.integrated_time(x)
    np.testing.assert_array_equal(stats.autocorr_fft(x), jstats.autocorr_fft(x))
    for kw in ({}, {"exact_corr": -0.3, "burn_in": 100}):
        assert stats.trajectory_stats(num, den, **kw) == jstats.trajectory_stats(num, den, **kw)
    assert 10 < stats.integrated_time(x) < 30


def test_arena_grow_one_norm_match_reference():
    g = np.random.default_rng(5)
    keys = np.unique(g.integers(0, 2**20, size=(30, 2), dtype=np.uint32), axis=0)
    vals = g.standard_normal((2, len(keys)))
    ja = jar.from_unsorted(jar.make(32, 2, 2), jnp.asarray(keys), jnp.asarray(vals))
    ta = convert.arena(np.asarray(ja.keys), np.asarray(ja.vals), np.asarray(ja.n_used))
    for row in (0, 1):
        assert float(tar.one_norm(ta, row)) == pytest.approx(float(jar.one_norm(ja, row)),
                                                             rel=1e-14)
    for cap in (16, 32, 80):
        jg, tg = jar.grow(ja, cap), tar.grow(ta, cap)
        np.testing.assert_array_equal(tg.keys.numpy(), np.asarray(jg.keys).astype(np.int64))
        np.testing.assert_array_equal(tg.vals.numpy(), np.asarray(jg.vals))
        assert int(tg.n_used[0]) == int(jg.n_used[0]) and tg.capacity == max(cap, 32)


@pytest.mark.parametrize("n_samp", [5, 40, 400])
def test_compress_vector_matches_reference(n_samp):
    """Exactly summable inputs (multiples of 2^-10), so both packages' prefix
    sums agree to the bit and the grid picks the same elements."""
    g = np.random.default_rng(n_samp)
    vals = np.round(g.standard_normal(300) * 2**10) / 2**10
    vals[g.random(300) < 0.3] = 0.0
    for rn in (0.0, 0.37, 0.99):
        want = np.asarray(jcomp.compress_vector(jnp.asarray(vals), n_samp, jnp.float64(rn)))
        got = compress.compress_vector(torch.as_tensor(vals), n_samp,
                                       torch.tensor(rn, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
        assert (got != 0).sum() <= max(n_samp, (vals != 0).sum())
