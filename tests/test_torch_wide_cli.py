"""Determinants wider than 64 bits at the port's inputs and command line:
``rung.NE_QZ_SYMM`` (the real Ne/cc-pVQZ orbitals' irreps) against the
Ne/cc-pVQZ shells of fries_tpu/basis.py;
``read_dets``, ``save_vec_txt`` / ``load_vec_txt`` and ``load_vec_dice`` at
72- and 108-bit masks against the reference's readers; ``frisys_mol``
(semistochastic, with trial and initial vectors) and ``subsp_mol`` on the
command line from a reference-written FCIDUMP of 34 orbitals (three words),
with masks above 2^64; and a ``frisys_mol`` resume at 50 orbitals (four
words) equal to a straight run, stream for stream."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu import basis as jbasis, io as jio, synth as jsynth  # noqa: E402
from fries_tpu_torch import cli, dets, io as tio, rung, synth  # noqa: E402

# D2h irreps (XOR ids: Ag 0, B1g 1, B2g 2, B3g 3, Au 4, B1u 5, B2u 6, B3u 7)
# of the real spherical harmonics of each angular momentum at an atom
D2H_BY_L = {0: [0], 1: [5, 6, 7], 2: [0, 0, 1, 2, 3], 3: [4, 5, 5, 6, 6, 7, 7],
            4: [0, 0, 0, 1, 1, 2, 2, 3, 3]}


def test_ne_qz_symm_matches_basis():
    """54 orbitals: cc-pVQZ's shells for Ne less the frozen 1s (an Ag), the
    four occupied (2s, 2p) first."""
    counts = np.zeros(8, int)
    for l, _ in jbasis._ne_qz_shells():
        np.add.at(counts, D2H_BY_L[l], 1)
    counts[0] -= 1
    symm = np.asarray(rung.NE_QZ_SYMM)
    assert len(symm) == counts.sum() == 54
    np.testing.assert_array_equal(np.bincount(symm, minlength=8), counts)
    assert list(symm[:4]) == [0, 5, 6, 7]
    assert dets.n_words(2 * len(symm)) == 4

    class Shape:   # the real system's shape and irreps, without its build
        n_orb, n_elec, symm = 54, 8, torch.as_tensor(rung.NE_QZ_SYMM)

    assert rung.ne_qz_single(Shape) == (3, 6)


@pytest.mark.parametrize("n_orb", [36, 54])
def test_vector_files_match_reference(tmp_path, n_orb):
    rng = np.random.default_rng(n_orb)
    n_bits = 2 * n_orb
    masks = [int(rng.integers(1, 2**62)) << int(rng.integers(0, n_bits - 62))
             for _ in range(40)] + [(1 << (n_bits - 1)) | 1]
    (tmp_path / "d").write_text("".join(f"{m}\n" for m in masks))
    words = tio.read_dets(tmp_path / "d", n_bits)
    np.testing.assert_array_equal(words, jio.read_dets(tmp_path / "d", n_bits))
    assert words.shape == (41, dets.n_words(n_bits))
    assert max(masks) >= 1 << 64
    vals = rng.standard_normal(41)
    tio.save_vec_txt(tmp_path / "v", words, vals, n_bits)
    assert (tmp_path / "vdets").read_text() == (tmp_path / "d").read_text()
    k, v = tio.load_vec_txt(tmp_path / "v", n_bits)
    np.testing.assert_array_equal(k, words)
    np.testing.assert_array_equal(v, vals)
    occ = "2a" + "0" * (n_orb - 4) + "b2"
    (tmp_path / "dice").write_text(f"State : 0\n0  0.9  {occ}\n1  -0.3  {occ[::-1]}\n")
    got = tio.load_vec_dice(tmp_path / "dice", n_orb, n_bits)
    want = jio.load_vec_dice(tmp_path / "dice", n_orb, n_bits)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def wide_inputs(tmp_path):
    """A reference-written FCIDUMP of 34 orbitals and 4 electrons (three
    words), a deterministic space, and vectors whose last member has a beta
    electron in orbital 33 (bit 67)."""
    symm = np.arange(34) % 4
    j = jsynth.make_system(34, 4, symm=symm, seed=5, scale_two=0.1)
    jio.write_fcidump(j, tmp_path / "FCIDUMP", point_group="D2h")
    ham = synth.make_system(34, 4, symm=symm, seed=5, scale_two=0.1)
    space = rung.determ_space(ham, 6)
    far, _ = dets.single_parity(dets.hf_det(34, 4)[None], torch.tensor([35]),
                                torch.tensor([67]))
    space = np.concatenate([space, far.numpy()])
    masks = [sum(int(x) << (32 * w) for w, x in enumerate(row)) for row in space]
    assert max(masks) >= 1 << 64
    (tmp_path / "space").write_text("".join(f"{m}\n" for m in masks))
    tio.save_vec_txt(tmp_path / "trial", space, np.r_[1.0, np.full(6, 0.05)], 68)
    tio.save_vec_txt(tmp_path / "trial00", space[:1], [1.0], 68)
    tio.save_vec_txt(tmp_path / "trial01", space[-1:], [1.0], 68)
    return tmp_path / "FCIDUMP"


def streams(out, n):
    """The result streams of a run of ``n`` iterations: each parses, has
    ``n`` rows and is finite."""
    names = [f for f in os.listdir(out) if f.endswith(".txt")
             and f not in ("params.txt", "arena_occ.txt") and (out / f).read_text().strip()]
    assert len(names) >= 4
    for name in names:
        x = np.loadtxt(out / name, delimiter="," if "," in (out / name).read_text() else None)
        assert x.shape[0] == n and np.isfinite(x).all(), name
    return names


def test_cli_frisys_mol_three_words(tmp_path):
    fcidump = wide_inputs(tmp_path)
    out = tmp_path / "frisys"
    cli.main(["frisys_mol", "--fcidump_path", str(fcidump), "--point_group", "D2h",
              "--epsilon", "0.01", "--vec_nonz", "200", "--mat_nonz", "20000", "--max_dets", "16384",
              "--max_iter", "8", "--target", "400", "--det_space", str(tmp_path / "space"),
              "--trial_vec", str(tmp_path / "trial"), "--ini_vec", str(tmp_path / "trial"),
              "--result_dir", str(out), "--seed", "3", "--device", "cpu"])
    streams(out, 8)


def test_cli_subsp_mol_three_words(tmp_path):
    fcidump = wide_inputs(tmp_path)
    out = tmp_path / "subsp"
    cli.main(["subsp_mol", "--fcidump_path", str(fcidump), "--point_group", "D2h",
              "--epsilon", "0.02", "--vec_nonz", "200", "--mat_nonz", "1000", "--max_dets", "8192",
              "--max_iter", "6", "--trial_vecs", str(tmp_path / "trial"), "--num_trial", "2",
              "--restart_int", "3", "--result_dir", str(out), "--seed", "3",
              "--device", "cpu"])
    streams(out, 6)
    h = np.loadtxt(out / "h_mat.txt", delimiter=",").reshape(6, 2, 2)
    assert (h[:, 1, 1] != 0).all()   # the trial vector beyond 64 bits is live


def test_cli_resume_four_words(tmp_path):
    """3 iterations, then 3 more with --load_dir, give the streams of 6
    straight iterations exactly; the checkpoint holds a (C, 4) arena."""
    ham = synth.make_system(50, 4, symm=np.arange(50) % 4, seed=3, scale_two=0.1)
    tio.write_fcidump(ham, tmp_path / "FCIDUMP", point_group="D2h")
    base = ["frisys_mol", "--fcidump_path", str(tmp_path / "FCIDUMP"), "--point_group", "D2h",
            "--epsilon", "0.01", "--vec_nonz", "200", "--mat_nonz", "1500", "--max_dets", "4096",
            "--target", "600", "--save_interval", "3", "--seed", "3", "--device", "cpu"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    cli.main(base + ["--max_iter", "6", "--result_dir", str(straight)])
    cli.main(base + ["--max_iter", "3", "--result_dir", str(resumed)])
    with np.load(resumed / "checkpoint.npz") as z:
        assert z["keys"].shape == (4096, 4) and int(z["iterat"]) == 3
    cli.main(base + ["--max_iter", "3", "--result_dir", str(resumed),
                     "--load_dir", str(resumed)])
    for name in streams(straight, 6):
        assert (resumed / name).read_text() == (straight / name).read_text(), name
