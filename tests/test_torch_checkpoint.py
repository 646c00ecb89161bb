"""Checkpoints and resume: the port's ``runtime/checkpoint.py`` against the
reference's, and the command line's ``checkpoint.npz``,
``checkpoint_overflow.npz`` and ``--load_dir``.

* Each package's ``load_arena`` reads the other's file into an equal arena
  (keys and values exactly; entries below 1e-9 in every row dropped,
  sentinel rows dropped, re-sorted).
* ``load_last_line`` and ``load_rdm`` agree with the reference's.
* A run of 6 iterations resumed for 6 more writes exactly the streams of a
  straight run of 12 (frisys_mol, fciqmc_mol, subsp_mol).
* An overflow writes ``checkpoint_overflow.npz`` (the state before the
  block) and stops; a file without the port's random state stops
  ``--load_dir`` with an error that names the missing field.
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fries_tpu import io as jio  # noqa: E402
from fries_tpu.runtime import arena as jar, checkpoint as jck  # noqa: E402
from fries_tpu_torch import cli, convert, dets, io as tio, rng, synth  # noqa: E402
from fries_tpu_torch.runtime import checkpoint as tck  # noqa: E402


def arena_with_small_entries(n_vecs=2):
    """A reference arena of 40 live rows (some below 1e-9 in every row) in
    64 slots."""
    g = np.random.default_rng(7)
    keys = np.unique(g.integers(0, 2**20, size=(40, 2), dtype=np.uint32), axis=0)
    vals = g.standard_normal((n_vecs, len(keys)))
    vals[:, ::5] = 1e-12 * g.standard_normal((n_vecs, len(keys[::5])))
    vals[0, 1::7] = 0.0
    return jar.from_unsorted(jar.make(64, 2, n_vecs), jnp.asarray(keys), jnp.asarray(vals))


def live_rows(keys, vals):
    """(keys, vals) of the rows a load keeps, in key order."""
    live = (np.abs(vals) >= 1e-9).any(0) & (keys[:, -1] != 0xFFFFFFFF)
    packed = keys[live, 0].astype(np.int64) | (keys[live, 1].astype(np.int64) << 32)
    order = np.argsort(packed, kind="stable")
    return keys[live][order].astype(np.int64), vals[:, live][:, order]


def test_reference_file_loads_in_port(tmp_path):
    ja = arena_with_small_entries()
    state = types.SimpleNamespace(arena=ja, key=jax.random.key(3), iterat=jnp.int32(9),
                                  en_shift=jnp.float64(-0.25), last_norm=jnp.float64(80.0))
    jck.save_state(tmp_path / "ref.npz", state)
    ta = tck.load_arena(tmp_path / "ref.npz")
    want_keys, want_vals = live_rows(np.asarray(ja.keys), np.asarray(ja.vals))
    n = len(want_keys)
    assert 20 < n < 40 and int(ta.n_used[0]) == n
    np.testing.assert_array_equal(ta.keys[:n].numpy(), want_keys)
    np.testing.assert_array_equal(ta.vals[:, :n].numpy(), want_vals)
    assert bool(dets.is_invalid(ta.keys[n:]).all()) and not ta.vals[:, n:].any()
    scal = tck.load_scalars(tmp_path / "ref.npz")
    assert (int(scal["iterat"]), float(scal["en_shift"]), float(scal["last_norm"])) == (
        9, -0.25, 80.0)


def test_port_file_loads_in_reference(tmp_path):
    ja = arena_with_small_entries(n_vecs=3)
    ta = convert.arena(np.asarray(ja.keys), np.asarray(ja.vals), np.asarray(ja.n_used))
    state = convert.power_state(ta, -0.5, 12.0, 4, seed=1)
    tck.save_state(tmp_path / "port.npz", state)
    with np.load(tmp_path / "port.npz") as z:
        assert z["keys"].dtype == np.uint32 and z["vals"].dtype == np.float64
        assert z["iterat"].dtype == np.int32 and z["n_used"].shape == (1,)
        assert tck.GENERATOR in z.files and "key" not in z.files
    back = jck.load_arena(str(tmp_path / "port.npz"))
    ref = jar.from_unsorted(jar.make(64, 2, 3), *(jnp.asarray(x) for x in
                                                   live_rows(np.asarray(ja.keys),
                                                             np.asarray(ja.vals))))
    np.testing.assert_array_equal(np.asarray(back.keys), np.asarray(ref.keys))
    np.testing.assert_array_equal(np.asarray(back.vals), np.asarray(ref.vals))
    assert int(back.n_used[0]) == int(ref.n_used[0])
    scal = jck.load_scalars(str(tmp_path / "port.npz"))
    assert (int(scal["iterat"]), float(scal["en_shift"])) == (4, -0.5)


def test_restore_round_trip(tmp_path):
    """A state's arena, scalars, generator and key node come back: the
    restored generator and node draw what the saved ones would."""
    ja = arena_with_small_entries()
    ta = convert.arena(np.asarray(ja.keys), np.asarray(ja.vals), np.asarray(ja.n_used))
    state = convert.power_state(ta, 0.1, 3.0, 17, seed=5, key=rng.KeyTree(11).fold(2))
    torch.rand(5, generator=state.generator)   # move the stream off its seed
    tck.save_state(tmp_path / "s.npz", state)
    fresh = convert.power_state(ta, 0.0, 0.0, 0, seed=99, key=rng.KeyTree(0))
    back = tck.restore(tmp_path / "s.npz", fresh)
    assert back.iterat == 17 and float(back.en_shift) == 0.1 and float(back.last_norm) == 3.0
    assert torch.equal(back.arena.keys, ta.keys) and torch.equal(back.arena.vals, ta.vals)
    assert torch.equal(torch.rand(7, generator=back.generator),
                       torch.rand(7, generator=state.generator))
    assert torch.equal(back.key.uniform((5,)), state.key.uniform((5,)))


def test_load_last_line_and_rdm_match_reference(tmp_path):
    stream = tmp_path / "S.txt"
    stream.write_text("0.5,1.25\n-3e-2,7.0\n\n")
    np.testing.assert_array_equal(tio.load_last_line(stream), jio.load_last_line(stream))
    assert tio.load_last_line(stream).tolist() == [-0.03, 7.0]
    (tmp_path / "empty.txt").write_text("\n")
    assert tio.load_last_line(tmp_path / "empty.txt").shape == (0,)
    rdm = tmp_path / "rdm.txt"
    rdm.write_text("1.0 2.5\n-3.25e-3   4\n5\n")
    np.testing.assert_array_equal(tio.load_rdm(rdm), jio.load_rdm(str(rdm)))


def small_inputs(tmp_path):
    ham = synth.make_system(5, 4, seed=2)
    tio.write_fcidump(ham, tmp_path / "FCIDUMP")
    hf = dets.hf_det(5, 4)
    single, _ = dets.single_parity(hf[None], torch.tensor([1]), torch.tensor([3]))
    tio.save_vec_txt(tmp_path / "trial00", hf[None].numpy(), [1.0], 10)
    tio.save_vec_txt(tmp_path / "trial01", single.numpy(), [1.0], 10)
    return str(tmp_path / "FCIDUMP")


RESUME_ARGS = {
    "frisys_mol": ["--epsilon", "0.05", "--vec_nonz", "60", "--mat_nonz", "200",
                   "--max_dets", "512", "--target", "80"],
    "fciqmc_mol": ["--max_dets", "256", "--target", "200", "--attempt_cap", "1024",
                   "--initiator", "1", "--epsilon", "0.02"],
    "subsp_mol": ["--epsilon", "0.05", "--vec_nonz", "60", "--mat_nonz", "200",
                  "--max_dets", "256", "--num_trial", "2", "--restart_int", "4"],
}


@pytest.mark.parametrize("cmd", sorted(RESUME_ARGS))
def test_cli_resume_equals_straight_run(tmp_path, cmd):
    """6 iterations with --save_interval 3, then 6 more with --load_dir,
    give the streams of 12 straight iterations exactly; checkpoint.npz
    holds iteration 12 at the end of both."""
    fcidump = small_inputs(tmp_path)
    base = [cmd, "--fcidump_path", fcidump, "--save_interval", "3", "--seed", "3",
            "--device", "cpu"] + RESUME_ARGS[cmd]
    if cmd == "subsp_mol":
        base += ["--trial_vecs", str(tmp_path / "trial")]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    cli.main(base + ["--max_iter", "12", "--result_dir", str(straight)])
    cli.main(base + ["--max_iter", "6", "--result_dir", str(resumed)])
    with np.load(resumed / "checkpoint.npz") as z:
        assert int(z["iterat"]) == 6
        assert (tck.KEY_TREE in z.files) == (cmd != "frisys_mol")
        assert (tck.GENERATOR in z.files) == (cmd == "frisys_mol")
    cli.main(base + ["--max_iter", "6", "--result_dir", str(resumed),
                     "--load_dir", str(resumed)])
    names = sorted(n for n in os.listdir(straight)
                   if n.endswith(".txt") and n not in ("params.txt", "arena_occ.txt"))
    assert len(names) >= 5
    for name in names:
        text = (straight / name).read_text()
        assert (resumed / name).read_text() == text, name
        if name in ("projnum.txt", "h_mat.txt"):
            assert len(text.splitlines()) == 12
    for d in (straight, resumed):
        with np.load(d / "checkpoint.npz") as z:
            assert int(z["iterat"]) == 12


def test_overflow_writes_checkpoint_before_exit(tmp_path):
    """A 64-slot arena overflows in the second block: the run stops with
    checkpoint_overflow.npz holding the state after the first, the state a
    run of 2 iterations ends in (its generator's stream included)."""
    fcidump = small_inputs(tmp_path)
    out = tmp_path / "run"
    args = ["frisys_mol", "--fcidump_path", fcidump, "--epsilon", "0.05", "--vec_nonz", "60",
            "--mat_nonz", "200", "--max_dets", "64", "--save_interval", "2", "--target", "80",
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="checkpoint_overflow.npz"):
        cli.main(args + ["--max_iter", "40", "--result_dir", str(out)])
    cli.main(args + ["--max_iter", "2", "--result_dir", str(tmp_path / "two")])
    with np.load(out / "checkpoint_overflow.npz") as z, \
            np.load(tmp_path / "two" / "checkpoint.npz") as two:
        assert int(z["iterat"]) == 2 and 0 < int(z["n_used"][0]) <= 64
        for field in ("keys", "vals", tck.GENERATOR):   # the generator before the block
            np.testing.assert_array_equal(z[field], two[field], err_msg=field)
    lines = len((out / "projnum.txt").read_text().splitlines())
    assert lines == 2   # the streams hold the blocks before it, no more


@pytest.mark.parametrize("cmd,field", [("frisys_mol", tck.GENERATOR),
                                       ("fciqmc_mol", tck.KEY_TREE)])
def test_load_dir_needs_port_random_state(tmp_path, cmd, field):
    """The reference's checkpoint holds its JAX key, not the port's random
    state: --load_dir stops and names the field, it does not reseed."""
    fcidump = small_inputs(tmp_path)
    ja = jar.from_unsorted(jar.make(256, 1, 2 if cmd == "frisys_mol" else 1),
                           jnp.asarray(dets.hf_det(5, 4)[None].numpy().astype(np.uint32)),
                           jnp.ones((2 if cmd == "frisys_mol" else 1, 1)) * 50.0)
    ckpt = tmp_path / "ref"
    ckpt.mkdir()
    jck.save_state(str(ckpt / "checkpoint.npz"), types.SimpleNamespace(
        arena=ja, key=jax.random.key(0), iterat=jnp.int32(5), en_shift=jnp.float64(0.0),
        last_norm=jnp.float64(0.0)))
    with pytest.raises(SystemExit, match=field):
        cli.main([cmd, "--fcidump_path", fcidump, "--max_iter", "2", "--device", "cpu",
                  "--result_dir", str(tmp_path / "run"), "--load_dir", str(ckpt)]
                 + RESUME_ARGS[cmd])
