"""``frisys_mol --n_chips 2 --device cpu``: two hash-sharded ranks over gloo
write the reference's streams from rank 0 and checkpoints in the
reference's stacked layout; a run resumed from its checkpoint equals the
straight run exactly; a resume onto another world size stops; the other
subcommands keep raising on --n_chips > 1."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu_torch import cli, synth  # noqa: E402
from fries_tpu_torch import io as tio  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A straight 2-rank run of 20 iterations, and 10 + 10 resumed (each
    world joined within 120 s)."""
    def run(argv):
        cli.run_frisys(cli._parser().parse_args(argv), join_timeout=120.0)

    d = tmp_path_factory.mktemp("sharded_cli")
    fcidump = d / "FCIDUMP"
    tio.write_fcidump(synth.make_system(6, 4, seed=2), fcidump)
    base = ["frisys_mol", "--fcidump_path", str(fcidump), "--epsilon", "0.02",
            "--vec_nonz", "40", "--mat_nonz", "100", "--max_dets", "256",
            "--save_interval", "10", "--target", "200", "--seed", "3", "--device", "cpu",
            "--n_chips", "2"]
    run(base + ["--max_iter", "20", "--result_dir", str(d / "straight")])
    run(base + ["--max_iter", "10", "--result_dir", str(d / "resumed")])
    run(base + ["--max_iter", "10", "--result_dir", str(d / "resumed"),
                "--load_dir", str(d / "resumed")])
    return d, base


def test_sharded_cli_writes_streams_and_stacked_checkpoint(runs):
    d, _ = runs
    out = d / "straight"
    for name in cli._STREAMS.values():
        assert np.loadtxt(out / name).shape == (20,), name
    assert np.isfinite(np.loadtxt(out / "projnum.txt")).all()
    assert "n_chips: 2" in (out / "params.txt").read_text()
    assert len((out / "arena_occ.txt").read_text().splitlines()) == 2
    with np.load(out / "checkpoint.npz") as z:
        assert z["n_used"].shape == (2,) and (z["n_used"] > 0).all()
        assert z["keys"].shape == (512, 1) and z["vals"].shape == (2, 512)
        assert int(z["iterat"]) == 20
        live = z["keys"][:, 0] != 0xFFFFFFFF
        assert live.sum() == z["n_used"].sum()


def test_sharded_resume_equals_straight_run(runs):
    d, _ = runs
    for name in cli._STREAMS.values():
        np.testing.assert_array_equal(np.loadtxt(d / "resumed" / name),
                                      np.loadtxt(d / "straight" / name), err_msg=name)
    with np.load(d / "resumed" / "checkpoint.npz") as a, \
            np.load(d / "straight" / "checkpoint.npz") as b:
        for k in ("keys", "vals", "n_used", "iterat", "en_shift", "last_norm",
                  "torch_generator"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resume_needs_the_same_world_size(runs):
    d, base = runs
    one = [x for x in base if x not in ("--n_chips", "2")]
    with pytest.raises(SystemExit, match="2 ranks"):
        cli.main(one + ["--max_iter", "5", "--result_dir", str(d / "one"),
                        "--load_dir", str(d / "straight")])


@pytest.mark.parametrize("cmd", ["frifull_mol", "fciqmc_mol", "observables_mol"])
def test_other_subcommands_raise_on_n_chips(runs, cmd):
    d, _ = runs
    args = [cmd, "--fcidump_path", str(d / "FCIDUMP"), "--epsilon", "0.02", "--max_dets",
            "64", "--device", "cpu", "--n_chips", "2"]
    if cmd != "fciqmc_mol":
        args += ["--vec_nonz", "40"]
    if cmd == "observables_mol":
        args += ["--obs_des", "0", "--obs_cre", "3"]
    with pytest.raises(NotImplementedError, match="frisys_mol only"):
        cli.main(args)


def test_sharded_configs_are_bench_subsp_sharded():
    """``rung.subsp_sharded_config`` is bench.py's ``bench_subsp_sharded``
    with capacity 2^20 per rank (bench.py's 2^19 overflows); the sharded
    rung_real is the 1e6 rung with n_shards set."""
    import ast
    import os

    from fries_tpu_torch import rung

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "bench_subsp_sharded")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "SubspaceConfig")
    cfg = rung.subsp_sharded_config(2)
    assert (cfg.n_shards, cfg.capacity) == (2, 1 << 20)
    for kw in call.keywords:
        if kw.arg == "n_trial":
            assert cfg.n_trial == 2
        elif kw.arg not in ("axis_name", "n_shards", "capacity"):
            assert getattr(cfg, kw.arg) == eval(compile(ast.Expression(kw.value), "bench.py",
                                                        "eval")), kw.arg
