"""The correctness check on the CPU at a tiny size: the reference agrees
with the program step for step to rounding, a run comes out correct, and
the control (the reference in float32) and each fault the cells can have
come out not correct."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import catalog, check, data, run
from benchmark.reference import sampling
from benchmark.conftest import REPO
from fries_tpu_torch.drivers import fciqmc, power

SEED = 2**31 + 11


def _quiet(*_a, **_k):
    pass


@pytest.mark.parametrize("cell", ["tiny.fri", "tiny.fciqmc", "tiny_wide.fri"])
def test_reference_follows_the_program(tiny_root, cell):
    """Eight steps, each from the program's state with its draws: the same
    vector and estimators to rounding."""
    c = catalog.cell(cell, tiny_root)
    solver = catalog.solver(c.params["solver"], tiny_root)
    system = data.make_system(c.config, "cpu")
    prog = solver.Program(system, c.params, SEED, "cpu")
    ref = solver.Reference(system, c.params, SEED, "cpu")
    assert check.vec_ks(ref.read(check.snapshot(prog.state))[:2], ref.start()[:2]) == 0.0
    state = prog.state
    for _ in range(8):
        before = check.snapshot(state)
        state, metrics, u = prog.advance(state)
        r_cols, r_vals, r_metrics = ref.advance(ref.read(before), before["iterat"], u)
        cols, vals, shift, last = ref.read(check.snapshot(state))
        assert check.vec_ks((cols, vals), (r_cols, r_vals)) < 1e-14
        prog_metrics = {**run._host(metrics), "shift": shift, "last_norm": last}
        assert check.estimator_gap(prog_metrics, r_metrics) < 1e-14


@pytest.mark.parametrize("cell", ["tiny.fri", "tiny.fciqmc", "tiny_wide.fri"])
def test_a_run_is_correct(tiny_root, cell):
    r = run.run(cell, SEED, 0.3, False, root=tiny_root, device="cpu", log=_quiet)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"step_ms", "peak_mem_gib", "setup_s"}
    assert list(r)[-1] == "compared" and set(r["compared"]) == {"vec_ks", "est_gap", "bad_dets"}


@pytest.mark.parametrize("cell", ["tiny.fri", "tiny.fciqmc"])
def test_the_control_is_not_correct(tiny_root, cell):
    """The reference computed in float32 (the next precision below the
    configuration's float64) fails the check."""
    code = ("import json, sys; from pathlib import Path; from benchmark import run; "
            f"r = run.run({cell!r}, {SEED}, 0.3, False, root=Path(sys.argv[1]), device='cpu', "
            "log=lambda *a: None); print(json.dumps(r['compared']), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code, str(tiny_root)], cwd=REPO,
                         env={**os.environ, "REFERENCE_PRECISION": "float32"},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    compared, correct = out.stdout.strip().rsplit(" ", 1)
    assert correct == "False", compared
    assert any(c["value"] > c["limit"] for c in json.loads(compared).values())


def _frisys_fault(kind):
    make = power.make_stepper

    def make_broken(spawn_fn, diag_fn, cfg, **kw):
        if kind == "half":
            def spawn_half(keys, vals, h_fac, rns):
                w, amps, ini = spawn_fn(keys, vals, h_fac, rns)
                half = torch.arange(amps.shape[0]) >= amps.shape[0] // 2
                return w, torch.where(half, 0.0, 2 * amps), ini
            return make(spawn_half, diag_fn, cfg, **kw)
        step, run_steps = make(spawn_fn, diag_fn, cfg, **kw)
        return _broken_step(step, kind), run_steps

    return make_broken


def _broken_step(step, kind):
    def broken(state, *args, **kwargs):
        new, metrics = step(state, *args, **kwargs)
        if kind == "unchanged":
            return state, metrics
        vals = new.arena.vals.clone()
        i = int(vals[0].abs().argmax())
        vals[0, i] = vals[0, i] * 1.01
        arena = type(new.arena)(keys=new.arena.keys, vals=vals, n_used=new.arena.n_used)
        new.arena = arena
        return new, metrics
    return broken


def _fciqmc_fault(kind):
    build = fciqmc.build
    make_spawner = fciqmc.make_spawner

    def build_broken(*a, **k):
        step, run_steps, state, aux = build(*a, **k)
        return _broken_step(step, kind), run_steps, state, aux

    def spawner_half(*a, **k):
        spawn = make_spawner(*a, **k)

        def half(*args):
            w, vals, ini = spawn(*args)
            drop = torch.arange(vals.shape[0]) >= vals.shape[0] // 2
            return w, torch.where(drop, 0.0, 2 * vals), ini
        return half

    return ("make_spawner", spawner_half) if kind == "half" else ("build", build_broken)


@pytest.mark.parametrize("kind", ["unchanged", "altered", "half"])
@pytest.mark.parametrize("cell", ["tiny.fri", "tiny.fciqmc"])
def test_a_fault_is_not_correct(tiny_root, monkeypatch, cell, kind):
    """A step that returns its state unchanged, the largest value of the
    vector altered by a hundredth where it is produced, half of the spawns
    left out and the rest doubled: each run comes out not correct."""
    if cell == "tiny.fri":
        monkeypatch.setattr(power, "make_stepper", _frisys_fault(kind))
    else:
        monkeypatch.setattr(fciqmc, *_fciqmc_fault(kind))
    r = run.run(cell, SEED, 0.3, False, root=tiny_root, device="cpu", log=_quiet)
    assert not r["correct"], r["compared"]


def test_a_zero_probability_column_is_never_drawn():
    """Where u times the row's total passes its last float32 prefix, the
    draw is the last column of positive probability, not a column of
    probability 0 (such as the first electron's own slot in the second
    electron's row)."""
    probs = torch.tensor([[0.3, 0.2, 0.5, 0.0], [0.25, 0.25, 0.25, 0.25]], dtype=torch.float64)
    u = torch.tensor([1 - 1e-12, 1 - 1e-12], dtype=torch.float64)
    assert sampling.categorical(u, probs).tolist() == [2, 3]
    assert sampling.categorical(torch.tensor([0.1, 0.6], dtype=torch.float64),
                                probs).tolist() == [0, 2]


def test_a_row_with_an_electron_too_many_is_counted(tiny_root):
    """A program's vector row that is not a determinant of the system (one
    electron too many) counts in ``bad_dets``."""
    c = catalog.cell("tiny.fri", tiny_root)
    solver = catalog.solver(c.params["solver"], tiny_root)
    system = data.make_system(c.config, "cpu")
    prog = solver.Program(system, c.params, SEED, "cpu")
    ref = solver.Reference(system, c.params, SEED, "cpu")
    before = check.snapshot(prog.state)
    state, metrics, u = prog.advance(prog.state)
    after = check.snapshot(state)
    assert check.compare(before, [(before, after, run._host(metrics), u)], ref)["bad_dets"] == 0
    keys = after["keys"].clone()
    empty = int((~dets_bits(keys[0], system.n_orb)).nonzero()[0])
    keys[0, 0] |= 1 << empty
    bad = {**after, "keys": keys}
    assert check.compare(before, [(before, bad, run._host(metrics), u)], ref)["bad_dets"] == 1


def dets_bits(words, n_orb):
    b = torch.arange(2 * n_orb)
    return ((words[b // 32] >> (b % 32)) & 1).to(torch.bool)



def test_a_rounding_move_stays_inside_vec_ks():
    """One amplitude moved between two determinants, as a rounding move in a
    spawn does, changes the resampled mass and so shifts every later grid
    point of the vector's resampling: the vectors then differ in many
    entries, but their running sums of |v| stay within a few units."""
    gen = torch.Generator().manual_seed(7)
    n, n_samp = 20000, 5000
    base = torch.randn(n, generator=gen, dtype=torch.float64)
    x = int(torch.nonzero(base > 0.5)[0])      # a spawn of 0.3 lands on x on one side,
    y = int(torch.nonzero(base < -0.5)[0])     # on y on the other: the 1-norm moves by 0.6
    vals, moved = base.clone(), base.clone()
    vals[x] += 0.3
    moved[y] += 0.3
    cols = torch.arange(n)[:, None]
    out_a, loc, n_left = sampling.vector(vals, n_samp, 0.37)
    out_b, _, _ = sampling.vector(moved, n_samp, 0.37)
    unit = float(loc) / n_left
    total = float(out_a.abs().sum())
    l1 = float((out_a - out_b).abs().sum()) / total
    assert l1 > 20 * unit / total                       # many entries moved
    assert check.vec_ks((cols, out_b), (cols, out_a)) <= 3 * unit / total
