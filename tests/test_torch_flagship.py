"""The port's flagship run (``fries_tpu_torch.flagship``) against
``tools/flagship.py`` and the JAX package: the systems table, the
preparation (FrisysConfig, trial, initial vector and deterministic space,
captured from ``tools/flagship.py``'s ``main`` where it calls
``frisys.build``), ``summarize`` against ``fries_tpu.stats`` plus the
gates of ``tools/flagship.py`` and ``tools/package_n2_result.py``, a CPU
``run`` resumed from its checkpoint, the command line without a card, and
the module importing neither jax nor the JAX package.  The 40-step
trajectory against the JAX package is ``test_torch_flagship_steps.py``."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fries_tpu import cisd as jcisd  # noqa: E402
from fries_tpu import stats as jstats  # noqa: E402
from fries_tpu.drivers import frisys as jfs  # noqa: E402
from fries_tpu_torch import cisd as tcisd  # noqa: E402
from fries_tpu_torch import flagship  # noqa: E402
from test_torch_frisys import system  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2O_EXACT_CORR = -0.217834    # BASELINE.md:11 (calc_stats.py:7-10); flagship.py:60 has -0.217830


def jax_flagship():
    spec = importlib.util.spec_from_file_location(
        "tools_flagship", os.path.join(REPO, "tools", "flagship.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Captured(Exception):
    pass


def jax_preparation(monkeypatch, argv, j, words, vals):
    """What ``tools/flagship.py``'s main passes to ``frisys.build`` for
    ``argv`` on the system ``j`` with the CISD trial (words, vals)."""
    mod = jax_flagship()
    monkeypatch.setattr(mod, "build_system", lambda name: (j, words, vals, -0.1))
    got = {}

    def build(ham, cfg, seed, **kw):
        got.update(cfg=cfg, seed=seed, **kw)
        raise Captured

    monkeypatch.setattr(jfs, "build", build)
    monkeypatch.setattr(sys, "argv", ["flagship.py", *argv])
    with pytest.raises(Captured):
        mod.main()
    return got


def test_systems_match_tools_flagship():
    ref = jax_flagship().SYSTEMS
    assert sorted(ref) == sorted(flagship.SYSTEMS)
    for name, row in ref.items():
        for key, value in row.items():
            if (name, key) == ("h2o", "exact_corr"):   # the one deliberate difference
                assert value == -0.217830
                assert flagship.SYSTEMS[name][key] == H2O_EXACT_CORR
            else:
                assert flagship.SYSTEMS[name][key] == value, (name, key)
    rows = {(name, k): v[:2] for name, m in flagship.SYSTEMS.items()
            for k, v in m["rows"].items()}
    assert rows == {("ne", (100_000, 0)): (0.0223, 0.0070),
                    ("ne", (150_000, 50)): (0.0113, 0.0048),
                    ("n2", (1_000_000, 0)): (0.0275, 0.0208),
                    ("h2o", (1_000_000, 0)): (0.0171, 0.0067)}


@pytest.fixture(scope="module")
def trials():
    j, t = system()
    je, jw, jv = jcisd.cisd_ground_state(j)
    te, tw, tv = tcisd.cisd_ground_state(t)
    return j, t, (je, jw, jv), (te, tw.numpy(), tv.numpy())


@pytest.mark.parametrize("flags", [
    ["--budget", "1000", "--capacity", "4096", "--determ", "6", "--initiator", "1.0"],
    ["--budget", "1000", "--capacity", "4096", "--determ", "6", "--initiator", "1.0",
     "--damp", "0.05", "--track", "0", "--trial_k", "21", "--init_frac", "0.25",
     "--eps", "0.01"],
    ["--budget", "800", "--capacity", "2048", "--init_frac", "0"],
])
def test_preparation_matches_tools_flagship(monkeypatch, trials, flags):
    """The FrisysConfig field by field, the trial, the initial vector and
    the deterministic space (as a set: the reference's argsort is not
    stable) that tools/flagship.py builds for the same flags."""
    j, _, (_, jw, jv), (_, tw, tv) = trials
    got = jax_preparation(monkeypatch, ["--system", "ne", "--seed", "7", *flags], j, jw, jv)
    args = flagship.parser().parse_args(["--system", "ne", "--seed", "7", *flags])
    cfg, trial, init_vec, determ = flagship.prepare(tw, tv, args, flagship.SYSTEMS["ne"])
    assert got["seed"] == args.seed
    port_fields = {f.name for f in dataclasses.fields(cfg)}
    for f in dataclasses.fields(got["cfg"]):
        if f.name in port_fields:
            assert getattr(cfg, f.name) == getattr(got["cfg"], f.name), f.name
        else:   # the TPU's emission chunking: left at its default
            assert getattr(got["cfg"], f.name) == f.default, f.name
    for (pw, pv), (rw, rv) in ((trial, got["trial"]), (init_vec, got["init_vec"])):
        order = np.argsort(pw[:, 0])
        rorder = np.argsort(np.asarray(rw)[:, 0])
        np.testing.assert_array_equal(pw[order], np.asarray(rw)[rorder].astype(np.int64))
        np.testing.assert_allclose(pv[order], np.asarray(rv)[rorder], rtol=1e-10, atol=1e-13)
    if got["determ_keys"] is None:
        assert determ is None
    else:
        assert {int(x) for x in determ[:, 0]} == {int(x) for x in got["determ_keys"][:, 0]}


def jax_summary(num, den, exact, burn, published):
    """fries_tpu.stats plus the gates of tools/flagship.py:261-281 and
    tools/package_n2_result.py:56-62."""
    burn = min(burn, len(num) * 2 // 3)
    out = jstats.trajectory_stats(num, den, exact_corr=exact, burn_in=burn)
    n_indep = (len(num) - burn) / max(out["iat"], 1.0)
    res = {"burn_in": burn, "e_corr": out["e_corr"], "iat": out["iat"],
           "efficiency": out["efficiency"], "n_independent_samples": round(float(n_indep), 1)}
    if n_indep >= 20.0:
        res["error_mEh"] = out["error_mEh"]
        res["two_sigma_mEh"] = out["two_sigma_mEh"]
        res["consistent_with_published"] = bool(
            abs(out["error_mEh"] - published[0]) <= np.hypot(out["two_sigma_mEh"], published[1]))
        res["within_0p1_mEh"] = bool(abs(out["error_mEh"]) <= 0.1)
    else:
        res["unconverged_estimate_mEh"] = out["error_mEh"]
    return res


@pytest.mark.parametrize("n, burn, gate", [(6000, 2000, True), (300, 4000, False)])
def test_summarize_matches_reference_stats_and_gate(n, burn, gate):
    """An AR(1) trajectory made from a seed: the stationary one passes the
    gate, a short one with a decaying transient does not."""
    rng = np.random.default_rng(5)
    noise = np.empty(n)
    noise[0] = rng.standard_normal()
    for i in range(1, n):
        noise[i] = 0.9 * noise[i - 1] + rng.standard_normal()
    den = 50.0 + 0.5 * rng.standard_normal(n)
    num = den * (-0.2131 + 1e-4 * noise + (0 if gate else 5e-3 * np.exp(-np.arange(n) / 80)))
    meta = flagship.SYSTEMS["ne"]
    row = meta["rows"][(150_000, 50)]
    got = flagship.summarize(num, den, meta, burn, published=row)
    want = jax_summary(num, den, meta["exact_corr"], burn, row)
    assert ("diagnosis" not in got) == gate
    assert set(got) - {"diagnosis"} == set(want)
    for k, v in want.items():
        if isinstance(v, bool):
            assert got[k] is v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0, err_msg=k)
    if not gate:
        assert got["diagnosis"].startswith("TRANSIENT NOT BURNED IN")


SMALL_META = {"exact_corr": -0.2, "budget": 600, "capacity": 2048, "published": "none",
              "rows": {}}


def small_run(tmp_path, name, trials, *extra):
    _, t, _, (e, tw, tv) = trials
    args = flagship.parser().parse_args([
        "--device", "cpu", "--determ", "6", "--initiator", "1.0", "--eps", "0.05",
        "--iters", "8", "--burn", "4", "--scan", "2", "--block", "4", "--save_interval", "4",
        "--result_dir", str(tmp_path / name), *extra])
    return flagship.run(t, (tw, tv), args, SMALL_META, e_cisd=e, log=lambda s: None)


def test_run_resumes_exactly(tmp_path, trials):
    """Two blocks straight, and one block then a resume from its
    checkpoint: the same five streams, line for line, and the same
    result.json statistics (the transient diagnosis at 8 iterations)."""
    straight = small_run(tmp_path, "straight", trials)
    small_run(tmp_path, "resumed", trials, "--iters", "4")
    resumed = small_run(tmp_path, "resumed", trials, "--load_dir", str(tmp_path / "resumed"))
    for name in flagship.STREAMS:
        a = (tmp_path / "straight" / f"{name}.txt").read_text().splitlines()
        b = (tmp_path / "resumed" / f"{name}.txt").read_text().splitlines()
        assert len(a) == 8 and a == b, name
    saved = json.loads((tmp_path / "resumed" / "result.json").read_text())
    assert saved["diagnosis"].startswith("TRANSIENT NOT BURNED IN")
    assert resumed["iterations_this_process"] == 4 and straight["iterations_this_process"] == 8
    for k in ("e_corr", "iat", "efficiency", "unconverged_estimate_mEh", "norm_max",
              "n_dets_final"):
        assert saved[k] == straight[k], k
    assert np.load(tmp_path / "resumed" / "checkpoint.npz")["iterat"] == 8


def test_cli_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "-m", "fries_tpu_torch.flagship", "--iters", "2"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_flagship_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['fries_tpu'] = None\n"
            "import fries_tpu_torch.flagship\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'fries_tpu.')) "
            "for m in sys.modules if sys.modules[m] is not None)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
