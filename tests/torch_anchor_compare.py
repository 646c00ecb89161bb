"""The 48,400-determinant anchor of ``fries_tpu_torch.anchor_scale`` against
the JAX package's ``frisys`` at full size on the CPU, on one Ritz trial:
each package's norm, shift, estimator and determinant count along the
first steps.  Not a test (minutes a step pair at this size); run it from
the repository's root:

    JAX_PLATFORMS=cpu python tests/torch_anchor_compare.py fed 60
    JAX_PLATFORMS=cpu python tests/torch_anchor_compare.py free jax 400
    JAX_PLATFORMS=cpu python tests/torch_anchor_compare.py free torch 400

``fed``: both packages built from the anchor's flags (seed 6, the port's
top-256 Ritz trial; the script's own ``np.argsort`` choice is checked to
be the same set), the port fed the JAX draws, one line a step for the
first 10 steps and every 5 after, with both packages' numbers.  ``free``: one package alone from its own draws,
a line every 10 steps (``jax_unfused``: the JAX package with levels A+B
and C+D unfused, as its spawner was before they were fused).  The Lanczos
(``anchor_scale.exact_energy`` on the CPU, about 20 minutes) is kept in
``--cache``."""

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from fries_tpu import synth as jsynth  # noqa: E402
from fries_tpu.drivers import frisys as jfs  # noqa: E402
from fries_tpu_torch import anchor_scale, convert  # noqa: E402
from fries_tpu_torch.drivers import frisys as tfs  # noqa: E402

EST = ("num_keys", "num_vals", "den_keys", "den_vals", "ref_key")
SHOWN = ("norm", "shift", "proj_num", "proj_den", "n_dets")


def trial_of(cache):
    """The port's top-256 Ritz trial of the anchor's system (the Lanczos
    read from or written to ``cache``)."""
    if os.path.exists(cache):
        d = np.load(cache)
        ritz, basis = torch.as_tensor(d["ritz"]), torch.as_tensor(d["basis"])
    else:
        j = jsynth.make_system(12, 6, seed=5, scale_two=0.1)
        t = convert.hamiltonian(np.asarray(j.hcore), np.asarray(j.eris), np.asarray(j.symm),
                                12, 6)
        e0, ritz, basis = anchor_scale.exact_energy(t, 3, 3)
        np.savez(cache, e0=e0, ritz=ritz.numpy(), basis=basis.numpy())
    words, tv = anchor_scale.ritz_trial(basis, ritz, 256)
    r = ritz.numpy()
    idx = np.argsort(-np.abs(r))[:256]
    same = set(basis.numpy()[idx, 0].tolist()) == set(np.asarray(words)[:, 0].tolist())
    print(f"# top-256 sets of the port and the script equal: {same}", flush=True)
    return np.asarray(words), np.asarray(tv)


def builds(trial, who):
    """(JAX build, port build) of the anchor's configuration; either is
    None when ``who`` leaves it out."""
    cfg = anchor_scale.anchor_config(anchor_scale.parser().parse_args(["--device", "cpu"]))
    jham = jsynth.make_system(12, 6, seed=5, scale_two=0.1)
    j = t = None
    if who in ("both", "jax", "jax_unfused"):
        jcfg = jfs.FrisysConfig(
            **{f: getattr(cfg, f) for f in ("eps", "vec_nonz", "matr_samp", "capacity",
                                            "spawn_cap", "target_norm", "init_thresh")},
            **({"fuse_ab": False, "fuse_cd": False} if who == "jax_unfused" else {}))
        j = jfs.build(jham, jcfg, seed=6, trial=(trial[0].astype(np.uint32), trial[1]))
    if who in ("both", "torch"):
        tham = convert.hamiltonian(np.asarray(jham.hcore), np.asarray(jham.eris),
                                   np.asarray(jham.symm), 12, 6)
        t = tfs.build(tham, cfg, seed=6, trial=trial)
    return j, t


def fed(trial, n):
    (jstep, _, jstate, jaux), (tstep, _, tstate, taux) = builds(trial, "both")
    jargs = [jaux[k] for k in EST] + [jaux["protected_keys"]]
    targs = [taux[k] for k in EST]
    jstep = jax.jit(jstep)
    t0 = time.time()
    for i in range(n):
        key_spawn, key_vec = jax.random.split(jax.random.fold_in(jstate.key, jstate.iterat))
        rns = np.asarray(jax.random.uniform(key_spawn, (6,), dtype=jnp.float64))
        rn = float(jax.random.uniform(key_vec, dtype=jnp.float64))
        jstate, jm = jstep(jstate, *jargs)
        tstate, tm = tstep(tstate, *targs, rns=rns, rn_vec=rn,
                           protected_keys=taux["protected_keys"])
        if i < 10 or i % 5 == 0 or i == n - 1:
            print(i, " ".join(f"{k}={float(jm[k]):.10g}/{float(tm[k]):.10g}" for k in SHOWN),
                  f"overflow={bool(jm['overflow'])}/{bool(tm['overflow'])}",
                  f"{time.time() - t0:.0f}s", flush=True)


def free(trial, who, n):
    j, t = builds(trial, who)
    _, run, state, aux = j or t
    est = [aux[k] for k in EST]
    t0 = time.time()
    for b in range(n // 10):
        state, tr = run(state, *est, 10)
        g = {k: np.asarray(tr[k]).reshape(-1)[-1] for k in SHOWN}
        ov = bool(np.asarray(tr["overflow"]).any())
        print(who, 10 * b + 9, f"norm={g['norm']:.6g} shift={g['shift']:.5f} "
              f"num={g['proj_num']:.5g} den={g['proj_den']:.5g} "
              f"E={g['proj_num'] / g['proj_den']:.4f} n={g['n_dets']} overflow={ov} "
              f"{time.time() - t0:.0f}s", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("fed", "free"))
    ap.add_argument("rest", nargs="+", help="fed: N; free: {jax,jax_unfused,torch} N")
    ap.add_argument("--cache", default="anchor_lanczos_cpu.npz")
    ap.add_argument("--threads", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    trial = trial_of(args.cache)
    if args.mode == "fed":
        fed(trial, int(args.rest[0]))
    else:
        free(trial, args.rest[0], int(args.rest[1]))


if __name__ == "__main__":
    main()
