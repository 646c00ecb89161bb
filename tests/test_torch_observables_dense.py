"""The port's observable estimators against dense FCI: the Rayleigh and the
replica estimator of O = sum_s a^+_2,s a_1,s on the 5-orbital / 4-electron
system of ``tests/test_observables.py`` at a deterministic budget, against
<psi0|O|psi0> / <psi0|psi0> of the dense ground state (atol 5e-3, the
reference's test)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import dense_fci  # noqa: E402
from fries_tpu_torch import convert  # noqa: E402
from fries_tpu_torch.drivers import observables as tobs  # noqa: E402
from test_observables import dense_one_elec  # noqa: E402


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(31)
    h, eris = dense_fci.random_integrals(rng, 5)
    return None, convert.hamiltonian(h, eris, np.zeros(5), 5, 4), h, eris


@pytest.mark.parametrize("replica,n_steps,burn_in", [(False, 600, 300), (True, 200, 100)])
def test_observable_matches_dense_rdm(system, replica, n_steps, burn_in):
    """The reference's test (eps 0.05, deterministic budget, atol 5e-3) on the
    port: Rayleigh over its 600 steps; replica over 200 steps from a burn-in
    of 100, which this system's power iteration converges in (error about
    5e-6) and which keeps the file's time down."""
    _, t, h, eris = system
    dense_h, basis = dense_fci.build_hamiltonian(h, eris, 5, 2, 2)
    _, psi0 = dense_fci.ground_state(dense_h)
    op = dense_one_elec(basis, 5, 1, 2)
    want = psi0 @ op @ psi0 / (psi0 @ psi0)
    cfg = tobs.ObservablesConfig(eps=0.05, target_nonz=256, capacity=128, obs_des=1, obs_cre=2,
                                 burn_in=burn_in, n_obs=10, btw_obs=10, replica=replica)
    _, run_steps, state, _ = tobs.build(t, cfg, seed=2)
    _, traj = run_steps(state, n_steps)
    assert not bool(traj["overflow"].any())
    num, den = traj["obs_num"].numpy(), traj["obs_den"].numpy()
    sel = np.arange(n_steps) >= burn_in if replica else traj["in_obs"].numpy()
    np.testing.assert_allclose(num[sel].sum() / den[sel].sum(), want, atol=5e-3)
