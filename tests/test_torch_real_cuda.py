"""The integral pipeline on the card against the CPU.

Marked ``cuda``: every test skips without a CUDA device (decided inside
the ``cuda`` fixture, never at import).  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_real_cuda.py -q``.  N2 and
H2O in cc-pVDZ are built on the card and on the CPU and compared after the
gauge alignment (hcore and ERIs at 1e-10, E_HF at 1e-9, irreps equal);
Ne/cc-pVQZ on the card has the reference pipeline's total RHF energy
(-128.54347011764926 Ha, the JAX package on a CPU) and the irreps of
``rung.NE_QZ_SYMM``; N2's CISD on the card equals the CPU's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fries_tpu_torch import cisd, real_systems, rung, scf  # noqa: E402

pytestmark = pytest.mark.cuda

E_NE_QZ = -128.54347011764926


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["n2_ccpvdz", "h2o_ccpvdz"])
def test_card_build_matches_cpu(cuda, name):
    gham, ginfo = real_systems.build(name, cuda)
    cham, cinfo = real_systems.build(name, "cpu")
    assert gham.hcore.device.type == "cuda"
    assert abs(ginfo["e_hf_total"] - cinfo["e_hf_total"]) < 1e-9
    np.testing.assert_array_equal(ginfo["irreps"], cinfo["irreps"])
    o, off = scf.gauge_alignment(ginfo["C"].cpu(), cinfo["C"], cinfo["S"], cinfo["mo_energy"],
                                 cinfo["irreps"])
    assert off < 1e-8
    hcore, eris = scf.rotate_mo_integrals(gham.hcore.cpu(), gham.eris.cpu(), o)
    np.testing.assert_allclose(hcore.numpy(), cham.hcore.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(eris.numpy(), cham.eris.numpy(), rtol=0, atol=1e-10)


def test_ne_ccpvqz_energy_and_irreps(cuda):
    ham, info = real_systems.build("ne_ccpvqz", cuda)
    assert abs(info["e_hf_total"] - E_NE_QZ) < 1e-8
    assert tuple(ham.symm.tolist()) == rung.NE_QZ_SYMM
    assert (ham.n_orb, ham.n_elec, ham.n_words) == (54, 8, 4)
    assert rung.ne_qz_single(ham) == (3, 6)


def test_card_cisd_matches_cpu(cuda):
    cham = real_systems.n2_ccpvdz("cpu")
    gham = type(cham)(cham.hcore.to(cuda), cham.eris.to(cuda), cham.symm.to(cuda), cham.n_orb,
                      cham.n_elec, cham.n_frozen)
    e_c, w_c, v_c = cisd.cisd_ground_state(cham)
    e_g, w_g, v_g = cisd.cisd_ground_state(gham)
    assert abs(e_g - e_c) < 1e-10
    assert torch.equal(w_g.cpu(), w_c)
    np.testing.assert_allclose(v_g.cpu().numpy(), v_c.numpy(), rtol=0, atol=1e-9)
    space_g, _ = rung.cisd_determ_space(gham)
    space_c, _ = rung.cisd_determ_space(cham)
    np.testing.assert_array_equal(space_g, space_c)
