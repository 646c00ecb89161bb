"""The data maker: symmetric integrals, the irreps projected, the same from
one seed."""

import torch

from benchmark import data

SYMM = [0, 1, 0, 1, 0, 1, 2, 3, 0, 5]


def _make(seed):
    return data.integrals(len(SYMM), SYMM, seed, 0.1, 3.0, 0.05, "cpu")


def test_symmetric_and_projected():
    h, v = _make(5)
    g = torch.tensor(SYMM)
    assert torch.equal(h, h.T)
    assert torch.all(h[g[:, None] != g[None, :]] == 0)
    # physicist <pq|rs>: the eight real-orbital symmetries
    for perm in ((1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0), (2, 1, 0, 3), (0, 3, 2, 1),
                 (3, 0, 1, 2), (1, 2, 3, 0)):
        assert torch.allclose(v, v.permute(perm), rtol=0, atol=1e-15)
    broken = (g[:, None, None, None] ^ g[None, :, None, None] ^ g[None, None, :, None]
              ^ g[None, None, None, :]) != 0
    assert torch.all(v[broken] == 0) and torch.any(v[~broken] != 0)


def test_repeats_from_a_seed():
    assert all(torch.equal(a, b) for a, b in zip(_make(2**31 + 7), _make(2**31 + 7)))
    assert not torch.equal(_make(1)[1], _make(2)[1])


def test_system_from_a_config():
    conf = {"n_orb": len(SYMM), "n_elec": 4, "symm": SYMM,
            "integrals": {"seed": 9, "scale_two": 0.1, "diag_spread": 3.0, "offdiag": 0.05}}
    s = data.make_system(conf, "cpu")
    assert s.eris.shape == (10,) * 4 and s.n_elec == 4
    assert torch.equal(s.hcore, _make(9)[0])
