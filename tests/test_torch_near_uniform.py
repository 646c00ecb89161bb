"""The port's excitation samplers and walker roundings against the reference
package, fed the reference's draws (``jax_keys.JaxKeys``): the near-uniform
doubles and singles and the heat-bath doubles (orbitals, ``valid`` exact,
``prob`` within rtol 1e-12), ``round_binomially``, ``stochastic_round`` and
``sample_categorical_rows`` (exact); then the port's own key tree
(``rng.KeyTree``) in statistics: binomial means and variances, and the
samplers' unbiasedness against the exact H column.  Systems: 5 orbitals / 4
electrons with and without symmetry and 8 orbitals / 4 electrons, numpy
seeded."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dense_fci  # noqa: E402
from fries_tpu import compress as jc  # noqa: E402
from fries_tpu import dets as jd  # noqa: E402
from fries_tpu.ops import heat_bath as jhb  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu.ops import near_uniform as jnu  # noqa: E402
from fries_tpu_torch import compress as tc  # noqa: E402
from fries_tpu_torch import convert, dets as td, rng as trng  # noqa: E402
from fries_tpu_torch.ops import heat_bath as thb  # noqa: E402
from fries_tpu_torch.ops import molecule as tmol  # noqa: E402
from fries_tpu_torch.ops import near_uniform as tnu  # noqa: E402
from jax_keys import JaxKeys  # noqa: E402

CASES = {"5-nosymm": (5, 4, None, 6), "5-symm": (5, 4, [0, 1, 0, 1, 0], 6),
         "8-symm": (8, 4, [0, 1, 0, 1, 0, 1, 2, 3], 3)}


def build_ham(n_orb, n_elec, symm=None, seed=0):
    """(reference Hamiltonian, port Hamiltonian, hcore, eris): random
    integrals projected onto the irreps ``symm``, as tests/test_fciqmc.py
    builds them."""
    h, eris = dense_fci.random_integrals(np.random.default_rng(seed), n_orb)
    symm = np.zeros(n_orb, np.int32) if symm is None else np.asarray(symm, np.int32)
    h = np.where(symm[:, None] == symm[None, :], h, 0.0)
    g = symm
    allowed = (g[:, None, None, None] ^ g[None, :, None, None]
               ^ g[None, None, :, None] ^ g[None, None, None, :]) == 0
    eris = np.where(allowed, eris, 0.0)
    j = jmol.MolecularHamiltonian(hcore=jnp.asarray(h), eris=jnp.asarray(eris),
                                  symm=jnp.asarray(symm), n_orb=n_orb, n_elec=n_elec)
    t = convert.hamiltonian(h, eris, symm, n_orb, n_elec)
    return j, t, h, eris


def exact_column(j, words, occ):
    """{word tuple: summed amplitude} of H's off-diagonal column (reference)."""
    tmpl = jmol.ExcitationTemplate.build(j.n_orb, j.n_elec)
    ew, ea, _ = jmol.exact_offdiag_batch(j, tmpl, words, occ, jnp.ones(words.shape[0]), 1.0)
    out = {}
    for w, x in zip(np.asarray(ew.reshape(-1, j.n_words)), np.asarray(ea.reshape(-1))):
        if x != 0:
            out[tuple(w)] = out.get(tuple(w), 0.0) + x
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def parents(request):
    """A system and a batch of parents (HF and its connections, tiled to
    about 3000 rows) in both packages' forms."""
    n_orb, n_elec, symm, seed = CASES[request.param]
    j, t, _, _ = build_ham(n_orb, n_elec, symm, seed)
    hfw, hfo, _ = jmol.hf_reference(j)
    conn = np.array(sorted(exact_column(j, hfw[None], hfo[None])), dtype=np.uint32)
    words = np.concatenate([np.asarray(hfw)[None], conn.reshape(-1, j.n_words)])
    words = np.tile(words, (-(-3000 // len(words)), 1))
    jsi = jmol.SymmInfo.build(np.asarray(j.symm))
    tsi = tmol.SymmInfo.build(t.symm.numpy())
    jw = jnp.asarray(words)
    jocc = jd.occ_list(jw, 2 * n_orb, n_elec)
    jbits = jd.unpack_bits(jw, 2 * n_orb)
    jcounts = jhb.unocc_symm_counts(n_orb, n_elec, jnp.asarray(jsi.symm),
                                    jnp.asarray(jsi.counts), jocc)
    tw = torch.as_tensor(words.astype(np.int64))
    tocc = td.occ_list(tw, 2 * n_orb, n_elec)
    tsymm = torch.as_tensor(tsi.symm)
    tcounts = thb.unocc_symm_counts(n_orb, n_elec, tsymm, torch.as_tensor(tsi.counts), tocc)
    return {
        "name": request.param, "j": j, "t": t, "n_orb": n_orb, "n_elec": n_elec,
        "ref": (jnp.asarray(jsi.symm), jnp.asarray(jsi.lookup), jocc, jbits, jcounts),
        "port": (tsymm, torch.as_tensor(tsi.lookup), tocc, td.unpack_bits(tw, 2 * n_orb),
                 tcounts),
    }


def draw_both(p, sampler, key):
    """One draw of ``sampler`` per parent from the reference (jitted: its
    op-by-op dispatch compiles every primitive) and from the port."""
    n_orb, n_elec = p["n_orb"], p["n_elec"]
    jsymm, jlookup, jocc, jbits, jcounts = p["ref"]
    tsymm, tlookup, tocc, tbits, tcounts = p["port"]
    if sampler == "HB":
        tens = jhb.setup(p["j"])
        ref = jax.jit(lambda k, o, b: jnu.sample_doubles_heat_bath(
            k, tens, n_orb, n_elec, jsymm, jlookup, o, b))(key, jocc, jbits)
        got = tnu.sample_doubles_heat_bath(JaxKeys(key), thb.setup(p["t"]), n_orb, n_elec,
                                           tsymm, tlookup, tocc, tbits)
    else:
        fj, ft = ((jnu.sample_doubles, tnu.sample_doubles) if sampler == "NU"
                  else (jnu.sample_singles, tnu.sample_singles))
        ref = jax.jit(fj, static_argnums=(1, 2))(key, n_orb, n_elec, jsymm, jlookup, jocc,
                                                 jbits, jcounts)
        got = ft(JaxKeys(key), n_orb, n_elec, tsymm, tlookup, tocc, tbits, tcounts)
    return ref, got


@pytest.mark.parametrize("sampler", ["NU", "HB", "singles"])
def test_samplers_match_reference(parents, sampler):
    """Orbitals and ``valid`` exact and ``prob`` within rtol 1e-12, row by
    row.  The heat-bath sampler's f32 row prefixes may differ from the
    reference's in the last bit (``compress.sample_categorical_rows``);
    at most 0.01% of its rows may then pick another index."""
    ref, got = draw_both(parents, sampler, jax.random.key(11))
    names = ("o", "u") if sampler == "singles" else ("o1", "o2", "u1", "u2")
    same = np.asarray(ref["valid"]) == got["valid"].numpy()
    for name in names:
        same &= np.asarray(ref[name]) == got[name].numpy()
    limit = 1e-4 if sampler == "HB" else 0.0
    assert (~same).mean() <= limit, (parents["name"], sampler, int((~same).sum()))
    assert got["valid"].any()
    np.testing.assert_allclose(got["prob"].numpy()[same], np.asarray(ref["prob"])[same],
                               rtol=1e-12, atol=0)


def test_tri_to_pair_matches_reference():
    for n_elec in (4, 14):
        tri = np.arange(n_elec * (n_elec - 1) // 2, dtype=np.float64)
        ref = jnu.tri_to_pair(n_elec, jnp.asarray(tri))
        got = tnu.tri_to_pair(n_elec, torch.as_tensor(tri))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_round_binomially_matches_reference():
    rng = np.random.default_rng(3)
    p = rng.random(4000) * np.where(rng.random(4000) < 0.3, 40.0, 1.5)
    n = rng.integers(0, 9, 4000).astype(np.int32)
    key = jax.random.key(21)
    ref = np.asarray(jax.jit(jc.round_binomially)(key, jnp.asarray(p), jnp.asarray(n)))
    got = tc.round_binomially(JaxKeys(key), torch.as_tensor(p), torch.as_tensor(n))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


def test_stochastic_round_matches_reference():
    p = np.random.default_rng(4).random(4000) * 3.0
    key = jax.random.key(22)
    ref = np.asarray(jax.jit(jc.stochastic_round)(key, jnp.asarray(p)))
    got = tc.stochastic_round(JaxKeys(key), torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k", [3, 7, 14, 28])
def test_sample_categorical_rows_matches_reference(k):
    """Exact at these sizes: the f32 prefixes (left-to-right here, the
    reference's matmul order there) differ at most in their last bit, and
    an index moves only where the row's uniform lands in that bit.  One
    named difference: where u lands past every prefix, the reference's
    count capped at K - 1 may be a column of weight 0, and the port draws
    the row's last column of positive weight instead (a reference fault not
    copied; ``tests/test_torch_fciqmc_hb_draw.py`` builds that case)."""
    rng = np.random.default_rng(k)
    probs = rng.random((3000, k)) * (rng.random((3000, k)) < 0.7)
    probs[:, 0] += 1e-3
    probs /= probs.sum(1, keepdims=True)
    valid = rng.random((3000, k)) < 0.9
    key = jax.random.key(30 + k)
    for v in (None, valid):
        ref = np.asarray(jax.jit(jc.sample_categorical_rows)(
            key, jnp.asarray(probs), None if v is None else jnp.asarray(v)))
        got = tc.sample_categorical_rows(JaxKeys(key), torch.as_tensor(probs),
                                         None if v is None else torch.as_tensor(v))
        p = probs if v is None else np.where(v, probs, 0.0)
        last_positive = k - 1 - np.argmax(p[:, ::-1] > 0, 1)
        weightless = (p[np.arange(p.shape[0]), ref] == 0) & (p.sum(1) > 0)
        np.testing.assert_array_equal(got.numpy(), np.where(weightless, last_positive, ref))


@pytest.mark.parametrize("n,p", [(1, 0.3), (7, 0.45), (4_000_000, 0.3)])
def test_keytree_binomial_statistics(n, p):
    """The port's own binomial: mean and variance within 5 sigma of n p and
    n p q over 200,000 draws; equal draws from equal nodes, different ones
    from sibling nodes."""
    m = 200_000
    node = trng.KeyTree(9).fold(n)
    x = node.binomial(torch.full((m,), n), torch.full((m,), p, dtype=torch.float64))
    assert x.dtype == torch.int64 and int(x.min()) >= 0 and int(x.max()) <= n
    q = 1.0 - p
    var = n * p * q
    mu4 = var * (1 + 3 * (n - 2) * p * q)
    xf = x.double()
    assert abs(float(xf.mean()) - n * p) < 5 * np.sqrt(var / m)
    assert abs(float(xf.var()) - var) < 5 * np.sqrt((mu4 - var ** 2) / m)
    again = node.binomial(torch.full((m,), n), torch.full((m,), p, dtype=torch.float64))
    assert torch.equal(again, x)
    other = trng.KeyTree(9).fold(n + 1).binomial(torch.full((m,), n),
                                                 torch.full((m,), p, dtype=torch.float64))
    assert not torch.equal(other, x)


def test_keytree_round_binomially_unbiased():
    p = torch.tensor([0.25, 1.5, 2.75, 0.0])
    n = torch.tensor([4, 3, 0, 5])
    draws = torch.stack([tc.round_binomially(trng.KeyTree(1).fold(i), p, n)
                         for i in range(4000)]).double()
    want = p.double() * n
    assert torch.all((draws.mean(0) - want).abs() <= 5 * (draws.std(0) / 4000 ** 0.5) + 1e-12)
    assert torch.equal(draws[:, 2:], torch.zeros(4000, 2, dtype=torch.float64))


@pytest.mark.parametrize("mode", ["NU", "HB"])
@pytest.mark.parametrize("with_symm", [False, True])
def test_sampler_unbiased_keytree(mode, with_symm):
    """E[mel / p_gen per attempt] from HF reconstructs the exact H column,
    with the port's own key tree (as tests/test_fciqmc.py holds the
    reference's samplers)."""
    n_orb, n_elec = 5, 4
    j, t, _, _ = build_ham(n_orb, n_elec, [0, 1, 0, 1, 0] if with_symm else None, 6)
    si = tmol.SymmInfo.build(t.symm.numpy())
    symm, lookup = torch.as_tensor(si.symm), torch.as_tensor(si.lookup)
    tens = thb.setup(t)
    hfw, hfo, _ = tmol.hf_reference(t)
    b, n_batches = 4096, 40
    words, occ = hfw[None].repeat(b, 1), hfo[None].repeat(b, 1)
    bits = td.unpack_bits(words, 2 * n_orb)
    counts = thb.unocc_symm_counts(n_orb, n_elec, symm, torch.as_tensor(si.counts), occ)
    acc = {}
    root = trng.KeyTree(3)
    for i in range(n_batches):
        kd, ks = root.fold(i).split(2)
        if mode == "HB":
            d = tnu.sample_doubles_heat_bath(kd, tens, n_orb, n_elec, symm, lookup, occ, bits)
        else:
            d = tnu.sample_doubles(kd, n_orb, n_elec, symm, lookup, occ, bits, counts)
        s = tnu.sample_singles(ks, n_orb, n_elec, symm, lookup, occ, bits, counts)
        dmel = tmol.doub_matr_el(t, d["o1"], d["o2"], d["u1"], d["u2"])
        dw, dsign = td.double_parity(words, d["o1"], d["o2"], d["u1"], d["u2"])
        sw, ssign = td.single_parity(words, s["o"], s["u"])
        smel = tmol.sing_matr_el(t, s["o"], s["u"], occ)
        for w_arr, amp in ((dw, torch.where(d["valid"], dmel * dsign / d["prob"], 0.0)),
                           (sw, torch.where(s["valid"], smel * ssign / s["prob"], 0.0))):
            live = amp != 0
            for w, x in zip(w_arr[live].numpy(), amp[live].numpy()):
                acc[tuple(w)] = acc.get(tuple(w), 0.0) + x / (n_batches * b)
    jhfw, jhfo, _ = jmol.hf_reference(j)
    want = exact_column(j, jhfw[None], jhfo[None])
    tot = sum(abs(v) for v in want.values())
    for k in set(acc) | set(want):
        got, expect = acc.get(k, 0.0), want.get(k, 0.0)
        assert abs(got - expect) < 0.12 * max(tot / 20, abs(expect)), (k, got, expect)
