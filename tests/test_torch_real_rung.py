"""The real-molecule configurations of ``fries_tpu_torch.rung`` against
bench.py's real branches and ``tools/real_systems.py``: every parameter of
``rung_real``, ``semistoch_cisd``, ``frifull_real``, ``fciqmc_real``,
``ne_qz`` and ``ne_qz_subsp`` and every system's geometry, basis and frozen
core, read from the reference's source; ``rung.NE_QZ_SYMM`` against the
Ne/cc-pVQZ shells; and ``semistoch_cisd``'s space, the 150 determinants of
largest |c| of the port's CISD on N2/cc-pVDZ, against the same rule on
the reference's CISD of that Hamiltonian (its integrals are held to the
reference's in ``test_torch_scf.py``)."""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fries_tpu import basis as jbasis, cisd as jcisd  # noqa: E402
from fries_tpu.ops import molecule as jmol  # noqa: E402
from fries_tpu_torch import real_systems, rung  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(path):
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read())


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _call(node, attr):
    return next(n for n in ast.walk(node) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", getattr(n.func, "id", None)) == attr)


def _value(node, real=True):
    """A keyword's value; a conditional takes its real-molecule branch."""
    if isinstance(node, ast.IfExp):
        node = node.body if real else node.orelse
    return eval(compile(ast.Expression(node), "bench.py", "eval"))


def _ladder():
    node = next(n for n in ast.walk(_tree("bench.py")) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "FULL_LADDER")
    return eval(compile(ast.Expression(node.value), "bench.py", "eval"))


@pytest.mark.parametrize("name", sorted(real_systems.SYSTEMS))
def test_systems_are_tools_real_systems(name):
    """Geometry, basis and frozen core of each system, as
    tools/real_systems.py builds it."""
    fn = _function(_tree("tools/real_systems.py"), name)
    consts = {}
    for n in ast.walk(fn):     # r = 2.068, or r, th = 1.84345, np.deg2rad(110.6)
        if isinstance(n, ast.Assign) and isinstance(n.value, (ast.Constant, ast.Tuple)):
            names = ([n.targets[0]] if isinstance(n.targets[0], ast.Name)
                     else n.targets[0].elts)
            values = [n.value] if isinstance(n.value, ast.Constant) else n.value.elts
            for t, v in zip(names, values):
                if isinstance(v, ast.Constant):
                    consts[t.id] = v.value
                elif isinstance(v, ast.Call) and getattr(v.func, "attr", None) == "deg2rad":
                    consts[t.id] = np.deg2rad(v.args[0].value)
    call = _call(fn, "build_molecule")
    kw = {k.arg: _value(k.value) for k in call.keywords}
    symbols = _value(call.args[0])
    got_symbols, centers, basis, n_frozen = real_systems.SYSTEMS[name]
    assert (got_symbols, basis, n_frozen) == (symbols, kw["basis"], kw["n_frozen"])
    if "r" in consts and "th" not in consts:        # N2: atoms at +- r / 2 on z
        r = consts["r"]
        np.testing.assert_array_equal(centers, [[0, 0, -r / 2], [0, 0, r / 2]])
    elif "r" in consts:                               # H2O: O at the origin, C2v in yz
        r, th = consts["r"], consts["th"]
        y, z = r * np.sin(th / 2), r * np.cos(th / 2)
        np.testing.assert_array_equal(centers, [[0, 0, 0], [0, y, z], [0, -y, z]])
    else:
        np.testing.assert_array_equal(centers, np.zeros((1, 3)))


def test_rung_real_is_bench_default_frisys():
    """bench.py's default frisys branch: the 1e6 rung on real N2/cc-pVDZ."""
    name, vec_nonz, matr_samp, cap, spawn_cap, *_ = _ladder()[0]
    cfg = rung.config()
    assert (name, cfg.vec_nonz, cfg.matr_samp, cfg.capacity, cfg.spawn_cap) == (
        "1e6", vec_nonz, matr_samp, cap, spawn_cap)
    assert (cfg.eps, cfg.target_norm, cfg.init_thresh) == (0.001, 2.0 * vec_nonz, 0.0)
    main = _function(_tree("bench.py"), "main")
    assert any(isinstance(n, ast.Attribute) and n.attr == "n2_ccpvdz" for n in ast.walk(main))


def test_semistoch_cisd_size_is_flagship():
    """tools/flagship.py's --determ takes the top |c| of the CISD vector;
    its documented row (Results.tex:142) is 150."""
    src = open(os.path.join(REPO, "tools/flagship.py")).read()
    assert "--determ 150" in src and "np.argsort(-np.abs(tvals))[: args.determ]" in src
    assert rung.N_DETERM == 150


def test_frifull_real_is_bench_frifull_real():
    fn = _function(_tree("bench.py"), "bench_frifull_mol")
    kw = {k.arg: _value(k.value, real=True) for k in _call(fn, "PowerConfig").keywords}
    cfg = rung.frifull_real_config()
    for k, v in kw.items():
        assert getattr(cfg, k) == v, k
    assert kw["capacity"] == 1 << 21 and kw["dedup_cap"] == 1 << 19
    k_assign = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", None) == "k")
    assert rung.FRIFULL_REAL_ORBITALS == _value(k_assign.value) == 12
    assert _value(_call(fn, "build").keywords[0].value) == 0


def test_fciqmc_real_is_bench_fciqmc_real():
    """bench.py's fciqmc configuration (its real branch runs n2_stretched)
    with bench.py's own values under ``bench_values``, and the port's two
    changes (shift_interval 1, capacity 2^22) otherwise."""
    fn = _function(_tree("bench.py"), "bench_fciqmc")
    assert _value(_call(fn, "_real_or_synth").args[0]) == "n2_stretched"
    kw = {k.arg: k.value for k in _call(fn, "FciqmcConfig").keywords}
    kw.pop("attempt_chunk")
    bench = rung.fciqmc_config(bench_values=True)
    for k, v in kw.items():
        assert getattr(bench, k) == _value(v), k
    assert bench.shift_interval == 10 and "shift_interval" not in kw
    got = rung.fciqmc_config()
    assert (got.capacity, got.shift_interval) == (1 << 22, 1)
    for k in kw:
        if k != "capacity":
            assert getattr(got, k) == getattr(bench, k), k


def test_ne_qz_is_bench_500k_and_real_subsp():
    name, vec_nonz, matr_samp, cap, spawn_cap, *_ = _ladder()[1]
    cfg = rung.ne_qz_config()
    assert (name, cfg.vec_nonz, cfg.matr_samp, cfg.capacity, cfg.spawn_cap) == (
        "500k", vec_nonz, matr_samp, cap, spawn_cap)
    assert (cfg.eps, cfg.target_norm, cfg.init_thresh) == (0.001, 2.0 * vec_nonz, 1.0)
    fn = _function(_tree("bench.py"), "bench_subsp_sharded")
    getenv = _call(fn, "get")
    assert _value(getenv.args[1]) == "ne_ccpvqz"


def test_ne_qz_symm_is_real_composition():
    """NE_QZ_SYMM holds the real RHF orbitals' irreps (checked against the
    build on the card by chip_smoke.py and tests/test_torch_real_cuda.py):
    cc-pVQZ's shells for Ne less the frozen 1s, 2s and 2p first; bench.py's
    single on it is HOMO (3, B3u) -> the 3p of B3u (6)."""
    by_l = {0: [0], 1: [5, 6, 7], 2: [0, 0, 1, 2, 3], 3: [4, 5, 5, 6, 6, 7, 7],
            4: [0, 0, 0, 1, 1, 2, 2, 3, 3]}
    counts = np.zeros(8, int)
    for l, _ in jbasis._ne_qz_shells():
        np.add.at(counts, by_l[l], 1)
    counts[0] -= 1
    symm = np.asarray(rung.NE_QZ_SYMM)
    np.testing.assert_array_equal(np.bincount(symm, minlength=8), counts)
    assert list(symm[:7]) == [0, 5, 6, 7, 5, 6, 7]

    class Shape:
        n_orb, n_elec = 54, 8
        symm = torch.as_tensor(rung.NE_QZ_SYMM)

    assert rung.ne_qz_single(Shape) == (3, 6)


@pytest.fixture(scope="module")
def n2():
    return real_systems.n2_ccpvdz("cpu")


@pytest.fixture(scope="module")
def reference_cisd(n2):
    """The reference's CISD ground state of the port's N2/cc-pVDZ."""
    jham = jmol.MolecularHamiltonian(
        hcore=jnp.asarray(n2.hcore.numpy()), eris=jnp.asarray(n2.eris.numpy()),
        symm=jnp.asarray(n2.symm.numpy().astype(np.int32)), n_orb=n2.n_orb,
        n_elec=n2.n_elec, n_frozen=n2.n_frozen)
    return jcisd.cisd_ground_state(jham)


def test_semistoch_cisd_space_matches_reference_cisd(n2, reference_cisd):
    """The port's space (CISD on N2/cc-pVDZ, 150 largest |c|, |c| rounded
    to 1e-10, ties in the arena's order) equals the same rule applied to
    the reference's CISD of the same Hamiltonian; it holds HF and reaches
    into the spin-flip tie at the 150th place."""
    e_ref, w_ref, v_ref = reference_cisd
    space, e_cisd = rung.cisd_determ_space(n2)
    assert abs(e_cisd - e_ref) < 1e-10
    mag = np.round(np.abs(v_ref), 10)
    top = np.lexsort((np.arange(len(mag)), -mag))[:rung.N_DETERM]
    np.testing.assert_array_equal(space, w_ref.astype(np.int64)[top])
    assert space.shape == (150, n2.n_words)
    hf = np.zeros(n2.n_words, np.int64)
    hf[0] = (1 << 5) - 1 | ((1 << 5) - 1) << n2.n_orb
    np.testing.assert_array_equal(space[0], hf)
    assert mag[top[-1]] == mag[np.lexsort((np.arange(len(mag)), -mag))[rung.N_DETERM]]
