"""The heat-bath FCIQMC step where a categorical draw's float32 prefix ends
below the row's float64 total, and the step against the benchmark's plain
reference on an N2/cc-pVDZ-shaped system.

``compress.sample_categorical_rows`` counts the f32 prefixes at or below u
times the f64 total.  Where rounding leaves the last prefix below the total
and u lands in that gap, every prefix counts: the port then draws the last
column of positive weight, as ``benchmark.reference.sampling.categorical``
does (the JAX package caps the count at K - 1, a column that may have
weight 0, and so draws o2 = o1 in a heat-bath double: a determinant with an
electron too many).  ``near_uniform.sample_doubles_heat_bath`` also marks
o1 = o2 invalid.  The uniforms are injected (:class:`FixedKey`); the device
counter ``sampler.fallback`` counts the draws past every prefix while a
profiler records, and adds no operation to a step while none does.  The
system is the benchmark's ``n2_ccpvdz_synth_ifciqmc`` configuration on the
CPU: 26 orbitals, 10 electrons, its irreps and its integrals' seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from benchmark import catalog, check, data, run  # noqa: E402
from benchmark.reference import sampling  # noqa: E402
from benchmark.solvers import fciqmc as fciqmc_solver  # noqa: E402
from fries_tpu_torch import compress, profiling  # noqa: E402
from fries_tpu_torch.ops import heat_bath as hb  # noqa: E402
from fries_tpu_torch.ops import molecule as mol  # noqa: E402
from fries_tpu_torch.ops import near_uniform as nu  # noqa: E402

F64 = torch.float64
CONFIG = "benchmark/configs/n2_ccpvdz_synth_ifciqmc.json"
U_PAST = 1.0 - 2.0 ** -45   # past every f32 prefix that rounded below the total
SEED = 2**31 + 5


class FixedKey:
    """A key node whose uniforms are given: ``uniform(shape)`` returns
    ``values`` in that shape, ``split(n)`` the nodes of ``children``."""

    def __init__(self, values=None, children=()):
        self.values, self.children = values, list(children)

    def uniform(self, shape=()):
        return torch.as_tensor(self.values, dtype=F64).reshape(shape)

    def split(self, n):
        assert n == len(self.children)
        return self.children


def f32_prefix_and_total(p):
    """The port's last f32 prefix (left to right, as f64) and f64 total of
    each row of ``p``."""
    acc = torch.zeros(p.shape[0], dtype=torch.float32)
    tot = torch.zeros(p.shape[0], dtype=F64)
    for c in range(p.shape[1]):
        acc += p[:, c].to(torch.float32)
        tot += p[:, c]
    return acc.to(F64), tot


def capped(key, probs, valid=None):
    """The JAX package's rule: the count of f32 prefixes at or below u times
    the total, capped at K - 1."""
    p = probs.to(F64) if valid is None else torch.where(valid, probs.to(F64), 0.0)
    _, tot = f32_prefix_and_total(p)
    x = key.uniform(p.shape[:-1] + (1,))[..., 0] * tot
    acc = torch.zeros(p.shape[0], dtype=torch.float32)
    idx = torch.zeros(p.shape[0], dtype=torch.int64)
    for c in range(p.shape[1]):
        acc += p[:, c].to(torch.float32)
        idx += acc.to(F64) <= x
    return idx.clamp_max(p.shape[1] - 1)


def rows_below_total(k_pos, k_zero, n, seed=0):
    """``n`` rows of ``k_pos`` positive weights then ``k_zero`` zeros, each
    normalized in f64, whose f32 prefix ends below ``U_PAST`` times the f64
    total."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        w = np.r_[rng.random(k_pos), np.zeros(k_zero)]
        p = torch.as_tensor(w / w.sum())[None]
        last, tot = f32_prefix_and_total(p)
        if last[0] <= U_PAST * tot[0]:
            out.append(p[0])
    return torch.stack(out)


def test_a_draw_past_every_prefix_takes_the_last_positive_column():
    """Rows whose f32 prefix ends below u times the f64 total, followed by
    zero columns, draw their last positive column, as the reference does;
    the capped count draws the zero column K - 1.  Rows where u lands inside
    a prefix draw as before, bit for bit."""
    probs = rows_below_total(5, 3, 6)
    u = torch.full((6,), U_PAST, dtype=F64)
    got = compress.sample_categorical_rows(FixedKey(u), probs)
    assert got.tolist() == [4] * 6
    assert torch.equal(got, sampling.categorical(u, probs))
    assert capped(FixedKey(u), probs).tolist() == [7] * 6   # weight 0

    rng = np.random.default_rng(1)
    more = torch.as_tensor(rng.random((4000, 9)) * (rng.random((4000, 9)) < 0.6))
    more = more / more.sum(1, keepdim=True).clamp_min(1e-300)
    u = torch.as_tensor(rng.random(4000))
    got = compress.sample_categorical_rows(FixedKey(u), more)
    past = f32_prefix_and_total(more)[0] <= u * f32_prefix_and_total(more)[1]
    assert not past.any()
    assert torch.equal(got, capped(FixedKey(u), more))
    assert torch.equal(got, sampling.categorical(u, more))
    zero = torch.zeros((3, 4), dtype=F64)      # a row of zeros: K - 1, as before
    assert compress.sample_categorical_rows(FixedKey(torch.rand(3, dtype=F64)),
                                            zero).tolist() == [3, 3, 3]


@pytest.fixture(scope="module")
def n2():
    """(Hamiltonian, heat-bath tensors, symm, lookup) of the configuration's
    system on the CPU."""
    s = data.make_system(catalog.load_json(catalog.ROOT / CONFIG), "cpu")
    ham = mol.MolecularHamiltonian(hcore=s.hcore, eris=s.eris, symm=s.symm, n_orb=s.n_orb,
                                   n_elec=s.n_elec)
    info = mol.SymmInfo.build(ham.symm.numpy())
    return ham, hb.setup(ham), torch.as_tensor(info.symm), torch.as_tensor(info.lookup)


def _doubles_past_the_prefix(n2, n_rows=8):
    """Parents, and the four uniforms of each, whose first electron is the
    last occupied slot and whose second draw lands past every f32 prefix of
    its row (the first electron's own column, last, has weight 0)."""
    ham, tens, _, _ = n2
    n, e = ham.n_orb, ham.n_elec
    gen = torch.Generator().manual_seed(3)
    occ_rows, u1s = [], []
    while len(occ_rows) < n_rows:
        alpha = torch.randperm(n, generator=gen)[:e // 2].sort().values
        beta = torch.randperm(n, generator=gen)[:e // 2].sort().values + n
        occ = torch.cat([alpha, beta])[None]
        p1, _ = hb.o1_probs(tens, n, occ)
        pre = torch.cumsum(p1[0].to(torch.float32), 0).to(F64)
        o1_idx = torch.tensor([e - 1])
        p2, _ = hb.o2_probs(tens, n, e, occ, o1_idx)
        assert p2[0, -1] == 0
        last, tot = f32_prefix_and_total(p2)
        if last[0] <= U_PAST * tot[0]:
            occ_rows.append(occ[0])
            u1s.append(float((pre[-2] + pre[-1]) / 2 / p1[0].sum()))
    occ = torch.stack(occ_rows)
    u = [torch.tensor(u1s, dtype=F64), torch.full((n_rows,), U_PAST, dtype=F64),
         torch.full((n_rows,), 0.5, dtype=F64), torch.full((n_rows,), 0.5, dtype=F64)]
    return occ, u


def test_heat_bath_doubles_past_the_prefix_keep_the_electron_count(n2, monkeypatch):
    """Uniforms that pick the last electron first and then land past every
    prefix of the second electron's row: no o1 = o2, and every valid double
    leaves five electrons of each spin.  Under the capped count the same
    draws give o1 = o2, which ``valid`` now rejects."""
    ham, tens, symm, lookup = n2
    n, e = ham.n_orb, ham.n_elec
    occ, u = _doubles_past_the_prefix(n2)
    bits = torch.zeros((occ.shape[0], 2 * n), dtype=torch.bool).scatter_(1, occ, True)
    key = FixedKey(children=[FixedKey(x) for x in u])
    d = nu.sample_doubles_heat_bath(key, tens, n, e, symm, lookup, occ, bits)
    assert (d["o1"] != d["o2"]).all()
    assert (d["o2"] == occ[:, -1]).all() and (d["o1"] == occ[:, -2]).all()
    assert d["valid"].any()
    new = bits.clone()
    rows = torch.arange(occ.shape[0])
    for name, on in (("o1", False), ("o2", False), ("u1", True), ("u2", True)):
        new[rows, d[name]] = on
    ok = d["valid"]
    assert (new[ok, :n].sum(1) == e // 2).all() and (new[ok, n:].sum(1) == e // 2).all()

    monkeypatch.setattr(compress, "sample_categorical_rows", capped)
    d = nu.sample_doubles_heat_bath(key, tens, n, e, symm, lookup, occ, bits)
    assert (d["o1"] == d["o2"]).all() and not d["valid"].any()


def test_the_fallback_counter_counts_under_the_profiler_alone():
    """``sampler.fallback`` counts the draws past every prefix that take a
    column other than K - 1 while a profiler records (not a row whose last
    column has weight, nor a row of zeros), and is not touched while none
    does."""
    probs = torch.cat([rows_below_total(5, 3, 6), rows_below_total(8, 0, 2, seed=2)])
    probs[-1] = 0.0
    u = torch.full((8,), U_PAST, dtype=F64)
    inside = torch.full((8,), 0.25, dtype=F64)
    profiling.reset("sampler.fallback")
    compress.sample_categorical_rows(FixedKey(u), probs)
    assert profiling.device_total("sampler.fallback") == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        compress.sample_categorical_rows(FixedKey(u), probs)
        compress.sample_categorical_rows(FixedKey(inside), probs)
        compress.sample_categorical_rows(FixedKey(u[:6]), probs[:6])
    assert profiling.device_total("sampler.fallback") == 6 + 6
    profiling.reset("sampler.fallback")
    assert profiling.device_total("sampler.fallback") == 0


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _cell():
    params = {"eps": 0.001, "target_walkers": 3500.0, "capacity": 8192, "attempt_cap": 8192,
              "spawn_cap": 4096, "init_thresh": 3.0, "shift_interval": 2,
              "shift_damping": 0.05}
    return {"params": params, "init_walkers": 3000.0}


def test_a_step_without_the_profiler_adds_no_operation(n2, monkeypatch):
    """With no profiler the counter adds no operation to an FCIQMC step (the
    same operations with ``device_count`` replaced by nothing), and the
    step reads on the host only where the CPU's plain merge counts its read
    (``merge.plain_new``; kernel A on the card reads nothing)."""
    ham = n2[0]
    cell = _cell()
    system = data.System(ham.hcore, ham.eris, ham.symm, ham.n_orb, ham.n_elec)
    traced = []
    for quiet in (False, True):
        if quiet:
            monkeypatch.setattr(profiling, "device_count", lambda *a, **k: None)
        prog = fciqmc_solver.Program(system, cell, SEED, "cpu")
        with _Ops() as rec:
            prog.advance(prog.state)
        traced.append(rec.ops)
    assert traced[0] == traced[1]
    reads = profiling.last_step_counts()
    assert set(reads) == {"merge.plain_new"}
    assert sum("_local_scalar_dense" in op for op in traced[0]) == reads["merge.plain_new"]


def test_the_step_follows_the_reference_on_n2(n2):
    """Eight integer HB i-FCIQMC steps on the configuration's system from a
    few thousand walkers on HF, each from the program's state with the same
    key tree: the same determinants, and values and estimators within
    1e-14; no row with a wrong electron count."""
    ham = n2[0]
    cell = _cell()
    system = data.System(ham.hcore, ham.eris, ham.symm, ham.n_orb, ham.n_elec)
    prog = fciqmc_solver.Program(system, cell, SEED, "cpu")
    ref = fciqmc_solver.Reference(system, cell, SEED, "cpu")
    state = prog.state
    assert check.vec_ks(ref.read(check.snapshot(state))[:2], ref.start()[:2]) == 0.0
    for _ in range(8):
        before = check.snapshot(state)
        state, metrics, u = prog.advance(state)
        r_cols, r_vals, r_metrics = ref.advance(ref.read(before), before["iterat"], u)
        cols, vals, shift, last = ref.read(check.snapshot(state))
        assert torch.equal(cols, r_cols)
        assert float((vals - r_vals).abs().max()) <= 1e-14 * float(r_vals.abs().max())
        prog_metrics = {**run._host(metrics), "shift": shift, "last_norm": last}
        assert check.estimator_gap(prog_metrics, r_metrics) < 1e-14
        assert ref.sys.n_bad(cols) == 0
    assert float(prog_metrics["norm"]) > 3500.0 and float(last) > 0   # the shift acted
