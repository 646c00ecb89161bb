"""The port's native reader (fries_tpu_torch.native, its own copy of the C++
source, built with g++ into build/fries_tpu_torch/) against its Python paths
and against fries_tpu.io on the same files: an FCIDUMP written by
``io.write_fcidump`` (and one with malformed lines), determinant files (masks
of one and two words, and wider ones, which stay on the Python path) and
value files, equal bit for bit; and the switch: ``native=False`` and
``FRIES_NATIVE=0`` take the Python path, ``native=True`` raises when the
library is absent.  Modelled on tests/test_native_io.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fries_tpu import io as jio  # noqa: E402
from fries_tpu_torch import io as tio, native, synth  # noqa: E402


@pytest.fixture(scope="module")
def nlib():
    so, why = native.lib()
    if so is None:
        pytest.skip(f"native library unavailable ({why})")
    return so


def assert_same_ham(a, b):
    for k in ("hcore", "eris", "symm"):
        np.testing.assert_array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k)))
    assert (a.n_orb, a.n_elec) == (b.n_orb, b.n_elec)


def test_library_builds_into_build_dir(nlib):
    so = native.build()
    assert so.parent == native._build.BUILD_DIR and so.exists()
    assert so.parent != native.SRC.parent


def test_fcidump_native_matches_python_and_reference(tmp_path, nlib):
    ham = synth.make_system(6, 4, symm=np.array([0, 1, 2, 3, 0, 1]), seed=3)
    path = tmp_path / "FCIDUMP"
    tio.write_fcidump(ham, path, point_group="d2", core_energy=-7.25)
    before = dict(tio.READS)
    ham_n, core_n = tio.parse_fcidump(path, "d2", native=True)
    ham_p, core_p = tio.parse_fcidump(path, "d2", native=False)
    assert tio.READS["native"] == before["native"] + 1
    assert tio.READS["python"] == before["python"] + 1
    ham_r, core_r = jio.parse_fcidump(path, "d2", native=False)
    assert core_n == core_p == core_r == -7.25
    assert_same_ham(ham_n, ham_p)
    assert_same_ham(ham_n, ham_r)


def test_fcidump_native_skips_malformed_lines(tmp_path, nlib):
    path = tmp_path / "FCIDUMP"
    path.write_text("&FCI NORB=2, NELEC=2, MS2=0,\n ORBSYM=1,1\n&END\n"
                    "  0.5 1 1 1 1\n"
                    "this line is not a record\n"
                    "  0.25 1 2 1 2\n"
                    "  1.0 1 1 0 0\n"
                    "  0.125 1 1 1 1 7\n"      # six fields: skipped
                    "  -3.5 0 0 0 0\n")
    ham_n, core_n = tio.parse_fcidump(path, "c1", native=True)
    ham_r, core_r = jio.parse_fcidump(path, "c1", native=True)
    assert core_n == core_r == -3.5
    assert_same_ham(ham_n, ham_r)
    assert float(ham_n.hcore[0, 0]) == 1.0 and float(ham_n.eris[0, 0, 0, 0]) == 0.5


@pytest.mark.parametrize("n_bits", [20, 64, 108])
def test_vector_files_native_matches_python(tmp_path, nlib, n_bits):
    """Masks of one and two words through the u64 parse; 108 bits (four
    words) on the Python path whatever the switch."""
    rng = np.random.default_rng(n_bits)
    n_words = -(-n_bits // 32)
    keys = rng.integers(0, 2**32, size=(41, n_words), dtype=np.uint64).astype(np.uint32)
    keys[:, -1] &= np.uint32((1 << (n_bits - 32 * (n_words - 1))) - 1)
    keys[0] = 0
    vals = rng.standard_normal(41)
    vals[1] = -0.0
    prefix = tmp_path / "vec"
    tio.save_vec_txt(prefix, keys, vals, n_bits)
    k_n, v_n = tio.load_vec_txt(prefix, n_bits, native=True)
    k_p, v_p = tio.load_vec_txt(prefix, n_bits, native=False)
    k_r, v_r = jio.load_vec_txt(prefix, n_bits)
    for k in (k_n, k_p, k_r):
        np.testing.assert_array_equal(k, keys)
        assert k.dtype == np.uint32
    for v in (v_n, v_p, v_r):
        np.testing.assert_array_equal(v.view(np.int64), vals.view(np.int64))
    np.testing.assert_array_equal(tio.read_dets(str(prefix) + "dets", n_bits, native=True),
                                  jio.read_dets(str(prefix) + "dets", n_bits))


def test_load_rdm_native(tmp_path, nlib):
    path = tmp_path / "rdm.txt"
    data = np.linspace(-2.0, 2.0, 101)
    path.write_text(" ".join(repr(float(x)) for x in data))
    np.testing.assert_array_equal(tio.load_rdm(path, native=True), data)
    np.testing.assert_array_equal(tio.load_rdm(path, native=False), jio.load_rdm(path))


def test_switch(tmp_path, monkeypatch, nlib):
    """FRIES_NATIVE=0 takes the Python path under native=None; native=True
    then raises, as it does when the library is absent."""
    path = tmp_path / "vals"
    path.write_text("1.5\n-2.25\n")
    monkeypatch.setenv("FRIES_NATIVE", "0")
    native.lib.cache_clear()
    try:
        before = tio.READS["python"]
        np.testing.assert_array_equal(tio.load_rdm(path), [1.5, -2.25])
        assert tio.READS["python"] == before + 1
        with pytest.raises(RuntimeError, match="FRIES_NATIVE=0"):
            tio.load_rdm(path, native=True)
    finally:
        monkeypatch.delenv("FRIES_NATIVE")
        native.lib.cache_clear()
    monkeypatch.setattr(native, "lib", lambda: (None, "no g++"))
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        tio.load_rdm(path, native=True)
    before = tio.READS["python"]
    np.testing.assert_array_equal(tio.load_rdm(path), [1.5, -2.25])
    assert tio.READS["python"] == before + 1
