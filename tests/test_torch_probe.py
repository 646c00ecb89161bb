"""fries_tpu_torch.probe_reshape (kernel #6's plain version) against the
reference probe's ``direct`` body (tools/probe_reshape.py:44), run here
through ``pl.pallas_call`` in interpret mode: the (8, 128) int32 tile and
its (1024, 1) column, pos = r * 128 + lane, exactly.  Likewise the backend
probe's copy (kernel #5, ``fries_tpu_torch._build.probe_copy``) against the
body of ``pallas_merge.tpu_supported`` on its grid of two (8, 128) blocks."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from fries_tpu_torch import _build, profiling  # noqa: E402
from fries_tpu_torch import probe_reshape as probe_mod  # noqa: E402


def reference_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_reshape.py"
    spec = importlib.util.spec_from_file_location("probe_reshape_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def reference_direct(x):
    tool = reference_tool()
    assert (tool.RB, tool.TB) == (probe_mod.RB, probe_mod.TB)

    def kernel(x_ref, o_ref):
        o_ref[...] = tool.direct(x_ref[...])

    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((tool.TB, 1), jnp.int32),
                         interpret=True)(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("case", ["arange", "random"])
def test_reshape_plain_matches_pallas_direct(case):
    rng = np.random.default_rng(6)
    shape = (probe_mod.RB, probe_mod.LANES)
    x = (np.arange(probe_mod.TB, dtype=np.int32).reshape(shape) if case == "arange"
         else rng.integers(-2**31, 2**31 - 1, shape).astype(np.int32))
    ref = reference_direct(x)
    got = probe_mod.reshape(torch.as_tensor(x))
    assert got.shape == (probe_mod.TB, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "arange":   # the probe's own expected column (probe_reshape.py:37)
        np.testing.assert_array_equal(ref, np.arange(probe_mod.TB, dtype=np.int32)[:, None])


def test_probe_cli_on_cpu_takes_plain(capsys):
    before = profiling.total("launch.probe_reshape")
    assert probe_mod.main(["--device", "cpu"]) == 0
    assert "direct reshape (8,128)->(1024,1): OK" in capsys.readouterr().out
    assert profiling.total("launch.probe_reshape") == before


def reference_probe_copy(x):
    """The backend probe's body (fries_tpu/runtime/pallas_merge.py:74-82): a
    copy over a grid of two (8, 128) blocks, here in interpret mode."""
    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    f = pl.pallas_call(kernel, grid=(2,),
                       in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))],
                       out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
                       out_shape=jax.ShapeDtypeStruct((16, 128), jnp.float32), interpret=True)
    return np.asarray(f(jnp.asarray(x)))


@pytest.mark.parametrize("case", ["arange", "random"])
def test_probe_copy_plain_matches_pallas_probe(case):
    rng = np.random.default_rng(5)
    x = (np.arange(16 * 128, dtype=np.float32).reshape(_build.PROBE_SHAPE) if case == "arange"
         else rng.standard_normal(_build.PROBE_SHAPE).astype(np.float32))
    before = profiling.total("launch.probe_copy")
    got = _build.probe_copy(torch.as_tensor(x))
    assert profiling.total("launch.probe_copy") == before   # the CPU takes the plain version
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), reference_probe_copy(x))
