"""Neither JAX nor the JAX package is loaded by the harness, and a run
without a card exits non-zero with no result."""

import os
import subprocess
import sys

from benchmark.conftest import REPO


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=600)


def test_no_jax_after_a_run(tiny_root):
    code = ("import sys; from pathlib import Path; from benchmark import run; "
            "run.run('tiny.fri', 5, 0.2, False, root=Path(sys.argv[1]), device='cpu', "
            "log=lambda *a: None); print(run.loaded_forbidden(), "
            "'fries_tpu_torch' in sys.modules)")
    out = _run(code, str(tiny_root))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[]", "True"]


def test_whole_names_are_compared():
    code = ("import sys, types; from benchmark import run; "
            "sys.modules['fries_tpu_torch_x'] = types.ModuleType('x'); a = run.loaded_forbidden(); "
            "sys.modules['jaxlib.xla'] = types.ModuleType('y'); print(a, run.loaded_forbidden())")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[] ['jaxlib']"


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "n2_ccpvdz_synth.fri_1m", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_the_reference_imports_nothing_of_the_program(tiny_root):
    """The reference builds and steps both kinds of cell with no module of
    the program, of JAX or of the JAX package loaded."""
    code = ("import sys\nfrom pathlib import Path\nfrom benchmark import catalog, data\n"
            "root = Path(sys.argv[1])\n"
            "for name, u in (('tiny.fri', [0.5] * 7), ('tiny.fciqmc', None)):\n"
            "    c = catalog.cell(name, root)\n"
            "    s = catalog.solver(c.params['solver'], root)\n"
            "    r = s.Reference(data.make_system(c.config, 'cpu'), c.params, 5, 'cpu')\n"
            "    r.advance(r.start(), 0, u)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'fries_tpu_torch', 'fries_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = _run(code, str(tiny_root))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
