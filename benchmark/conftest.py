"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with two
tiny configurations (keys of one word and of three) and three tiny cells."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

TINY_CONFIG = {"name": "tiny", "n_orb": 10, "n_elec": 6, "symm": [0, 1, 0, 1, 0, 1, 2, 3, 0, 5],
               "integrals": {"seed": 3, "scale_two": 0.1, "diag_spread": 3.0, "offdiag": 0.05}}
WIDE_CONFIG = {"name": "tiny_wide", "n_orb": 34, "n_elec": 4,
               "symm": [0, 5, 0, 5, 2, 3, 6, 7, 1, 4] * 3 + [0, 5, 2, 3],
               "integrals": {"seed": 4, "scale_two": 0.1, "diag_spread": 3.0,
                             "offdiag": 0.05}}
CHECK = {"limits": {"vec_ks": 1e-9, "est_gap": 1e-9, "bad_dets": 0}}   # no rounding moves at this size
TINY_CELLS = {
    "tiny.fri": {"solver": "frisys", "init_val": 100.0, "warmup_steps": 4,
                 "params": {"eps": 0.01, "vec_nonz": 300, "matr_samp": 800, "capacity": 4096,
                            "spawn_cap": 1200, "init_thresh": 1.0, "target_norm": 2000.0,
                            "shift_interval": 10, "shift_damping": 0.05},
                 "check": CHECK},
    "tiny.fciqmc": {"solver": "fciqmc", "init_walkers": 1000.0, "warmup_steps": 4,
                    "params": {"eps": 0.01, "target_walkers": 3000.0, "capacity": 4096,
                               "attempt_cap": 8192, "spawn_cap": 4096, "init_thresh": 3.0,
                               "shift_interval": 1, "shift_damping": 1.0},
                    "check": CHECK},
    "tiny_wide.fri": {"solver": "frisys", "init_val": 100.0, "warmup_steps": 3,
                      "params": {"eps": 0.01, "vec_nonz": 300, "matr_samp": 800,
                                 "capacity": 4096, "spawn_cap": 1200, "init_thresh": 1.0,
                                 "target_norm": 2000.0, "shift_interval": 10,
                                 "shift_damping": 0.05},
                      "check": CHECK},
}


def make_root(path: Path) -> Path:
    """A checkout at ``path`` with the benchmark's files, the tiny cells and
    their entries in ``BENCHMARK.json``."""
    shutil.copytree(REPO / "benchmark", path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for conf in (TINY_CONFIG, WIDE_CONFIG):
        file = f"benchmark/configs/{conf['name']}.json"
        (path / file).write_text(json.dumps(conf))
        bench["configs"].append({"name": conf["name"], "source": "a test", "reduced": [],
                                 "file": file, "why": "a test"})
    for name, cell in TINY_CELLS.items():
        (path / f"benchmark/cells/{name}.json").write_text(json.dumps(cell))
        bench["workloads"].append({"name": name, "config": name.split(".")[0], "chips": 1,
                                   "traffic": name.split(".", 1)[1], "why": "a test"})
        for m in bench["per_layer"]:   # a reader that finds nothing returns nothing
            m["workloads"].append(name)
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
