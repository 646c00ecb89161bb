"""Discovery by name and the shape of BENCHMARK.json."""

import json
import re

from benchmark import catalog
from benchmark.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_has_its_files():
    bench = catalog.benchmark()
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"])
        assert w["config"] in configs and cell.config["name"] == w["config"]
        catalog.solver(cell.params["solver"])
        assert cell.end_to_end and cell.per_layer
    for m in bench["per_layer"]:
        assert hasattr(catalog.metric(m["name"]), "read")
    assert set(catalog.names("configs")) == configs
    assert set(catalog.names("cells")) == {w["name"] for w in bench["workloads"]}
    assert set(catalog.names("metrics")) == {m["name"] for m in bench["per_layer"]}
    assert set(catalog.names("solvers")) == {"frisys", "fciqmc"}


def test_names_units_and_lines():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [x["name"] for x in bench["configs"] + bench["workloads"] + metrics]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip() and "\n" not in m["layer"]
    for w in bench["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)


def test_a_dropped_cell_is_found(tiny_root):
    cell = catalog.cell("tiny.fri", tiny_root)
    assert cell.params["solver"] == "frisys" and cell.config["n_orb"] == 10
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in catalog.cell("n2_ccpvdz_synth.fri_1m", tiny_root).per_layer]
    assert "tiny.fciqmc" in catalog.names("cells", tiny_root)
