"""BENCHMARK.json against the rules its format keeps, and the imports of
every module under portbench/."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench.harness import reader_path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FOLDER = ROOT / BENCH["paths"][0]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert 1 <= len(BENCH["workloads"]) <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_setup_metric_and_its_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


def test_every_config_has_a_cell_and_a_file():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        f = ROOT / c["file"]
        assert f.is_file() and f.parts[len(ROOT.parts)] == BENCH["paths"][0]
        assert json.loads(f.read_text())["name"] == c["name"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        wl = json.loads((FOLDER / "workloads" / f"{w['traffic']}.json").read_text())
        assert wl["config"] == w["config"]
        assert (FOLDER / "drivers" / f"{wl['kind']}.py").is_file()
        assert wl["limits"]


def test_metrics_name_existing_cells_that_report_what_they_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        listed = set(m.get("workloads", e2e[m["moves"]]))
        assert listed and listed <= cells and listed <= e2e[m["moves"]]
        assert reader_path(FOLDER, m["name"]).is_file()


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    from portbench.harness import cell_metrics

    for w in BENCH["workloads"]:
        e2e, layer = cell_metrics(BENCH, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer


def test_rooflines_and_mfu_move_together():
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
            mfu = [x for x in BENCH["per_layer"] if "mfu" in x["name"] and x["moves"] == m["moves"]]
            assert mfu


def test_file_names_under_paths():
    for p in FOLDER.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


MODULES = sorted(p for p in FOLDER.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(FOLDER).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not set(imported_tops(path)) & {"jax", "jaxlib", "flax", "mvtb_tpu", "bench",
                                            "benchmarks"}


@pytest.mark.parametrize("path", sorted((FOLDER / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mvtb_tpu_torch" not in set(imported_tops(path))
