"""A cell and a per-layer metric are added with new files alone: a
throwaway cell and metric, added in a copy of the benchmark in a temporary
directory, run without a change to any file that is there."""

import hashlib
import json
import shutil
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
FOLDER = ROOT / "portbench"


def digest():
    return {p.relative_to(ROOT).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(FOLDER.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    before = digest()
    shutil.copytree(FOLDER, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stylize.tiny", "config": "gibbs12p5_fast",
                               "traffic": "stylize.tiny", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "stylize_vol_per_s":
            m["workloads"].append("stylize.tiny")
    bench["per_layer"].append({"name": "batches.tiny", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "whole step",
                               "moves": "stylize_vol_per_s", "workloads": ["stylize.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "workloads" / "stylize.tiny.json").write_text(json.dumps({
        "config": "gibbs12p5_fast", "kind": "stylize", "why": "a test cell", "batch": 2,
        "spatial": [16, 16, 8], "pool": 3, "sync_every": 2, "check_within": 2,
        "check_batches": 1, "limits": {"stylize_gap": 0.05}}))
    (tmp_path / "portbench" / "metrics" / "batches.tiny.py").write_text(
        "def read(record):\n    return record['counters']['volumes'] / 2\n")

    r = harness.run_cell("stylize.tiny", 5, 0.2, True, device="cpu", root=tmp_path)
    assert r["correct"] and r["metrics"]["batches.tiny"]["value"] > 0
    r = harness.run_cell("stylize.tiny", 5, 0.2, False, device="cpu", root=tmp_path)
    assert set(r["metrics"]) == {"setup_s", "stylize_vol_per_s"}
    assert digest() == before
