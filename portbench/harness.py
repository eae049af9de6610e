"""One run of one cell: find the cell's files by name, drive it, read its
metrics and judge its outputs.

Everything that belongs to one cell, configuration, kind of traffic or
per-layer metric sits in a file of its own under the benchmark's folder,
found by the name ``BENCHMARK.json`` gives it:

* ``workloads/<cell>.json``: the traffic, the config's name, the driver
  kind and the limits of the comparison that decides ``correct``;
* ``configs/<config>.json``: the configuration as it is run;
* ``drivers/<kind>.py``: ``run(ctx)`` drives one kind of traffic;
* ``metrics/<metric>.py``: ``read(record)`` returns one per-layer metric,
  or None where the run has nothing for it to read. A metric without a file
  of its own is read by the file of its base name, the part before the
  first dot (``mfu.py`` reads ``mfu.train`` and ``mfu.eval``).

So a later cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


class Run:
    """What a driver reads and fills in during one run of one cell."""

    def __init__(self, root: Path, cell: str, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float,
                 overrides: Optional[dict] = None):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        entry = [w for w in self.bench["workloads"] if w["name"] == cell]
        if not entry:
            raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
        self.entry = entry[0]
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace_on, self.device, self.t_start = trace, device, t_start
        self.folder = self.root / Path(self.bench["paths"][0])
        self.wl = json.loads((self.folder / "workloads" / f"{cell}.json").read_text())
        overrides = overrides or {}
        self.wl.update(overrides.get("workload", {}))
        self.cfg = json.loads((self.folder / "configs" / f"{self.wl['config']}.json").read_text())
        self.cfg.update(overrides.get("config", {}))
        self.e2e: Dict[str, float] = {}
        self.checks: Dict[str, List[float]] = {}
        self.attempted = 0
        self.failed = 0
        self.setup_s: Optional[float] = None
        self.setup_parts: Dict[str, float] = {}
        self._mark = t_start
        self.memory_peak_bytes = 0
        self.record = {"workload": self.wl, "config": self.cfg, "window_s": None,
                       "counters": {}, "spans": defaultdict(list), "trace": None}

    # -- timing ----------------------------------------------------------
    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def mark(self, part: str) -> None:
        """A part of set-up ends here: its seconds, after a synchronize,
        go to ``setup_parts``."""
        self.sync()
        now = time.perf_counter()
        self.setup_parts[part] = now - self._mark
        self._mark = now

    def setup_done(self, part: str = "warm") -> None:
        """Set-up ends here, with its last part: every shape the window
        uses has run once."""
        self.mark(part)
        self.setup_s = self._mark - self.t_start
        if self.device != "cpu":
            import torch
            torch.cuda.reset_peak_memory_stats()

    def window_done(self, seconds: float) -> None:
        self.record["window_s"] = seconds
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def traced(self, work: Callable[[], None]) -> None:
        """Profile ``work``, a bounded stretch of the cell's steady work."""
        from portbench import trace
        if self.device == "cpu":
            self.record["trace"] = {"window": [0.0, 1.0], "device": [], "host": []}
            work()
            return
        self.record["trace"] = trace.capture(work)

    # -- judging ---------------------------------------------------------
    def limit(self, name: str) -> float:
        return float(self.wl["limits"][name])

    def check(self, name: str, value: float) -> None:
        """A number compared with its limit; ``correct`` needs every one
        finite and within its limit."""
        self.checks[name] = [float(value), self.limit(name)]

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(folder: Path, name: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``, else the
    file of its base name."""
    own = Path(folder) / "metrics" / f"{name}.py"
    return own if own.is_file() else own.with_name(f"{name.split('.')[0]}.py")


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}

    def reports(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in names

    return e2e, [m for m in bench["per_layer"] if reports(m)]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, root: Path = HERE.parent,
             overrides: Optional[dict] = None) -> dict:
    """Run one cell once; returns the result line as a dict. ``overrides``
    (``{"workload": {...}, "config": {...}}``) replaces top-level keys of the
    cell's files, for runs at a test's size."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Run(root, cell, seed, seconds, trace, device, t_start, overrides)
    ctx.mark("start")  # the interpreter, torch's import, the device count
    if device != "cpu":
        import torch
        torch.empty(1, device=device)
        ctx.mark("cuda_context")
    driver = load_file(ctx.folder / "drivers" / f"{ctx.wl['kind']}.py",
                       f"portbench_driver_{ctx.wl['kind']}")
    driver.run(ctx)
    e2e, layer = cell_metrics(ctx.bench, cell)
    metrics = {}
    if not trace:
        values = dict(ctx.e2e, setup_s=ctx.setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in layer:
            reader = load_file(reader_path(ctx.folder, m["name"]),
                               f"portbench_metric_{m['name'].replace('.', '_')}")
            v = reader.read(ctx.record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "cpu" if device == "cpu" else "gpu", "kind": device_kind(device),
           "count": int(ctx.entry.get("chips", 1)), "memory_peak_bytes": ctx.memory_peak_bytes}
    result = {"correct": ctx.correct, "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": dev}
    if trace and ctx.record["trace"] is not None:
        from portbench import trace as tr
        dev["busy_s"] = tr.busy_seconds(ctx.record["trace"])
        dev["window_s"] = tr.window_seconds(ctx.record["trace"])
        result["breakdown"] = tr.breakdown(ctx.record["trace"])
    result["setup_parts"] = ctx.setup_parts
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in ctx.checks.items()}
    return result


def device_kind(device: str) -> str:
    if device == "cpu":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)
