"""The traced stretch: ``torch.profiler`` over a bounded piece of steady
work, read back from its chrome trace into plain records that the metric
readers take.

A record of the device is ``{"name", "cat", "ts", "dur", "ops"}`` (times in
microseconds on the profiler's clock): a kernel, copy or fill, with
``ops`` the host operators that launched it, innermost first. The window
is the span of the ``portbench.window`` annotation around the stretch,
which ends with a synchronize, so every device record of the stretch lies
inside it.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def capture(work: Callable[[], None]) -> dict:
    """Run ``work`` under the profiler (CPU and CUDA activity) and return
    the normalised trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            work()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return normalise(events)


def normalise(events: List[dict]) -> dict:
    """``{"window": [t0, t1], "device": [...], "host": [...]}`` from chrome
    trace events; ``host`` holds the operators of the thread that ran the
    window, as ``{"name", "ts", "dur"}``."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError("the trace holds no window annotation")
    w = win[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    ops_by_tid: Dict[Tuple, List[dict]] = defaultdict(list)
    launches: Dict[int, Tuple] = {}
    runtime = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in ("cpu_op", "user_annotation"):
            ops_by_tid[(e.get("pid"), e.get("tid"))].append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append(e)
    # the operators enclosing each runtime call, by containment on its thread
    by_tid: Dict[Tuple, List[dict]] = defaultdict(list)
    for e in runtime:
        by_tid[(e.get("pid"), e.get("tid"))].append(e)
    for key, calls in by_tid.items():
        ops = sorted(ops_by_tid.get(key, []), key=lambda e: (float(e["ts"]), -float(e["dur"])))
        calls.sort(key=lambda e: float(e["ts"]))
        stack: List[dict] = []
        i = 0
        for c in calls:
            ts = float(c["ts"])
            while i < len(ops) and float(ops[i]["ts"]) <= ts:
                while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) <= float(ops[i]["ts"]):
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) < ts:
                stack.pop()
            corr = (c.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = tuple(o["name"] for o in reversed(stack))
    device = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur <= t0 or ts >= t1:
            continue
        corr = (e.get("args") or {}).get("correlation")
        device.append({"name": e.get("name", ""), "cat": e["cat"], "ts": ts, "dur": dur,
                       "ops": list(launches.get(corr, ()))})
    host = [{"name": e["name"], "ts": float(e["ts"]), "dur": float(e["dur"])}
            for e in ops_by_tid.get((w.get("pid"), w.get("tid")), [])
            if e is not w and t0 <= float(e["ts"]) <= t1]
    return {"window": [t0, t1], "device": device, "host": host}


def busy_intervals(trace: dict) -> List[Tuple[float, float]]:
    """The union of the device records' intervals, clipped to the window."""
    t0, t1 = trace["window"]
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in trace["device"])
    merged: List[List[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(trace: dict) -> float:
    return sum(b - a for a, b in busy_intervals(trace)) * 1e-6


def window_seconds(trace: dict) -> float:
    t0, t1 = trace["window"]
    return (t1 - t0) * 1e-6


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the host operator running at each gap's start (innermost)."""
    per_op: Dict[str, float] = defaultdict(float)
    for e in trace["device"]:
        per_op[e["name"][:160]] += e["dur"] * 1e-6
    t0, t1 = trace["window"]
    busy = busy_intervals(trace)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    host = sorted(trace["host"], key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    per_gap: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        name = _host_at(host, starts, a) or "host between operators"
        per_gap[name[:160]] += (b - a) * 1e-6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(per_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def _host_at(host: List[dict], starts: List[float], t: float) -> Optional[str]:
    """The innermost (latest-starting) host operator of ``host`` (sorted by
    start) still running at ``t``."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - 256):i]):
        if e["ts"] + e["dur"] >= t:
            return e["name"]
    return None
