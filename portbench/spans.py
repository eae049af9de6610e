"""The port's own spans and counters, read back for the per-layer metrics.

The port names its layers with spans (``mvtb_tpu_torch/utils/profiling.py``:
``span``), ``record_function`` ranges that the traced stretch records on the
profiler's clock. So they stand in the normalised trace (``portbench/
trace.py``) twice: as host operators of the window's thread (``host``), and
in the ``ops`` chain of every kernel, copy and fill launched inside them.
Its counters are the process's ``profiling.counters``, cumulative since the
process began. A program without them finds nothing here, and its readers
report nothing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.trace import busy_intervals

PREFIX = "mvtb."


def named(trace: Optional[dict], name: str) -> List[dict]:
    """The host spans called ``name`` in the traced window."""
    if not trace:
        return []
    return [e for e in trace["host"] if e["name"] == name]


def count(trace: Optional[dict], name: str) -> int:
    return len(named(trace, name))


def host_ms(trace: Optional[dict], *names: str) -> float:
    """Host milliseconds in the spans called any of ``names``."""
    return 1e-3 * sum(e["dur"] for n in names for e in named(trace, n))


def under(trace: Optional[dict], name: str, cats=None) -> List[dict]:
    """The device records launched inside a span called ``name``, of the
    categories ``cats`` (every one when None)."""
    if not trace:
        return []
    return [e for e in trace["device"]
            if name in e["ops"] and (cats is None or e["cat"] in cats)]


def device_ms_under(trace: Optional[dict], name: str) -> float:
    return 1e-3 * sum(e["dur"] for e in under(trace, name))


def volumes(trace: Optional[dict]) -> int:
    """The traced volumes: ``mvtb.eval.volume`` spans that hold a
    ``mvtb.eval.dice`` span. The harness's last ``next()`` of a loader,
    which finds it empty, opens a volume span too, with no Dice in it."""
    dice = sorted(e["ts"] for e in named(trace, "mvtb.eval.dice"))
    n = 0
    for v in named(trace, "mvtb.eval.volume"):
        i = bisect.bisect_left(dice, v["ts"])
        n += i < len(dice) and dice[i] <= v["ts"] + v["dur"]
    return n


def program_counters() -> Dict[str, int]:
    """A copy of the port's counters; empty where the port has none."""
    try:
        from mvtb_tpu_torch.utils import profiling
    except ImportError:
        return {}
    return dict(getattr(profiling, "counters", {}))


def segments(trace: dict, prefix: str = PREFIX) -> List[Tuple[float, float, Optional[str]]]:
    """The window cut where a span starts or ends, as ``(start, end,
    name)``: the innermost span over the piece whose name starts with
    ``prefix``, or None. Spans of one thread nest, so a stack of the open
    ones gives the innermost."""
    t0, t1 = trace["window"]
    spans = sorted((e for e in trace["host"] if e["name"].startswith(prefix)),
                   key=lambda e: (e["ts"], -e["dur"]))
    out: List[Tuple[float, float, Optional[str]]] = []
    stack: List[dict] = []
    at = t0

    def upto(t: float) -> None:
        nonlocal at
        t = min(t, t1)
        if t > at:
            out.append((at, t, stack[-1]["name"] if stack else None))
            at = t

    for e in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            upto(stack[-1]["ts"] + stack[-1]["dur"])
            stack.pop()
        upto(e["ts"])
        stack.append(e)
    while stack:
        upto(stack[-1]["ts"] + stack[-1]["dur"])
        stack.pop()
    upto(t1)
    return out


def idle_by_span(trace: dict, prefix: str = PREFIX) -> Dict[str, float]:
    """Seconds the device idles in the window, split by the innermost span
    (named ``prefix``...; None: none) the host is in meanwhile, each gap
    weighted by time."""
    t0, t1 = trace["window"]
    gaps, prev = [], t0
    for a, b in busy_intervals(trace):
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        gaps.append((prev, t1))
    idle: Dict[Optional[str], float] = defaultdict(float)
    segs = segments(trace, prefix)
    i = 0
    for a, b in gaps:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s, e, name = segs[j]
            idle[name] += (min(b, e) - max(a, s)) * 1e-6
            j += 1
    return dict(idle)
