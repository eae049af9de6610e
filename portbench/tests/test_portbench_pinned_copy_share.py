"""The reader of ``pinned_copy_share.eval`` on hand-made counter snapshots:
it gives the share of host<->card bytes that crossed from or into
page-locked memory, and None on a port without the page-locked counters."""

from collections import Counter, defaultdict
from pathlib import Path

import pytest

from portbench import harness

FOLDER = Path(__file__).resolve().parents[1]


def reader(name):
    return harness.load_file(harness.reader_path(FOLDER, name), "m_" + name.replace(".", "_"))


def record():
    return {"workload": {}, "config": {}, "window_s": None, "counters": {},
            "spans": defaultdict(list), "trace": None}


def test_pinned_copy_share(monkeypatch):
    from mvtb_tpu_torch.utils import profiling

    # the eval cell's six volumes: all but the sliding window's importance
    # map and normalizer cross from or into page-locked memory
    img, lbl, grid = 142_848_000, 107_136_000, 39_906_304
    h2d, d2h = 6 * (img + lbl + grid) + 5 * img, 5 * img
    c = Counter({"copy.h2d_bytes": h2d, "copy.d2h_bytes": d2h,
                 "copy.h2d_pinned_bytes": h2d - 6 * grid, "copy.d2h_pinned_bytes": d2h})
    monkeypatch.setattr(profiling, "counters", c)
    share = reader("pinned_copy_share.eval").read(record())
    assert share == pytest.approx(100 * (1 - 6 * grid / (h2d + d2h)))
    assert 92.0 < share < 92.9
    c["copy.d2h_pinned_bytes"] = 0  # a pageable loader: the pool and labels alone
    c["copy.h2d_pinned_bytes"] = 6 * lbl + 6 * img
    assert reader("pinned_copy_share.eval").read(record()) == pytest.approx(
        100 * (6 * lbl + 6 * img) / (h2d + d2h))
    # a port that counts bytes but not page-locked ones, none at all, or
    # has no counters
    monkeypatch.setattr(profiling, "counters", Counter({"copy.h2d_bytes": h2d,
                                                        "copy.d2h_bytes": d2h}))
    assert reader("pinned_copy_share.eval").read(record()) is None
    monkeypatch.setattr(profiling, "counters", Counter())
    assert reader("pinned_copy_share.eval").read(record()) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader("pinned_copy_share.eval").read(record()) is None
