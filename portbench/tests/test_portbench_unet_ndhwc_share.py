"""The reader of ``unet_ndhwc_conv_share.train`` on hand-made counter
snapshots: the share of the UNet's convolution calls that ran
channels-last, and None on a port that counts no UNet convolutions."""

from collections import Counter, defaultdict
from pathlib import Path

import pytest

from portbench import harness

FOLDER = Path(__file__).resolve().parents[1]
NAME = "unet_ndhwc_conv_share.train"


def read():
    rec = {"workload": {}, "config": {}, "window_s": None, "counters": {},
           "spans": defaultdict(list), "trace": None}
    return harness.load_file(harness.reader_path(FOLDER, NAME), "m_unet_ndhwc").read(rec)


def test_unet_ndhwc_conv_share(monkeypatch):
    from mvtb_tpu_torch.utils import profiling

    # a b16 chunk on the card: every one of the 23 convolutions a forward
    # channels-last
    c = Counter({"unet.convs": 23 * 8, "unet.convs_ndhwc": 23 * 8})
    monkeypatch.setattr(profiling, "counters", c)
    assert read() == 100.0
    c["unet.convs"] += 23  # a float32 forward beside them, channels-first
    assert read() == pytest.approx(100.0 * 8 / 9)
    del c["unet.convs_ndhwc"]  # the CPU: none channels-last
    assert read() == 0.0
    # a port that counts no UNet convolutions, or has no counters
    monkeypatch.setattr(profiling, "counters", Counter({"sw.tiles": 27}))
    assert read() is None
    monkeypatch.setattr(profiling, "counters", Counter())
    assert read() is None
    monkeypatch.delattr(profiling, "counters")
    assert read() is None
