"""The port's coverage manifest (mvtb_tpu_torch/experiments/manifest.py)
against the JAX package's: the same reference scripts, every registry value
resolving in the port's registry, and every library value naming a module
of the port that imports, or a ROADMAP item."""

import importlib
import re
from pathlib import Path

import pytest

from mvtb_tpu.experiments import manifest as jmanifest
from mvtb_tpu_torch.experiments import manifest as tmanifest
from mvtb_tpu_torch.experiments import registry as treg

ROOT = Path(__file__).resolve().parent.parent
ROADMAP_ITEM = re.compile(r"^ROADMAP\.md section (\d+), item (\d+)$")


def test_script_map_is_the_jax_package_s():
    assert tmanifest.SCRIPT_MAP == jmanifest.SCRIPT_MAP
    assert tmanifest.LIBRARY_MAP.keys() == jmanifest.LIBRARY_MAP.keys()


def test_every_script_resolves_in_the_port_registry():
    assert len(tmanifest.SCRIPT_MAP) >= 130
    missing = {s: n for s, n in tmanifest.SCRIPT_MAP.items() if n not in treg.REGISTRY}
    assert not missing


@pytest.mark.parametrize("script", sorted(tmanifest.LIBRARY_MAP))
def test_library_values_import_or_name_a_roadmap_item(script):
    value = tmanifest.LIBRARY_MAP[script]
    m = ROADMAP_ITEM.match(value)
    if m:
        # an open item of the ROADMAP's module queue
        text = (ROOT / "ROADMAP.md").read_text()
        assert f"\n{m.group(2)}. **" in text, value
        return
    assert value.split(".")[0] == "mvtb_tpu_torch", value
    importlib.import_module(value)
    # the counterpart of the JAX package's module of the same path
    assert value.replace("mvtb_tpu_torch", "mvtb_tpu", 1) == jmanifest.LIBRARY_MAP[script]
