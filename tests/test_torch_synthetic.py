"""The port's synthetic data (mvtb_tpu_torch/data/synthetic.py) against the
JAX package's, bit for bit (both are numpy ``RandomState`` only), and
``device_prefetch`` (mvtb_tpu_torch/data/prefetch.py)."""

import itertools

import numpy as np
import pytest
import torch

from mvtb_tpu.data import synthetic as jsyn
from mvtb_tpu_torch.data import device_prefetch
from mvtb_tpu_torch.data import synthetic as tsyn

SHAPES = [(16, 16, 8), (12, 10, 6)]


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n_classes", [1, 3])
@pytest.mark.parametrize("gen", ["make_volume", "make_textured_volume"])
def test_generators_are_bit_equal(seed, n_classes, gen):
    for spatial in SHAPES:
        ref = getattr(jsyn, gen)(np.random.RandomState(seed), 2, spatial, n_classes)
        got = getattr(tsyn, gen)(np.random.RandomState(seed), 2, spatial, n_classes)
        for a, b in zip(got, ref):
            _equal(a, b)


def test_textured_parts_and_bad_classes():
    a = tsyn.make_textured_volume(np.random.RandomState(3), 2, SHAPES[1], 3, return_parts=True)
    b = jsyn.make_textured_volume(np.random.RandomState(3), 2, SHAPES[1], 3, return_parts=True)
    _equal(a[0], b[0])
    for pa, pb in zip(a[2], b[2]):
        assert pa.keys() == pb.keys()
        for k in pa:
            _equal(pa[k], pb[k])
    for gen in (tsyn.make_volume, tsyn.make_textured_volume):
        with pytest.raises(ValueError, match="n_classes"):
            gen(np.random.RandomState(0), 1, SHAPES[1], 2)


@pytest.mark.parametrize("kind", ["smooth", "textured"])
@pytest.mark.parametrize("seed", [0, 5])
def test_batch_iterators_are_bit_equal(kind, seed, tmp_path, monkeypatch):
    for a, b in itertools.islice(zip(tsyn.batches(seed, 2, 2, SHAPES[1], 3, kind),
                                     jsyn.batches(seed, 2, 2, SHAPES[1], 3, kind)), 3):
        _equal(a[0], b[0])
        _equal(a[1], b[1])
    # cached_batches reads its pool through generate_pool's default cache
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    for a, b in itertools.islice(zip(
            tsyn.cached_batches(seed, 3, pool=4, channels=2, spatial=SHAPES[1], kind=kind),
            jsyn.cached_batches(seed, 3, pool=4, channels=2, spatial=SHAPES[1], kind=kind)), 4):
        _equal(a[0], b[0])
        _equal(a[1], b[1])
    assert (tmp_path / "mvtb_pools").is_dir()


@pytest.mark.parametrize("seed,n_classes", [(0, 3), (2, 1)])
def test_generate_pool_is_bit_equal_with_and_without_cache(seed, n_classes, tmp_path):
    ref = jsyn.generate_pool(seed, 3, 2, SHAPES[0], n_classes, "textured", cache_dir=None)
    fresh = tsyn.generate_pool(seed, 3, 2, SHAPES[0], n_classes, "textured", cache_dir=None)
    cache = tmp_path / "pools"
    written = tsyn.generate_pool(seed, 3, 2, SHAPES[0], n_classes, "textured",
                                 cache_dir=str(cache))
    files = list(cache.iterdir())
    assert len(files) == 1 and files[0].name.startswith(f"textured_s{seed}_n3_c2_16x16x8_k{n_classes}_g")
    loaded = tsyn.generate_pool(seed, 3, 2, SHAPES[0], n_classes, "textured",
                                cache_dir=str(cache))
    for got in (fresh, written, loaded):
        _equal(got[0], ref[0])
        _equal(got[1], ref[1])


def test_decathlon_dicts_and_brats_ids_are_bit_equal():
    a = tsyn.decathlon_style_dicts(4, 2, 4, SHAPES[1])
    b = jsyn.decathlon_style_dicts(4, 2, 4, SHAPES[1])
    for da, db in zip(a, b):
        _equal(da["image"], db["image"])
        _equal(da["label"], db["label"])
        _equal(tsyn.onehot_to_brats_ids(da["label"]), jsyn.onehot_to_brats_ids(db["label"]))


def _items(n):
    rng = np.random.RandomState(n)
    return [(rng.randn(2, 3).astype(np.float32),
             {"label": rng.rand(4).astype(np.float32),
              "extra": [np.int64(i), (torch.full((2,), float(i)),)]})
            for i in range(n)]


def _same(got, ref):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys()
        for k in ref:
            _same(got[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert type(got) is type(ref) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r)
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert torch.equal(got, torch.as_tensor(np.asarray(ref)))


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 2, 5])
def test_device_prefetch_yields_every_item_in_order(size, n):
    items = _items(n)
    pulled = []

    def source():
        for i, it in enumerate(items):
            pulled.append(i)
            yield it

    out = device_prefetch(source(), size=size, device="cpu")
    got = []
    for k, item in enumerate(out):
        # the ring holds `size` items ahead of the one handed out
        assert len(pulled) == min(n, k + 1 + size)
        got.append(item)
    assert len(got) == n
    for g, r in zip(got, items):
        _same(g, r)


def test_device_prefetch_rejects_an_empty_ring():
    with pytest.raises(ValueError, match="size"):
        next(device_prefetch(iter(_items(2)), size=0, device="cpu"))
