"""The data modules of the port (mvtb_tpu_torch/data, mvtb_tpu_torch/native)
against the JAX package's: preprocessing transforms and pipelines at the
same seeds, the native resampler and NIfTI reader against their Python
paths, the Decathlon dataset, the sweep, the slice transforms, the tree
builders, the hospital domains and the stylized loader. Host numpy
throughout, so equal seeds give equal arrays: bit for bit unless a
tolerance is stated."""

import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from mvtb_tpu import data as jdata
from mvtb_tpu.data import nifti as jnifti
from mvtb_tpu.data import preprocess as jpre
from mvtb_tpu.data import synthetic as jsyn
from mvtb_tpu.data import tcga as jtcga
from mvtb_tpu.ops.fused import StylizeConfig as JStylizeConfig
from mvtb_tpu_torch import data as tdata
from mvtb_tpu_torch import native
from mvtb_tpu_torch.data import nifti as tnifti
from mvtb_tpu_torch.data import preprocess as tpre
from mvtb_tpu_torch.data import synthetic as tsyn
from mvtb_tpu_torch.data import tcga as ttcga
from mvtb_tpu_torch.ops.fused import StylizeConfig

# an oblique-free affine with non-unit spacing and a flipped first axis, so
# Spacingd resamples and Orientationd flips
AFFINE = np.array([[-1.2, 0, 0, 30.0], [0, 1.0, 0, -4.0], [0, 0, 2.5, 7.0], [0, 0, 0, 1]])


def _raw_brats(seed, spatial=(20, 18, 10)):
    rng = np.random.RandomState(seed)
    img, lbl = jsyn.make_volume(rng, 4, spatial, 3)
    return {"image": np.moveaxis(img, 0, -1), "label": jsyn.onehot_to_brats_ids(lbl),
            "affine": AFFINE}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("which", ["brats_train", "brats_val"])
def test_brats_pipelines_match_jax(which):
    roi = (12, 12, 8)
    tp = getattr(tdata, f"{which}_pipeline")(roi_size=roi)
    jp = getattr(jdata, f"{which}_pipeline")(roi_size=roi)
    for seed in (0, 3):
        tp.set_random_state(seed)
        jp.set_random_state(seed)
        for i in range(3):
            raw = _raw_brats(10 * seed + i)
            got, ref = tp(dict(raw)), jp(dict(raw))
            assert got["image"].shape == (4,) + roi and got["label"].shape == (3,) + roi
            _equal(got, ref)


@pytest.mark.parametrize("which", ["tcga_train", "tcga_val"])
def test_tcga_pipelines_match_jax(which):
    roi = (12, 12, 8)
    tp = getattr(ttcga, f"{which}_pipeline")(roi_size=roi)
    jp = getattr(jtcga, f"{which}_pipeline")(roi_size=roi)
    tp.set_random_state(5)
    jp.set_random_state(5)
    for i in range(3):
        raw = _raw_brats(i)
        raw = {"image": raw["image"][..., 0], "label": raw["label"], "affine": AFFINE}
        _equal(tp(dict(raw)), jp(dict(raw)))


def test_geometry_helpers_match_jax():
    for aff in (AFFINE, np.diag([1.0, 1.0, 1.0, 1.0]), np.diag([-2.0, 1.5, -1.0, 1.0])):
        np.testing.assert_array_equal(tpre.zoom_affine(aff, (1.5, 1.5, 2.0)),
                                      jpre.zoom_affine(aff, (1.5, 1.5, 2.0)))
        for shape in [(11, 9, 7), (240, 240, 155)]:
            ts, to = tpre.compute_shape_offset(shape, aff, tpre.zoom_affine(aff, (1.5, 1.5, 2)))
            js, jo = jpre.compute_shape_offset(shape, aff, jpre.zoom_affine(aff, (1.5, 1.5, 2)))
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(to, jo)
        assert tpre.orientation_from_affine(aff) == jpre.orientation_from_affine(aff)
        vol = np.random.RandomState(1).randn(2, 5, 4, 3).astype(np.float32)
        for a, b in zip(tpre.reorient(vol, aff), jpre.reorient(vol, aff)):
            np.testing.assert_array_equal(a, b)
    # MONAI's corner rule: n=11 at 1.0 -> 4.0 mm gives 4, not 3
    shape, _ = tpre.compute_shape_offset((11, 11, 11), np.eye(4),
                                         tpre.zoom_affine(np.eye(4), (4.0, 4.0, 4.0)))
    assert list(shape) == [4, 4, 4]


def test_crops_and_normalization_match_jax():
    rng = np.random.RandomState(2)
    vol = rng.randn(3, 14, 9, 6).astype(np.float32)
    vol[:, :3] = 0.0
    for roi in [(8, 8, 4), (16, 12, 8), (14, 9, 6)]:
        np.testing.assert_array_equal(tpre.center_crop(vol, roi), jpre.center_crop(vol, roi))
        np.testing.assert_array_equal(tpre.rand_crop(vol, roi, np.random.RandomState(4)),
                                      jpre.rand_crop(vol, roi, np.random.RandomState(4)))
    for cw in (True, False):
        np.testing.assert_array_equal(tpre.normalize_nonzero(vol, cw),
                                      jpre.normalize_nonzero(vol, cw))
    out = tpre.normalize_nonzero(vol)
    assert (out[:, :3] == 0).all()


def test_dict_transforms_take_tensors():
    vol = np.random.RandomState(3).randn(2, 6, 5, 4).astype(np.float32)
    d = {"image": torch.from_numpy(vol)}
    out = tpre.CenterSpatialCropd("image", (4, 4, 4))(d)
    assert isinstance(out["image"], np.ndarray)
    np.testing.assert_array_equal(out["image"], jpre.center_crop(vol, (4, 4, 4)))


@pytest.mark.parametrize("order", [0, 1])
def test_native_resampler_matches_scipy(monkeypatch, order):
    """The port's native resampler is bit-equal to the JAX package's (the
    same C++) and to scipy for nearest; for trilinear it sits within the
    JAX package's own 1e-6 of scipy (tests/test_native.py): both interpolate
    in float64, in another order (measured: 1 ulp, 4 of 6916 elements)."""
    assert native.available()
    vol = np.random.RandomState(order).randn(2, 23, 19, 11).astype(np.float32)
    mode = "bilinear" if order else "nearest"
    nat, aff = tpre.resample_to_spacing(vol, AFFINE, (1.5, 1.5, 2.0), mode)
    ref, _ = jpre.resample_to_spacing(vol, AFFINE, (1.5, 1.5, 2.0), mode)
    np.testing.assert_array_equal(nat, ref)
    monkeypatch.setattr(native, "resample3d", lambda *a, **k: None)
    py, aff_py = tpre.resample_to_spacing(vol, AFFINE, (1.5, 1.5, 2.0), mode)
    if order == 0:
        np.testing.assert_array_equal(nat, py)
    else:
        np.testing.assert_allclose(nat, py, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(aff, aff_py)


def test_native_library_builds_into_build_dir():
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR
    assert path.parts[-4:-1] == ("build", "mvtb_tpu_torch", "native")
    assert native.available() and path.is_file()
    for src in native.SRCS:
        assert src.parent.name == "native" and src.is_file()


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
def test_nifti_round_trips_native_and_python(tmp_path, ext):
    rng = np.random.RandomState(4)
    for data in (rng.randn(7, 5, 3).astype(np.float32),
                 rng.randint(-300, 300, (6, 4, 3, 2)).astype(np.int16)):
        path = str(tmp_path / f"v{data.dtype.name}{ext}")
        tnifti.write_nifti(path, data, AFFINE)
        py, aff = tnifti.read_nifti(path, prefer_native=False)
        assert py.dtype == data.dtype
        np.testing.assert_array_equal(py, data)
        np.testing.assert_allclose(aff, AFFINE, rtol=0, atol=1e-6)
        nat, aff_n = tnifti.read_nifti(path)
        assert nat.dtype == np.float32
        np.testing.assert_array_equal(nat, data.astype(np.float32))
        np.testing.assert_array_equal(aff_n, aff)
        # the JAX package reads the port's file alike, and writes the same bytes
        np.testing.assert_array_equal(jnifti.read_nifti(path, prefer_native=False)[0], data)
        jpath = str(tmp_path / f"j{data.dtype.name}{ext}")
        jnifti.write_nifti(jpath, data, AFFINE)
        if ext == ".nii":
            assert filecmp.cmp(path, jpath, shallow=False)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    # n = 10: MONAI's split keeps int(0.2 n) = 2 for validation and the
    # sweep's half split 1 of them
    kw = dict(n=10, channels=4, spatial=(20, 18, 10), kind="smooth", seed=3, affine=AFFINE)
    out = {}
    for side, syn in (("port", tsyn), ("jax", jsyn)):
        out[side] = str(root / side)
        syn.build_decathlon_tree(out[side], **kw)
        syn.build_tcga_tree(str(root / f"{side}_tcga"), n_per_modality=2,
                            spatial=(12, 10, 8), seed=1, affine=AFFINE)
    return root, out


def test_tree_builders_write_the_jax_package_s_arrays(trees):
    root, out = trees
    task = "Task01_BrainTumour"
    for sub in ("imagesTr", "labelsTr"):
        names = sorted(os.listdir(os.path.join(out["port"], task, sub)))
        assert names == sorted(os.listdir(os.path.join(out["jax"], task, sub)))
        assert len(names) == 10
        for n in names:
            a, _ = tnifti.read_nifti(os.path.join(out["port"], task, sub, n), prefer_native=False)
            b, _ = jnifti.read_nifti(os.path.join(out["jax"], task, sub, n), prefer_native=False)
            np.testing.assert_array_equal(a, b)
    for modality in ("FLAIR", "T1", "T1Gd", "T2"):
        for n in sorted(os.listdir(root / "port_tcga" / modality / "imagesTr")):
            a, _ = tnifti.read_nifti(str(root / "port_tcga" / modality / "imagesTr" / n))
            b, _ = jnifti.read_nifti(str(root / "jax_tcga" / modality / "imagesTr" / n))
            np.testing.assert_array_equal(a, b)
    assert os.path.isfile(root / "port_tcga" / "train_sequence_by_modality.json")
    manifests = [str(root / side / "train_sequence_by_modality.json")
                 for side in ("port_tcga", "jax_tcga")]
    for a, b in zip(*(nif.tcga_manifest_datasets([m], partition=0.5, seed=2)
                      for nif, m in zip((tnifti, jnifti), manifests))):
        for sa, sb in zip(a, b):
            assert [os.path.basename(e["image"]) for e in sa] == \
                [os.path.basename(e["image"]) for e in sb]


def test_decathlon_splits_and_cache_match_jax(trees, tmp_path):
    _, out = trees
    for section in ("training", "validation"):
        t = tnifti.DecathlonDataset(out["port"], section=section)
        j = jnifti.DecathlonDataset(out["jax"], section=section)
        assert t.entries == j.entries
    assert len(tnifti.DecathlonDataset(out["port"], section="validation")) == 2
    pipe = tdata.brats_val_pipeline(roi_size=(12, 12, 8))
    ds = tnifti.DecathlonDataset(out["port"], transform=pipe, section="training",
                                 cache_dir=str(tmp_path / "cache"))
    first = ds[0]
    assert sorted(os.listdir(tmp_path / "cache")) == [
        os.path.basename(ds.entries[0]["image"]).split(".")[0] + ".npz"]
    _equal(ds[0], first)  # served from the cache
    jds = jnifti.DecathlonDataset(out["jax"], transform=jdata.brats_val_pipeline(
        roi_size=(12, 12, 8)), section="training")
    _equal(first, jds[0])
    with pytest.raises(ValueError):
        tnifti.DecathlonDataset(out["port"], section="test")


def test_reference_val_split_matches_jax():
    for n, split in ((96, (48, 48)), (7, (4, 3))):
        assert tnifti.reference_val_split(n, split) == jnifti.reference_val_split(n, split)


def test_brats_val_iter_dataset_matches_jax(trees):
    _, out = trees
    from mvtb_tpu.data.brats_sweep import BratsValIterDataset as J
    from mvtb_tpu_torch.data.brats_sweep import BratsValIterDataset as T
    from mvtb_tpu.transforms import RandFourierDiskMaskd as JDisk
    from mvtb_tpu_torch.transforms import RandFourierDiskMaskd as TDisk

    kw = dict(roi_size=(12, 12, 8))
    t = T(out["port"], transforms={"clean": None,
                                   "disk": TDisk("image", r=3.0, prob=1.0, device="cpu")},
          return_loader=True, **kw)
    j = J(out["jax"], transforms={"clean": None, "disk": JDisk("image", r=3.0, prob=1.0)},
          return_loader=True, **kw)
    assert [n for n, _ in t] == ["clean", "disk"]
    for (tn, tl), (jn, jl) in zip(t, j):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == 1
        np.testing.assert_array_equal(tb[0]["label"], jb[0]["label"])
        np.testing.assert_allclose(tb[0]["image"], jb[0]["image"], rtol=0,
                                   atol=0 if tn == "clean" else 1e-5)
    ds = T(out["port"], transforms={"clean": None}, **kw)["clean"]
    assert len(ds) == 1 and ds[0]["image"].shape == (4, 12, 12, 8)


def test_slices_match_jax():
    from mvtb_tpu.data.slices import RandConcatd as JRC, Sliced as JS
    from mvtb_tpu_torch.data.slices import RandConcatd as TRC, Sliced as TS

    vol = np.random.RandomState(6).randn(2, 8, 6, 40).astype(np.float32)
    for T, J in ((TS, JS), (TRC, JRC)):
        t, j = T(keys="image", seed=9), J(keys="image", seed=9)
        for _ in range(4):
            a, b = t({"image": vol}), j({"image": vol})
            np.testing.assert_array_equal(a["image"], b["image"])
    assert TRC(keys="image", seed=0)({"image": torch.from_numpy(vol)})["image"].shape == (2, 8, 6)


@pytest.mark.parametrize("kind", ["smooth", "textured"])
def test_domain_loaders_are_bit_equal_to_jax(kind):
    kw = dict(batch_size=2, n_per_hospital=4, seed=5, spatial=(16, 16, 8), kind=kind)
    tt, tv = ttcga.domain_loaders(**kw)
    jt, jv = jtcga.domain_loaders(**kw)
    assert list(tv) == list(jv) == ["hospital_A", "hospital_B", "hospital_C", "holdout"]
    for epoch in range(2):  # the shuffle is RandomState(seed), one draw per pass
        for a, b in zip(tt, jt):
            _equal(a, b)
    for name in tv:
        assert len(tv[name]) == len(jv[name])
        for a, b in zip(tv[name], jv[name]):
            _equal(a, b)
    for h in ("hospital_B", "holdout"):
        for a, b in zip(ttcga.textured_hospital_samples(h, 2, 7, (16, 16, 8)),
                        jtcga.textured_hospital_samples(h, 2, 7, (16, 16, 8))):
            _equal(a, b)


def test_partition_and_generalization_gap_match_jax():
    seq = list(range(11))
    assert ttcga.partition_dataset(seq, (0.75, 0.25), seed=3) == \
        jtcga.partition_dataset(seq, (0.75, 0.25), seed=3)
    ev = {"hospital_A": 0.8, "hospital_B": 0.7, "hospital_C": 0.6, "holdout": 0.5}
    assert ttcga.generalization_gap(ev) == jtcga.generalization_gap(ev)
    assert ttcga.generalization_gap(ev)["gap"] == pytest.approx(0.2)


def test_stylized_loader_matches_jax():
    kw = dict(batch_size=2, n_per_hospital=4, seed=1, spatial=(16, 16, 8))
    _, tv = ttcga.domain_loaders(**kw)
    _, jv = jtcga.domain_loaders(**kw)
    sty = dict(disk_r=4.0, disk_prob=1.0)  # deterministic: no draw
    t = tdata.StylizedLoader(tv["holdout"], StylizeConfig(**sty), seed=3, device="cpu")
    j = jdata.StylizedLoader(jv["holdout"], JStylizeConfig(**sty), seed=3)
    assert len(t) == len(j) == 1
    for a, b in zip(t, j):
        assert isinstance(a["image"], np.ndarray) and a["image"].shape == b["image"].shape
        np.testing.assert_array_equal(a["label"], b["label"])
        # float32 FFT round trips in two libraries (measured <= 9.6e-7 over the
        # four loaders)
        np.testing.assert_allclose(a["image"], np.asarray(b["image"]), rtol=0, atol=1e-5)
        assert not np.allclose(a["image"], next(iter(tv["holdout"]))["image"])
    # a random stylize draws per batch from one generator seeded ``seed``
    rnd = StylizeConfig(disk_r=(2.0, 6.0), disk_prob=1.0)
    runs = [[b["image"] for b in tdata.StylizedLoader(tv["holdout"], rnd, seed=s,
                                                      device="cpu")] for s in (3, 3, 4)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert not np.array_equal(runs[0][0], runs[2][0])
