"""The port's real-data loaders (``training/duke.py``, ``retouch.py``,
``png_volumes.py``, ``native_io.py``, ``datasets.py``, the folder reads of
``fouriernet_pipeline.py`` and ``data.load_real_dataset`` /
``make_datasets``) against the JAX package's on the same synthetic files,
written here in the published formats: equal arrays of the same dtype."""

import builtins
import sys

import numpy as np
import pytest
import scipy.io as sio
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    data as jdata,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    datasets as jsets,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    duke as jduke,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    fouriernet_pipeline as jfn,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    png_volumes as jpng,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    retouch as jret,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    data as tdata,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    datasets as tsets,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    duke as tduke,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    fouriernet_pipeline as tfn,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    native_io,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    png_volumes as tpng,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    retouch as tret,
)


def _equal(got, want):
    """Equal arrays (NaN in the same places) of the same dtype, through
    nested tuples, lists and dicts."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ------------------------------------------------------------------ Duke


def _duke_volume(seed=0, h=64, w=48, b=5, annotated=(1, 3)):
    return tduke.synthetic_duke_dme_volume(
        np.random.default_rng(seed), h, w, b, annotated)


def _write_v73(path, vol):
    import h5py

    with h5py.File(path, "w") as f:  # MATLAB v7.3 stores axis-reversed
        for k, v in vol.items():
            f[k] = v.transpose(range(v.ndim)[::-1])


def test_synthetic_volume_has_the_published_layout():
    vol = tduke.synthetic_duke_dme_volume(np.random.default_rng(0), 64, 48,
                                          61)
    assert vol["images"].shape == (64, 48, 61)
    assert vol["images"].dtype == np.uint8
    assert vol["manualLayers1"].shape == (8, 48, 61)
    assert vol["manualFluid1"].shape == (64, 48, 61)
    annotated = ~np.isnan(vol["manualLayers1"]).all(axis=(0, 1))
    assert np.nonzero(annotated)[0].tolist() == list(tduke.DUKE_ANNOTATED)
    assert (vol["manualFluid1"][..., annotated].sum(axis=(0, 1)) > 0).all()


@pytest.mark.parametrize("container", ["v5", "v7.3"])
def test_load_duke_volume_matches_jax(tmp_path, container):
    path = str(tmp_path / "Subject_01.mat")
    vol = _duke_volume()
    if container == "v5":
        sio.savemat(path, vol)
    else:
        _write_v73(path, vol)
    got = tduke.load_duke_dme_volume(path)
    _equal(got, jduke.load_duke_dme_volume(path))
    labels, valid = got[1], got[2]
    assert tduke.annotated_slices(labels, valid).tolist() == [1, 3]
    _equal(tduke.annotated_slices(labels, valid),
           jduke.annotated_slices(labels, valid))
    assert (labels == tduke.FLUID_CLASS).any()
    assert labels.max() < tduke.DUKE_NUM_CLASSES


def test_v73_without_h5py_raises_naming_it(tmp_path, monkeypatch):
    path = str(tmp_path / "Subject_02.mat")
    _write_v73(path, _duke_volume())
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tduke.load_duke_dme_volume(path)


@pytest.mark.parametrize("fluid", [False, True])
def test_rasterize_surfaces_matches_jax(fluid):
    rng = np.random.default_rng(2)
    surf = np.sort(rng.uniform(2, 30, (8, 12)), axis=0)
    surf[:, 3] = np.nan
    fl = (rng.random((32, 12)) < 0.2) * 255.0 if fluid else None
    _equal(tduke.rasterize_surfaces(surf, fl, 32),
           jduke.rasterize_surfaces(surf, fl, 32))


@pytest.mark.parametrize("image_size", [(32, 64), (64, 48), None])
def test_duke_dataset_matches_jax(tmp_path, image_size):
    for i in range(2):
        sio.savemat(tmp_path / f"Subject_{i:02d}.mat", _duke_volume(seed=i))
    kw = dict(batch_size=2, image_size=image_size, seed=3)
    port = tduke.DukeDMEDataset(str(tmp_path), **kw)
    ref = jduke.DukeDMEDataset(str(tmp_path), **kw)
    assert port.steps_per_epoch == ref.steps_per_epoch == 2
    for epoch in range(2):
        for (xg, yg), (xw, yw) in zip(port.epoch(epoch), ref.epoch(epoch)):
            assert isinstance(xg, torch.Tensor)
            _equal((xg.numpy(), yg.numpy()), (xw, yw))


def test_duke_dataset_refuses_an_empty_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .mat volumes"):
        tduke.DukeDMEDataset(str(tmp_path))


# --------------------------------------------------------------- RETOUCH


def _write_case(root, name, shape=(3, 24, 16), dtype=np.uint16,
                compressed=False, labels=True, seed=0):
    rng = np.random.default_rng(seed)
    d = root / name
    d.mkdir(parents=True)
    vol = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    tret.write_mhd_volume(str(d / "oct.mhd"), vol, spacing=(0.01, 0.004, 0.1),
                          compressed=compressed)
    if labels:
        ref = rng.integers(0, 4, shape).astype(np.uint8)
        tret.write_mhd_volume(str(d / "reference.mhd"), ref,
                              compressed=compressed)
    return vol


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "zlib"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_mhd_round_trip_and_jax(tmp_path, compressed, dtype):
    vol = np.random.default_rng(1).uniform(0, 200, (3, 10, 7)).astype(dtype)
    path = str(tmp_path / "v.mhd")
    tret.write_mhd_volume(path, vol, compressed=compressed)
    jpath = str(tmp_path / "j.mhd")
    jret.write_mhd_volume(jpath, vol, compressed=compressed)
    assert open(path).read().replace("v.raw", "j.raw") == open(jpath).read()
    got = tret.load_mhd_volume(path)
    _equal(got, jret.load_mhd_volume(path))
    _equal(got[0], vol)
    _equal(tret.parse_mhd(path), jret.parse_mhd(path))


def test_parse_mhd_embedded_payload(tmp_path):
    vol = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    path = tmp_path / "v.mha"
    with open(path, "wb") as f:
        f.write(b"ObjectType = Image\nNDims = 3\nDimSize = 4 3 2\n"
                b"ElementType = MET_UCHAR\nElementDataFile = LOCAL\n")
        f.write(vol.tobytes())
    _equal(tret.parse_mhd(str(path)), jret.parse_mhd(str(path)))
    _equal(tret.load_mhd_volume(str(path)), jret.load_mhd_volume(str(path)))


def test_retouch_cases_match_jax(tmp_path):
    _write_case(tmp_path, "TRAIN001", seed=1)
    _write_case(tmp_path, "TRAIN002", compressed=True, seed=2)
    _write_case(tmp_path, "TEST001", labels=False, seed=3)
    (tmp_path / "notes").mkdir()
    got = list(tret.iter_cases(str(tmp_path)))
    want = list(jret.iter_cases(str(tmp_path)))
    assert [c["case"] for c in got] == ["TEST001", "TRAIN001", "TRAIN002"]
    for g, w in zip(got, want):
        assert (g["labels"] is None) == (w["labels"] is None)
        _equal({k: v for k, v in g.items() if v is not None},
               {k: v for k, v in w.items() if v is not None})
    assert got[1]["images"].dtype == np.float32
    assert got[1]["images"].max() <= 1.0


def test_retouch_case_refuses_mismatched_labels(tmp_path):
    d = tmp_path / "TRAIN001"
    d.mkdir()
    tret.write_mhd_volume(str(d / "oct.mhd"), np.zeros((2, 4, 4), np.uint8))
    tret.write_mhd_volume(str(d / "reference.mhd"),
                          np.zeros((2, 4, 5), np.uint8))
    with pytest.raises(ValueError, match="do not match"):
        tret.load_case(str(d))


# ----------------------------------------------------------- native IO


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "zlib"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_native_reader_matches_python(tmp_path, compressed, dtype):
    vol = np.random.default_rng(2).uniform(0, 250, (3, 24, 16)).astype(dtype)
    path = str(tmp_path / "v.mhd")
    tret.write_mhd_volume(path, vol, compressed=compressed)
    dims, got_dtype, got_comp = native_io.mhd_info(path)
    assert dims == (16, 24, 3) and got_dtype == np.dtype(dtype)
    assert got_comp == compressed
    _equal(native_io.load_mhd_volume_native(path), jret.load_mhd_volume(path)[0])


def test_native_prefetch_order_and_content(tmp_path):
    vols, paths = [], []
    for i in range(7):
        vol = np.random.default_rng(i).integers(
            0, 65535, (2, 12 + i, 8)).astype(np.uint16)
        path = str(tmp_path / f"case{i}.mhd")
        tret.write_mhd_volume(path, vol, compressed=i % 2 == 0)
        vols.append(vol)
        paths.append(path)
    with native_io.PrefetchReader(paths, n_threads=3, queue_cap=2) as reader:
        got = list(reader)
    _equal(got, [jret.load_mhd_volume(p)[0] for p in paths])
    _equal(got, vols)


def test_zscore_native_matches_numpy():
    img = np.random.default_rng(0).normal(3.0, 2.0, (64, 48))
    img = img.astype(np.float32)
    want = (img - img.mean()) / np.sqrt(img.var() + 1e-7)
    got = native_io.zscore_native(img.copy())
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="float32"):
        native_io.zscore_native(img.astype(np.float64))


def test_native_build_failure_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native_io, "SRC", bad)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError,
                       match=r"(?s)g\+\+ failed.*broken.cc.*error"):
        native_io.build()
    assert not list((tmp_path / "_build").iterdir())


def test_native_library_builds_into_the_package(tmp_path):
    path = native_io.build()
    assert path.parent == native_io.BUILD_DIR
    assert path.name.startswith("liboctseg_io_") and path.exists()
    assert native_io.get_lib() is native_io.get_lib()


# ------------------------------------------------------------------- PNG


def _write_png_volume(root, name, n=3, h=16, w=12, levels=(0, 64, 128, 255),
                      infix=True, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    idir = root / name / "raw"
    mdir = root / name / "mask"
    idir.mkdir(parents=True)
    mdir.mkdir(parents=True)
    for i in range(n):
        img = rng.integers(0, 255, (h, w)).astype(np.uint8)
        mask = np.asarray(levels, np.uint8)[
            rng.integers(0, len(levels), (h, w))]
        istem = f"{name}_raw_{i:04d}" if infix else f"{i:04d}"
        mstem = f"{name}_mask_{i:04d}" if infix else f"{i:04d}"
        Image.fromarray(img).save(idir / f"{istem}.png")
        Image.fromarray(mask).save(mdir / f"{mstem}.png")


@pytest.mark.parametrize("match,infix,value_map", [
    ("order", True, {0: 0, 64: 1, 128: 2, 255: 3}),
    ("stem", False, None),
    ("order", True, None),
])
def test_load_png_volume_matches_jax(tmp_path, match, infix, value_map):
    _write_png_volume(tmp_path, "p1", infix=infix)
    args = (str(tmp_path / "p1" / "raw"), str(tmp_path / "p1" / "mask"),
            value_map, match)
    got = tpng.load_png_volume(*args)
    _equal(got, jpng.load_png_volume(*args))
    assert got[0].shape == (3, 16, 12, 1) and got[1].dtype == np.int32


def test_iter_png_volumes_and_mask_scan_match_jax(tmp_path):
    # p1 lacks level 128: the global scan keeps class ids consistent
    _write_png_volume(tmp_path, "p1", levels=(0, 64, 255))
    _write_png_volume(tmp_path, "p2", seed=1)
    (tmp_path / "notes").mkdir()
    _equal(tpng.scan_mask_values(str(tmp_path)),
           jpng.scan_mask_values(str(tmp_path)))
    _equal(list(tpng.iter_png_volumes(str(tmp_path))),
           list(jpng.iter_png_volumes(str(tmp_path))))


def test_png_missing_masks_raise(tmp_path):
    _write_png_volume(tmp_path, "p1", infix=True)
    with pytest.raises(FileNotFoundError, match="masks missing"):
        tpng.load_png_volume(str(tmp_path / "p1" / "raw"),
                             str(tmp_path / "p1" / "mask"), match="stem")


def _hide(monkeypatch, *names):
    real = builtins.__import__

    def fake(name, *a, **kw):
        if name.split(".")[0] in names:
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", fake)


def test_imread_falls_back_to_pil_then_raises(tmp_path, monkeypatch):
    _write_png_volume(tmp_path, "p1", n=1)
    path = str(next((tmp_path / "p1" / "raw").iterdir()))
    with_cv2 = tpng._imread(path)
    _hide(monkeypatch, "cv2")
    _equal(tpng._imread(path), with_cv2)
    _hide(monkeypatch, "cv2", "PIL")
    with pytest.raises(ImportError, match="cv2.*PIL"):
        tpng._imread(path)


# ------------------------------------------ catalog and FourierNet folders


def test_dataset_catalog_is_jax_s():
    assert tsets.DATASETS == {k: tsets.DatasetInfo(**vars(v))
                              for k, v in jsets.DATASETS.items()}
    assert tsets.ABBREVIATIONS == jsets.ABBREVIATIONS
    for task in (None, "layers", "lesions", "classification"):
        assert [d.name for d in tsets.list_datasets(task)] == \
            [d.name for d in jsets.list_datasets(task)]


@pytest.mark.parametrize("gold", [False, True])
def test_read_folder_dataset_matches_jax(tmp_path, gold):
    from PIL import Image

    rng = np.random.default_rng(5)
    (tmp_path / "img").mkdir()
    (tmp_path / "gold").mkdir()
    for name in ("b.png", "a.png", "c.bmp"):
        Image.fromarray(rng.integers(0, 255, (10, 14)).astype(np.uint8)).save(
            tmp_path / "img" / name)
        Image.fromarray((rng.random((10, 14)) < 0.3).astype(np.uint8)
                        * 255).save(tmp_path / "gold" / name)
    (tmp_path / "img" / "notes.txt").write_text("x")
    args = (str(tmp_path / "img"), str(tmp_path / "gold") if gold else None)
    got = tfn.read_folder_dataset(*args)
    assert got[2] == ["a.png", "b.png", "c.bmp"]
    _equal(got, jfn.read_folder_dataset(*args))
    _equal(tfn.list_image_files(args[0]), jfn.list_image_files(args[0]))
    _equal(tfn.zscore_image(got[0][0]), jfn.zscore_image(got[0][0]))


# ------------------------------------------------- the dataset dispatcher


def _duke_dir(root, n=3):
    root.mkdir()
    for i in range(n):
        sio.savemat(root / f"Subject_{i:02d}.mat",
                    _duke_volume(seed=i, annotated=(0, 1, 2, 3, 4)))
    return str(root)


def _retouch_dir(root, n=3):
    for i in range(n):
        _write_case(root, f"TRAIN{i:03d}", shape=(4, 40, 32), dtype=np.uint8,
                    seed=i)
    return str(root)


def _png_dir(root, n=2):
    for i in range(n):
        _write_png_volume(root, f"p{i}", n=3, h=40, w=32, seed=i)
    return str(root)


@pytest.mark.parametrize("kind", ["duke", "retouch", "png"])
@pytest.mark.parametrize("size", [(32, 32), (72, 40)])
def test_load_real_dataset_matches_jax(tmp_path, kind, size):
    root = {"duke": _duke_dir, "retouch": _retouch_dir,
            "png": _png_dir}[kind](tmp_path / kind)
    got = tdata.load_real_dataset(f"{kind}:{root}", size,
                                  return_volumes=True)
    _equal(got, jdata.load_real_dataset(f"{kind}:{root}", size,
                                        return_volumes=True))
    assert got[0].shape[1:] == (*size, 1)


def test_load_real_dataset_refuses_bad_specs(tmp_path):
    with pytest.raises(ValueError, match="needs a path"):
        tdata.load_real_dataset("duke", (8, 8))
    with pytest.raises(ValueError, match="unknown dataset kind"):
        tdata.load_real_dataset(f"nifti:{tmp_path}", (8, 8))
    with pytest.raises(FileNotFoundError, match="no labeled B-scans"):
        tdata.load_real_dataset(f"duke:{tmp_path}", (8, 8))


def _batches(ds, epochs=2):
    return [(np.asarray(x), np.asarray(y)) for e in range(epochs)
            for x, y in ds.epoch(e)]


@pytest.mark.parametrize("kind,n_vol,val_fraction", [
    ("duke", 3, 0.1), ("duke", 3, 0.5), ("retouch", 3, 0.3),
    ("retouch", 1, 0.1), ("duke", 1, 0.4),
], ids=["duke-volumes", "duke-volumes-half", "retouch-volumes",
        "retouch-one-volume", "duke-one-volume"])
def test_make_datasets_splits_as_jax(tmp_path, kind, n_vol, val_fraction):
    """Whole volumes held out for validation, or with one volume the last
    B-scans; the same batches in the same order as JAX's."""
    root = {"duke": _duke_dir, "retouch": _retouch_dir}[kind](
        tmp_path / kind, n_vol)
    spec = f"{kind}:{root}"
    got = tdata.make_datasets(spec, (32, 32), 2, val_fraction=val_fraction,
                              seed=1)
    want = jdata.make_datasets(spec, (32, 32), 2, val_fraction=val_fraction,
                               seed=1)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.steps_per_epoch == w.steps_per_epoch >= 1
        _equal(_batches(g), _batches(w))
    _, _, _, vols = tdata.load_real_dataset(spec, (32, 32),
                                            return_volumes=True)
    images = tdata.load_real_dataset(spec, (32, 32))[0]

    def vols_of(ds):
        return {int(vols[np.argmin(((images - x[None]) ** 2).sum((1, 2, 3)))])
                for xb, _ in _batches(ds, 1) for x in xb}

    if n_vol > 1:
        assert vols_of(got[0]).isdisjoint(vols_of(got[1]))
    else:
        assert vols_of(got[0]) == vols_of(got[1]) == {0}


@pytest.mark.parametrize("size", [(32, 32), (96, 112)])
def test_real_batches_are_contiguous(tmp_path, size):
    """scipy reads MATLAB's arrays in Fortran order; the batches must come
    out C-contiguous, since the CUDA kernels take nothing else."""
    root = _duke_dir(tmp_path / "duke", 2)
    images, labels, _ = tdata.load_real_dataset(f"duke:{root}", size)
    assert images.flags["C_CONTIGUOUS"] and labels.flags["C_CONTIGUOUS"]
    train, val, _ = tdata.make_datasets(f"duke:{root}", size, 2)
    for ds in (train, val):
        x, y = next(iter(ds.epoch(0)))
        assert x.is_contiguous() and y.is_contiguous()
    volume = tduke.load_duke_dme_volume(str(next(
        p for p in (tmp_path / "duke").iterdir())))
    assert all(a.flags["C_CONTIGUOUS"] for a in volume)


def test_make_datasets_synthetic_is_none():
    for spec in (None, "", "synthetic", "synthetic_duke_dme"):
        assert tdata.make_datasets(spec, (32, 32), 2) is None
