"""The port's data layer against the JAX package's, on the CPU: synthetic
items, patient-folder items, dataset splits, the loader's batch order, the
host-side target resize of the training loop, and the NIfTI codec. Both
sides are numpy, so items and orders must agree exactly; resized volumes
within 1e-6."""

import numpy as np
import pytest

from hybrid_vit_cascade_tpu.data import DataLoader as JaxLoader
from hybrid_vit_cascade_tpu.data import PatientDRRDataset as JaxPatients
from hybrid_vit_cascade_tpu.data import SyntheticCTDataset as JaxSynthetic
from hybrid_vit_cascade_tpu.data import create_train_val_datasets as jax_split
from hybrid_vit_cascade_tpu.data.nifti import read_nifti as jax_read_nifti
from hybrid_vit_cascade_tpu.training.trainer import host_target_transform as jax_target_tf
from hybrid_vit_cascade_tpu_torch.data import native_io
from hybrid_vit_cascade_tpu_torch.data.dataset import (
    NORMALIZATION_PRESETS,
    PatientDRRDataset,
    create_train_val_datasets,
)
from hybrid_vit_cascade_tpu_torch.data.nifti import read_nifti, write_nifti
from hybrid_vit_cascade_tpu_torch.data.pipeline import DataLoader, to_device
from hybrid_vit_cascade_tpu_torch.data.synthetic import SyntheticCTDataset
from hybrid_vit_cascade_tpu_torch.training.trainer import host_target_transform
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _same_item(a, b, atol=0.0):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("preset", ["soft_tissue", "full"])
def test_synthetic_items_match_jax(preset):
    kw = dict(num_patients=2, volume_size=(32, 32, 32), xray_size=64, preset=preset, seed=3)
    mine, theirs = SyntheticCTDataset(**kw), JaxSynthetic(**kw)
    assert len(mine) == len(theirs) == 2
    for i in range(2):
        _same_item(mine[i], theirs[i], atol=1e-6)
    lo, hi = NORMALIZATION_PRESETS[preset]["range"]
    drr = mine[1]["drr_stacked"]
    assert drr.shape == (2, 1, 64, 64) and drr.min() >= lo - 1e-6 and drr.max() <= hi + 1e-6
    assert mine[0] is mine[0]  # items are cached


class _Ids:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32), "patient_id": f"p{i}"}


@pytest.mark.parametrize("mode", ["seeded_random", "sorted_fraction"])
def test_splits_match_jax(mode):
    for n in (11, 64):
        mine = create_train_val_datasets(_Ids(n), 0.75, 0.15, seed=42, split_mode=mode)
        theirs = jax_split(_Ids(n), 0.75, 0.15, seed=42, split_mode=mode)
        for a, b in zip(mine, theirs):
            assert list(a.indices) == list(b.indices)
    with pytest.raises(ValueError):
        create_train_val_datasets(_Ids(4), split_mode="other")


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_matches_jax(prefetch, drop_last):
    ds = _Ids(11)
    tf = lambda b: {**b, "x": b["x"] * 2}  # noqa: E731
    mine = DataLoader(ds, 4, shuffle=True, seed=5, drop_last=drop_last, num_prefetch=prefetch,
                      transform=tf)
    theirs = JaxLoader(ds, 4, shuffle=True, seed=5, drop_last=drop_last, num_prefetch=0,
                       transform=tf)
    assert len(mine) == len(theirs) == (2 if drop_last else 3)
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(mine), list(theirs)
        assert [b["patient_id"] for b in got] == [b["patient_id"] for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"], w["x"])
    first = [b["patient_id"] for b in DataLoader(ds, 4, seed=5, num_prefetch=prefetch)]
    assert first != [b["patient_id"] for b in mine]  # epoch 1 shuffles anew


def test_loader_stops_early_and_reports_errors():
    """A consumer that stops early releases the prefetch thread; an error in
    the dataset is raised in the consumer's thread."""
    import threading

    before = set(threading.enumerate())
    it = iter(DataLoader(_Ids(40), 2, num_prefetch=2))
    next(it)
    assert set(threading.enumerate()) - before  # the prefetch thread runs
    it.close()
    assert not set(threading.enumerate()) - before

    class Bad(_Ids):
        def __getitem__(self, i):
            raise KeyError(i)

    with pytest.raises(KeyError):
        list(DataLoader(Bad(4), 2, num_prefetch=2))


def test_to_device_keeps_arrays_only():
    import torch

    batch = to_device({"x": np.ones((2, 3), np.float32), "patient_id": ["a", "b"]}, "cpu")
    assert list(batch) == ["x"] and isinstance(batch["x"], torch.Tensor)


@pytest.mark.parametrize("cache", [False, True])
def test_host_target_transform_matches_jax(cache):
    rng = np.random.default_rng(0)
    batch = {"ct_volume": rng.uniform(-1, 1, (2, 1, 32, 32, 32)).astype(np.float32),
             "drr_stacked": np.zeros((2, 2, 1, 8, 8), np.float32), "patient_id": ["a", "b"]}
    for res in ((8, 8, 8), (16, 16, 16)):
        got = host_target_transform(res, cache=cache)(batch)
        want = jax_target_tf(res, cache=cache)(batch)
        assert got["ct_volume"].shape == (2, 1, *res) and got["ct_volume"].dtype == np.float32
        np.testing.assert_allclose(got["ct_volume"], want["ct_volume"], rtol=0, atol=1e-6)
        assert got["drr_stacked"] is batch["drr_stacked"]
    same = host_target_transform((32, 32, 32))(batch)
    assert same is batch  # already at the stage resolution


def test_nifti_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((5, 6, 7)).astype(np.float32) * 300
    for name in ("v.nii", "v.nii.gz"):
        write_nifti(tmp_path / name, vol, spacing=(1.0, 2.0, 3.0))
        np.testing.assert_array_equal(read_nifti(tmp_path / name), vol)
        np.testing.assert_array_equal(jax_read_nifti(tmp_path / name), vol)
        native = native_io.read_nifti(tmp_path / name)
        if native is not None:
            np.testing.assert_array_equal(native, vol)


def test_patient_folder_items_match_jax(tmp_path):
    """A two-patient tree in the reference layout (.npy DRRs, NIfTI CT in
    HU) reads the same in both packages."""
    rng = np.random.default_rng(2)
    for pid in ("patient000", "patient001"):
        d = tmp_path / pid
        d.mkdir()
        for view in ("pa_drr", "lat_drr"):
            np.save(d / f"{pid}_{view}.npy", rng.uniform(0, 255, (20, 20)).astype(np.float32))
        write_nifti(d / f"{pid}.nii.gz", rng.uniform(-1000, 1000, (12, 12, 12)).astype(np.float32))
    kw = dict(target_xray_size=16, target_volume_size=(8, 8, 8), normalization="soft_tissue")
    mine, theirs = PatientDRRDataset(str(tmp_path), **kw), JaxPatients(str(tmp_path), **kw)
    assert len(mine) == len(theirs) == 2
    for i in range(2):
        _same_item(mine[i], theirs[i], atol=1e-6)
    with pytest.raises(ValueError):
        PatientDRRDataset(str(tmp_path / "missing"))
