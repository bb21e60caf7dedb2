"""The port's data path against the reference's: ``ImageNetData``
(synthetic batches, epoch shuffle, per-image crop/mirror draws),
``np_crop_mirror``, the ``.npz`` path, and per-rank rows against the
reference's ``shard_batch`` over a two-device ``dp`` mesh.  All exact:
both are the same numpy computations from the same seeds."""

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.data.providers import ImageNetData as JaxImageNetData
from theanompi_tpu.ops.augment import np_crop_mirror as jax_np_crop_mirror
from theanompi_tpu.runtime.mesh import make_mesh, shard_batch
from theanompi_tpu_torch.data.loader import (
    PrefetchLoader, prefetch_to_device, rank_rows,
)
from theanompi_tpu_torch.data.providers import ImageNetData
from theanompi_tpu_torch.ops.augment import np_crop_mirror

KW = dict(batch_size=4, image_size=20, n_classes=7, n_synth_batches=3,
          n_synth_val_batches=2, seed=3)


@pytest.mark.parametrize("crop_size", [None, 16])
def test_synthetic_batches_equal_reference(crop_size):
    ref = JaxImageNetData(**KW, crop_size=crop_size)
    port = ImageNetData(**KW, crop_size=crop_size)
    for epoch in range(2):
        ref.shuffle(epoch)
        port.shuffle(epoch)
        assert port.n_batch_train == ref.n_batch_train == 3
        for (xr, yr), (xp, yp) in zip(ref.train_batches(),
                                      port.train_batches()):
            np.testing.assert_array_equal(xp, xr)
            np.testing.assert_array_equal(yp, yr)
    for (xr, yr), (xp, yp) in zip(ref.val_batches(), port.val_batches()):
        np.testing.assert_array_equal(xp, xr)
        np.testing.assert_array_equal(yp, yr)


def test_np_crop_mirror_equals_reference():
    x = np.random.RandomState(0).randn(6, 12, 12, 3).astype(np.float32)
    for crop, mirror in ((None, True), (9, True), (9, False)):
        a = jax_np_crop_mirror(np.random.RandomState(1), x, crop, mirror)
        b = np_crop_mirror(np.random.RandomState(1), x, crop, mirror)
        np.testing.assert_array_equal(a, b)


def test_npz_batches_equal_reference(tmp_path):
    rng = np.random.RandomState(4)
    for split in ("train", "val"):
        (tmp_path / split).mkdir()
        for i in range(2):
            np.savez(tmp_path / split / f"b{i}.npz",
                     x=rng.randint(0, 256, (4, 20, 20, 3)).astype(np.uint8),
                     y=rng.randint(0, 7, 4))
    kw = dict(KW, data_dir=str(tmp_path))
    ref, port = JaxImageNetData(**kw), ImageNetData(**kw)
    assert not port.synthetic
    for (xr, yr), (xp, yp) in zip(ref.train_batches(), port.train_batches()):
        np.testing.assert_array_equal(xp, xr)
        np.testing.assert_array_equal(yp, yr)


def test_rank_rows_follow_reference_dp_sharding():
    x = np.arange(8 * 2 * 2 * 3, dtype=np.float32).reshape(8, 2, 2, 3)
    y = np.arange(8, dtype=np.int32)
    mesh = make_mesh(devices=jax.devices()[:2])
    xs, ys = shard_batch(mesh, (x, y))
    dev_rows = {s.device: np.asarray(s.data) for s in xs.addressable_shards}
    for r, d in enumerate(mesh.devices.reshape(-1)):
        xr, yr = rank_rows((x, y), r, 2)
        np.testing.assert_array_equal(xr, dev_rows[d])
        np.testing.assert_array_equal(yr, y[r * 4:(r + 1) * 4])
    with pytest.raises(ValueError, match="does not split"):
        rank_rows((x[:7],), 0, 2)


def test_prefetch_loader_yields_rank_rows_on_the_device_and_reraises():
    port = ImageNetData(**KW)
    want = [rank_rows(b, 1, 2) for b in port.train_batches()]
    port2 = ImageNetData(**KW)
    got = list(prefetch_to_device(port2.train_batches(),
                                  torch.device("cpu"), rank=1, world=2))
    assert len(got) == len(want) == 3
    for (xg, yg), (xw, yw) in zip(got, want):
        assert xg.shape[0] == 2 and xg.device.type == "cpu"
        np.testing.assert_array_equal(xg.numpy(), xw)
        np.testing.assert_array_equal(yg.numpy(), yw)

    def boom():
        yield 1
        raise OSError("disk gone")

    it = PrefetchLoader(boom(), lambda b: b)
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
