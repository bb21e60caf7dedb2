"""The port's raw shards and native loader against the reference's.

- ``write_raw_shard`` / ``write_shard_dir`` write the reference's bytes
  (shard files and ``meta.json`` byte for byte).
- ``aug_draws`` equals the reference's draws (exact).
- ``RawShardReader`` (the native library, built by the port into
  ``theanompi_tpu_torch/_build/``) yields the same batches as the
  port's plain NumPy reader and as the reference's ``RawShardReader``,
  bit for bit (tolerance 0), with and without crop and mirror.
- A failed build raises with the compiler's output; no reader falls
  back to NumPy.  Two processes building at once leave one library.
- ``ImageNetData`` over a raw-shard directory yields the reference's
  batches (train with crop and mirror, epochs 0 and 1, a worker's
  ``shard_for_worker`` slice, val, the ``img_mean.npy`` sidecar) bit
  for bit; a train-only directory is valid.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import theanompi_tpu.data.shards as ref_shards
from theanompi_tpu.data.providers import ImageNetData as RefImageNetData
from theanompi_tpu_torch.data import shards
from theanompi_tpu_torch.data.providers import ImageNetData

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, C = 4, 12, 3  # images a shard, stored size, channels


def _batches(n_shards, seed=0, n=N, h=H):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, h, h, C).astype(np.float32),
             rng.randint(0, 10, n).astype(np.int32))
            for _ in range(n_shards)]


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    paths = shards.write_shard_dir(str(d / "train"), _batches(5))
    shards.write_shard_dir(str(d / "val"), _batches(2, seed=1))
    return d, paths


def test_shard_files_are_the_reference_s_bytes(tmp_path):
    batches = _batches(3, seed=4)
    mine = shards.write_shard_dir(str(tmp_path / "a"), batches)
    theirs = ref_shards.write_shard_dir(str(tmp_path / "b"), batches)
    assert [os.path.basename(p) for p in mine] == [
        os.path.basename(p) for p in theirs]
    for a, b in zip(mine + [str(tmp_path / "a" / "meta.json")],
                    theirs + [str(tmp_path / "b" / "meta.json")]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert shards.read_meta(str(tmp_path / "a")) == ref_shards.read_meta(
        str(tmp_path / "b"))
    with pytest.raises(ValueError, match="one batch shape"):
        shards.write_shard_dir(str(tmp_path / "c"),
                               [batches[0], _batches(1, n=2)[0]])


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**63 + 5])
@pytest.mark.parametrize("mirror", [True, False])
def test_aug_draws_equal_the_reference(seed, mirror):
    for file_idx in (0, 1, 1000):
        for max_oh, max_ow in ((0, 0), (4, 4), (16, 3)):
            got = shards.aug_draws(seed, file_idx, 33, max_oh, max_ow, mirror)
            want = ref_shards.aug_draws(seed, file_idx, 33, max_oh, max_ow,
                                        mirror)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.int32
                np.testing.assert_array_equal(g, w)


def test_the_library_is_built_into_the_port_s_build_dir():
    lib = shards.load_library()
    path = shards.library_path()
    assert path.parent == shards.BUILD_DIR
    assert path.parent == shards.Path(ROOT) / "theanompi_tpu_torch" / "_build"
    assert lib._name == str(path) and path.exists()
    assert lib.tnp_version() == 2


def _read(reader):
    return list(reader)


AUG = [dict(), dict(crop_size=8, mirror=True, aug_seed=11),
       dict(crop_size=8, mirror=False, aug_seed=3),
       dict(crop_size=None, mirror=True, aug_seed=2**40 + 9)]


@pytest.mark.parametrize("aug", AUG, ids=["plain", "crop+mirror", "crop",
                                          "mirror"])
def test_native_batches_equal_plain_and_reference(shard_dir, aug):
    _, paths = shard_dir
    order = [paths[i] for i in (3, 0, 4, 1, 2)]
    args = (order, (N, H, H, C), (N,))
    kw = dict(aug, return_meta=bool(aug))
    native = _read(shards.RawShardReader(*args, **kw))
    plain = _read(shards.PlainShardReader(*args, **kw))
    ref = _read(ref_shards.RawShardReader(*args, **kw))
    assert len(native) == len(plain) == len(ref) == 5
    for a, b, c in zip(native, plain, ref):
        for x, y, z in zip(a, b, c):
            assert x.dtype == y.dtype == z.dtype
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    if aug.get("mirror"):
        assert any(m[:, 2].any() for _, _, m in native)


def test_empty_and_short_shards(tmp_path, shard_dir):
    _, paths = shard_dir
    assert _read(shards.RawShardReader([], (N, H, H, C), (N,))) == []
    bad = tmp_path / "short.raw"
    bad.write_bytes(open(paths[0], "rb").read()[:-4])
    for reader in (shards.RawShardReader, shards.PlainShardReader):
        with pytest.raises(IOError):
            _read(reader([paths[0], str(bad)], (N, H, H, C), (N,)))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(shards, "SOURCE", src)
    monkeypatch.setattr(shards, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="shard loader build failed") as e:
        shards.build_library()
    assert "broken.cpp" in str(e.value) and "error" in str(e.value)
    # the reader never falls back to NumPy
    with pytest.raises(RuntimeError, match="shard loader build failed"):
        shards.RawShardReader([], (N, H, H, C), (N,))
    assert not list((tmp_path / "build").glob("*.so"))


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    code = ("import sys; from pathlib import Path\n"
            "from theanompi_tpu_torch.data import shards\n"
            "shards.BUILD_DIR = Path(sys.argv[1])\n"
            "print(shards.load_library()._name)\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp_path / "b")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o.strip() for o, _ in outs}) == 1
    assert [f.name for f in (tmp_path / "b").iterdir() if f.suffix == ".so"
            ] == [shards.library_path().name]


def _providers(root, **kw):
    args = dict(batch_size=N, data_dir=str(root), image_size=H,
                n_classes=10, seed=5, **kw)
    return ImageNetData(**args), RefImageNetData(**args)


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (x1, y1), (x2, y2) in zip(a, b):
        assert x1.dtype == x2.dtype and y1.dtype == y2.dtype
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
    return len(a)


@pytest.mark.parametrize("crop_size,mirror", [(8, True), (None, False)])
def test_imagenet_raw_batches_equal_the_reference(shard_dir, crop_size,
                                                  mirror):
    root, _ = shard_dir
    mine, ref = _providers(root, crop_size=crop_size, mirror=mirror)
    assert (mine.n_batch_train, mine.n_batch_val) == (
        ref.n_batch_train, ref.n_batch_val) == (5, 2)
    for epoch in (0, 1):
        mine.shuffle(epoch)
        ref.shuffle(epoch)
        assert _same_batches(mine.train_batches(), ref.train_batches()) == 5
    assert _same_batches(mine.val_batches(), ref.val_batches()) == 2
    mine.shard_for_worker(1, 2)
    ref.shard_for_worker(1, 2)
    mine.shuffle(3)
    ref.shuffle(3)
    assert mine.n_batch_train == ref.n_batch_train == 2
    assert _same_batches(mine.train_batches(), ref.train_batches()) == 2


def test_imagenet_raw_train_only_dir_and_mean_sidecar(tmp_path, capsys):
    shards.write_shard_dir(str(tmp_path / "train"), _batches(3, seed=2))
    mean = np.random.RandomState(0).rand(H, H, C).astype(np.float32)
    np.save(tmp_path / "img_mean.npy", mean)
    with open(tmp_path / "labels.json", "w") as f:
        json.dump([str(i) for i in range(10)], f)
    mine, ref = _providers(tmp_path, crop_size=8)
    assert mine.n_batch_val == ref.n_batch_val == 0
    assert list(mine.val_batches()) == []
    np.testing.assert_array_equal(mine.img_mean_rgb, ref.img_mean_rgb)
    mine.shuffle(0)
    ref.shuffle(0)
    assert _same_batches(mine.train_batches(), ref.train_batches()) == 3
    assert "applying per-channel mean" in capsys.readouterr().out
