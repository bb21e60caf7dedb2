"""Data providers — the port's own copies of
``theanompi_tpu.data.providers.ImageNetData`` (with
``_synthetic_classification``) and ``LMTextData`` (the reference
package imports jax).

Providers yield **global** numpy batches (``per-rank batch × world``);
each rank takes its rows (``data.loader.rank_rows``).  Every value
equals the reference's for the same seed: the synthetic images, the
epoch shuffle and the per-image crop/mirror draws.  One difference of
cost, not of value: the class prototypes of the synthetic set (one
fixed ``RandomState(proto_seed)`` draw of ``n_classes`` images, 196 MB
at ImageNet-128 with 1000 classes) are drawn once per process and
kept, where the reference draws them anew for every batch.

The raw-shard layout (``{train,val}/meta.json`` beside ``*.raw``
files, written by ``data.shards.write_shard_dir``) is read through the
native ring loader (``data.shards.RawShardReader``), which crops and
mirrors each training image on its own thread with the reference's
keyed draws; a train-only directory is valid.

``LMTextData`` yields the reference's ``(tokens, next_tokens)`` int32
windows for the same seed, epoch and rank: the synthetic affine walk
with 10 % noise, the epoch shuffle and the ``rank::n`` worker slice.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Tuple

import numpy as np

from theanompi_tpu_torch.data.shards import RawShardReader, read_meta
from theanompi_tpu_torch.ops.augment import np_crop_mirror


def _check_worker_shard(rank: int, n_workers: int, n_mine: int,
                        min_needed: int, what: str) -> None:
    """Per-worker sharding checks (as the reference's)."""
    if not (0 <= rank < n_workers):
        raise ValueError(f"rank {rank} outside [0, {n_workers})")
    if n_mine < min_needed:
        raise ValueError(
            f"worker shard too small: {n_mine} {what} < {min_needed}; "
            f"reduce n_workers or batch size"
        )


def _worker_slice(order: np.ndarray, rank: int, n_workers: int) -> np.ndarray:
    """Worker ``rank``'s disjoint ``rank::n`` slice of a permutation."""
    return order if n_workers == 1 else order[rank::n_workers]


def _epoch_seed(epoch: int) -> int:
    """Process-independent epoch → seed map (same as the reference)."""
    return (int(epoch) * 1_000_003 + 12345) % (2**31)


@functools.lru_cache(maxsize=4)
def _prototypes(n_classes: int, shape: Tuple[int, ...], proto_seed: int,
                proto_scale: float) -> np.ndarray:
    protos = (np.random.RandomState(proto_seed).randn(n_classes, *shape)
              .astype(np.float32) * proto_scale)
    protos.setflags(write=False)
    return protos


def _synthetic_classification(
    n: int, shape: Tuple[int, ...], n_classes: int, seed: int,
    proto_seed: Optional[int] = None,
    proto_scale: float = 0.5,
    noise: float = 0.3,
    label_noise: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussians: one prototype image per class plus
    noise; see the reference for the difficulty knobs."""
    rng = np.random.RandomState(seed + 1_000_003)
    protos = _prototypes(n_classes, tuple(shape),
                         seed if proto_seed is None else proto_seed,
                         float(proto_scale))
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + rng.randn(n, *shape).astype(np.float32) * noise
    if label_noise > 0.0:
        flip = rng.rand(n) < label_noise
        y = np.where(
            flip, (y + rng.randint(1, n_classes, size=n)) % n_classes, y,
        ).astype(np.int32)
    return x, y


class ImageNetData:
    """ImageNet-style provider over ``.npz`` shard files
    (``data_dir/{train,val}/*.npz``, each with ``x`` (N,H,W,C) and ``y``
    (N,)), over raw shards (``data_dir/train/meta.json``), or synthetic
    batches at ``image_size`` when ``data_dir`` is absent.  Each file is
    one GLOBAL batch (``batch_size``); ``shard_for_worker`` gives a
    worker its ``rank::n`` slice of the epoch's shuffled files."""

    def __init__(
        self,
        batch_size: int,
        data_dir: Optional[str] = None,
        image_size: int = 128,
        n_classes: int = 1000,
        n_synth_batches: int = 64,
        n_synth_val_batches: int = 4,
        seed: int = 0,
        crop_size: Optional[int] = None,
        mirror: bool = True,
        train_aug: bool = True,
        mean_subtract: bool = True,
    ):
        self.batch_size = int(batch_size)
        self.image_size = image_size
        self.n_classes = n_classes
        self.crop_size = crop_size
        self.mirror = mirror
        self.mean_subtract = bool(mean_subtract)
        self.train_aug = train_aug
        self._rng = np.random.RandomState(seed)
        data_dir = data_dir or os.environ.get("IMAGENET_NPZ_DIR", "")
        self.raw_meta = None
        if data_dir and os.path.isfile(
                os.path.join(data_dir, "train", "meta.json")):
            def _split(name):
                d = os.path.join(data_dir, name)
                if not os.path.isfile(os.path.join(d, "meta.json")):
                    return None, []
                return read_meta(d), sorted(
                    os.path.join(d, f) for f in os.listdir(d)
                    if f.endswith(".raw"))

            train_meta, self.train_files = _split("train")
            val_meta, self.val_files = _split("val")
            self.raw_meta = {"train": train_meta, "val": val_meta}
            self.synthetic = False
        elif data_dir and os.path.isdir(data_dir):
            def _files(split):
                d = os.path.join(data_dir, split)
                return sorted(os.path.join(d, f) for f in os.listdir(d)
                              if f.endswith(".npz"))

            self.train_files = _files("train")
            self.val_files = _files("val")
            self.synthetic = False
        else:
            self.train_files = [f"synthetic://{i}"
                                for i in range(n_synth_batches)]
            self.val_files = [f"synthetic://{i}"
                              for i in range(n_synth_val_batches)]
            self.synthetic = True
        self.img_mean_rgb = None
        if not self.synthetic:
            mp = os.path.join(data_dir, "img_mean.npy")
            if os.path.isfile(mp) and self.mean_subtract:
                m = np.load(mp)
                self.img_mean_rgb = (
                    m.reshape(-1, m.shape[-1]).mean(0).astype(np.float32))
                print(f"[ImageNetData] applying per-channel mean from {mp}: "
                      f"{self.img_mean_rgb.tolist()} (mean_subtract=False "
                      "to disable)", flush=True)
            lp = os.path.join(data_dir, "labels.json")
            if os.path.isfile(lp):
                with open(lp) as f:
                    n_labels = len(json.load(f))
                if n_labels != self.n_classes:
                    raise ValueError(
                        f"{lp} maps {n_labels} classes but the model was "
                        f"configured with n_classes={self.n_classes}")
        self._order = np.arange(len(self.train_files))
        self._worker_rank, self._n_workers = 0, 1

    def shard_for_worker(self, rank: int, n_workers: int) -> None:
        """Disjoint ``rank::n`` slice of the shuffled batch files (the
        async rules' per-worker streams); the minimum is one file."""
        n_mine = len(range(rank, len(self.train_files), n_workers))
        _check_worker_shard(rank, n_workers, n_mine, 1, "batch files")
        self._worker_rank, self._n_workers = int(rank), int(n_workers)

    def _my_order(self) -> np.ndarray:
        return _worker_slice(self._order, self._worker_rank, self._n_workers)

    @property
    def n_batch_train(self) -> int:
        return len(range(self._worker_rank, len(self.train_files),
                         self._n_workers))

    @property
    def n_batch_val(self) -> int:
        return len(self.val_files)

    def shuffle(self, epoch=None) -> None:
        if epoch is not None:
            rng = np.random.RandomState(_epoch_seed(epoch))
            self._order = rng.permutation(len(self.train_files))
        else:
            self._order = self._rng.permutation(len(self.train_files))

    def _load(self, path: str, train: bool):
        if path.startswith("synthetic://"):
            i = int(path.split("//")[1])
            shape = (self.image_size, self.image_size, 3)
            x, y = _synthetic_classification(
                self.batch_size, shape, self.n_classes, seed=i, proto_seed=0)
        else:
            with np.load(path) as d:
                x = d["x"].astype(np.float32)
                if x.max() > 2.0:  # uint8-scaled
                    x = x / 255.0
                y = d["y"].astype(np.int32)
            x, y = x[: self.batch_size], y[: self.batch_size]
        return self._postprocess(x, train), y

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        return x if self.img_mean_rgb is None else x - self.img_mean_rgb

    def _postprocess(self, x: np.ndarray, train: bool) -> np.ndarray:
        if train:
            if self.train_aug:
                x = np_crop_mirror(self._rng, x, crop_size=self.crop_size,
                                   mirror=self.mirror)
            return self._normalize(x)
        if self.crop_size:
            c = self.crop_size
            off = (x.shape[1] - c) // 2
            x = x[:, off: off + c, off: off + c, :]
        return self._normalize(x)

    def _raw_batches(self, split: str, paths, train: bool):
        meta = self.raw_meta[split]
        if meta is None or not paths:
            return
        if train and self.train_aug and (self.crop_size or self.mirror):
            # crop and mirror inside the loader's thread; a fresh seed
            # per epoch pass, drawn as the reference draws it
            reader = RawShardReader(
                paths, meta["x_shape"], meta["y_shape"],
                crop_size=self.crop_size, mirror=self.mirror,
                aug_seed=int(self._rng.randint(0, 2**31 - 1)))
            for x, y in reader:
                # the mean is per channel, so it commutes with the crop
                yield (self._normalize(x[: self.batch_size]),
                       y[: self.batch_size])
            return
        reader = RawShardReader(paths, meta["x_shape"], meta["y_shape"])
        for x, y in reader:
            x, y = x[: self.batch_size], y[: self.batch_size]
            yield self._postprocess(x, train), y

    def train_batches(self):
        order = self._my_order()
        if self.raw_meta is not None:
            return self._raw_batches(
                "train", [self.train_files[i] for i in order], train=True)
        return (self._load(self.train_files[i], train=True) for i in order)

    def val_batches(self):
        if self.raw_meta is not None:
            return self._raw_batches("val", self.val_files, train=False)
        return (self._load(f, train=False) for f in self.val_files)


class LMTextData:
    """Language-modelling token provider: ``(tokens, next_tokens)``
    int32 pairs of shape ``(batch, seq_len)``; ``batch_size`` is the
    GLOBAL batch.  Real data is a ``tokens.npy`` (or raw uint16
    ``tokens.bin``) corpus in ``data_dir``, cut into contiguous windows
    of ``seq_len + 1``; without one, a synthetic stream."""

    def __init__(
        self,
        batch_size: int,
        seq_len: int,
        vocab_size: int = 256,
        data_dir: Optional[str] = None,
        n_synth_train: int = 64,
        n_synth_val: int = 4,
        seed: int = 0,
    ):
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self.vocab_size = int(vocab_size)
        self._rng = np.random.RandomState(seed)
        tokens = self._try_load(data_dir) if data_dir else None
        if tokens is None:
            tokens = self._synth_markov(
                (n_synth_train + n_synth_val) * self.batch_size
                * (self.seq_len + 1), seed)
            self.synthetic = True
        else:
            self.synthetic = False
        win = self.seq_len + 1  # +1: targets are inputs shifted by one
        n_windows = len(tokens) // win
        self._windows = tokens[: n_windows * win].reshape(n_windows, win)
        # val split in whole global batches, leaving at least one train
        # batch
        n_val = max(1, min(n_windows // 16, n_synth_val)) * self.batch_size
        if n_val + self.batch_size > n_windows:
            n_val = max(0, n_windows - self.batch_size)
        n_val -= n_val % self.batch_size
        self._val = self._windows[:n_val]
        self._train = self._windows[n_val:]
        self.n_batch_train = len(self._train) // self.batch_size
        self.n_batch_val = len(self._val) // self.batch_size
        if self.n_batch_train == 0:
            raise ValueError(
                f"corpus too small: need >= {self.batch_size * win} tokens "
                f"for one global batch (batch {self.batch_size} x window "
                f"{win}), have {n_windows * win}"
            )
        self._order = np.arange(len(self._train))
        self._worker_rank, self._n_workers = 0, 1

    def shard_for_worker(self, rank: int, n_workers: int) -> None:
        """Disjoint per-worker window stream (the async rules')."""
        n_mine = len(range(rank, len(self._train), n_workers))
        _check_worker_shard(rank, n_workers, n_mine, self.batch_size,
                            "windows")
        self._worker_rank, self._n_workers = int(rank), int(n_workers)
        self.n_batch_train = n_mine // self.batch_size

    def _try_load(self, data_dir: str):
        for name, dtype in (("tokens.npy", None), ("tokens.bin", np.uint16)):
            p = os.path.join(data_dir, name)
            if os.path.isfile(p):
                t = np.load(p) if dtype is None else np.fromfile(p, dtype=dtype)
                return t.astype(np.int32) % self.vocab_size
        return None

    def _synth_markov(self, n: int, seed: int) -> np.ndarray:
        """The affine walk ``clean[i] = (start + i·a) mod v`` (next token
        = ``(t + a) mod v``, learnable) with 10 % uniform replacement
        noise, drawn as the reference draws it."""
        rng = np.random.RandomState(seed)
        v = self.vocab_size
        a = int(rng.randint(1, v))
        clean = (int(rng.randint(0, v)) + np.arange(n, dtype=np.int64) * a) % v
        noise = rng.rand(n) < 0.1
        out = np.where(noise, rng.randint(0, v, size=n), clean)
        return out.astype(np.int32)

    def shuffle(self, epoch=None) -> None:
        if epoch is not None:
            rng = np.random.RandomState(_epoch_seed(epoch))
            self._order = rng.permutation(len(self._train))
        else:
            self._order = self._rng.permutation(len(self._train))

    def train_batches(self):
        bs = self.batch_size
        order = _worker_slice(self._order, self._worker_rank, self._n_workers)
        for i in range(self.n_batch_train):
            w = self._train[order[i * bs: (i + 1) * bs]]
            yield w[:, :-1].copy(), w[:, 1:].copy()

    def val_batches(self):
        bs = self.batch_size
        for i in range(self.n_batch_val):
            w = self._val[i * bs: (i + 1) * bs]
            yield w[:, :-1].copy(), w[:, 1:].copy()
