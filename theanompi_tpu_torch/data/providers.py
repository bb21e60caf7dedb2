"""ImageNet-style data provider — the port's own copy of
``theanompi_tpu.data.providers.ImageNetData`` and
``_synthetic_classification`` (the reference package imports jax).

Providers yield **global** numpy batches (``per-rank batch × world``);
each rank takes its rows (``data.loader.rank_rows``).  Every value
equals the reference's for the same seed: the synthetic images, the
epoch shuffle and the per-image crop/mirror draws.  One difference of
cost, not of value: the class prototypes of the synthetic set (one
fixed ``RandomState(proto_seed)`` draw of ``n_classes`` images, 196 MB
at ImageNet-128 with 1000 classes) are drawn once per process and
kept, where the reference draws them anew for every batch.

The raw-shard layout (``train/meta.json``, read by the reference's
native ring loader) is not ported yet (ROADMAP A6).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Tuple

import numpy as np

from theanompi_tpu_torch.ops.augment import np_crop_mirror


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
    (N,)), or synthetic batches at ``image_size`` when ``data_dir`` is
    absent.  ``batch_size`` is the GLOBAL batch."""

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
        if data_dir and os.path.isfile(
                os.path.join(data_dir, "train", "meta.json")):
            raise NotImplementedError(
                "the raw-shard layout (train/meta.json) is not ported yet: "
                "ROADMAP A6")
        if data_dir and os.path.isdir(data_dir):
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

    @property
    def n_batch_train(self) -> int:
        return len(self.train_files)

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

    def train_batches(self):
        return (self._load(self.train_files[i], train=True)
                for i in self._order)

    def val_batches(self):
        return (self._load(f, train=False) for f in self.val_files)
