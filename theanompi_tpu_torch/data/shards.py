"""Raw shard files and the native ring loader — the port's counterpart
of ``theanompi_tpu.data.shards``, file for file.

- **Raw shards**: ``[x float32 | y int32]`` flat binary per batch,
  written by :func:`write_raw_shard`; the shapes are in a ``meta.json``
  beside them (:func:`write_shard_dir`, :func:`read_meta`).
- **Native ring loader**: ``native/shard_loader.cpp`` (a C++ reader
  thread filling a ring of pre-allocated slots, per-image random crop
  and horizontal mirror in the fill, a ctypes ABI).  The port builds it
  with ``g++`` at first use into ``_build/`` beside the CUDA kernels
  (listed in ``.gitignore``), the file named by a digest of the source
  and the flags, one build at a time across processes (``flock``), and
  never writes under ``native/``.  :class:`RawShardReader` always reads
  through it; a failed build raises with the compiler's output (the
  reference quietly falls back to NumPy reads).
- :class:`PlainShardReader` is the plain NumPy version of the same
  reader, which the tests hold the native one to: the crop and mirror
  draws come from :func:`aug_draws`, the splitmix64 twin of the C++
  stream keyed on (seed, file index, image index), so both yield the
  same batches bit for bit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from theanompi_tpu_torch.ops.augment import apply_crop_mirror

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "shard_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

_LIBS: Dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtnploader-{h.hexdigest()[:12]}.so"


def build_library() -> Path:
    """Compile ``native/shard_loader.cpp`` into ``BUILD_DIR`` unless it
    is built already; returns the library's path.  Processes that start
    together take turns on a lock, so none loads a half-written file."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtnploader.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if path.exists():  # built by the process that held the lock
            return path
        cxx = os.environ.get("CXX", "g++")
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"shard loader build failed: {' '.join(cmd)}"
                               f": {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"shard loader build failed ({cxx} exit {proc.returncode}):"
                f"\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a reader never sees half a file
    return path


def load_library() -> ctypes.CDLL:
    """The native loader, built if needed (one handle a process)."""
    path = build_library()
    lib = _LIBS.get(path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(path))
    lib.tnp_version.restype = ctypes.c_int
    lib.tnp_loader_open.restype = ctypes.c_void_p
    lib.tnp_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
        ctypes.c_long, ctypes.c_int]
    lib.tnp_loader_open_aug.restype = ctypes.c_void_p
    lib.tnp_loader_open_aug.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int]
    lib.tnp_loader_next.restype = ctypes.c_int
    lib.tnp_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.tnp_loader_next_aug.restype = ctypes.c_int
    lib.tnp_loader_next_aug.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.tnp_loader_error.restype = ctypes.c_char_p
    lib.tnp_loader_error.argtypes = [ctypes.c_void_p]
    lib.tnp_loader_close.argtypes = [ctypes.c_void_p]
    if lib.tnp_version() < 2:
        raise RuntimeError(f"{path}: shard loader ABI "
                           f"{lib.tnp_version()}, want 2 (crop/mirror)")
    _LIBS[path] = lib
    return lib


# -- the splitmix64 twin of the C++ augmentation stream ---------------------
_PHI_FILE = np.uint64(0x9E3779B97F4A7C15)
_PHI_IMG = np.uint64(0xBF58476D1CE4E5B9)
_PHI_DRAW = np.uint64(0x94D049BB133111EB)


def _mix64(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64, copy=True)
    z ^= z >> np.uint64(30)
    z *= np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return z


def aug_draws(seed: int, file_idx: int, n: int, max_oh: int, max_ow: int,
              mirror: bool):
    """(oh, ow, flip) int32 arrays of length n: the keyed splitmix64
    stream of the C++ reader."""
    with np.errstate(over="ignore"):
        base = (np.uint64(seed) + np.uint64(file_idx) * _PHI_FILE
                + np.arange(n, dtype=np.uint64) * _PHI_IMG)
        oh = (_mix64(base) % np.uint64(max_oh + 1)).astype(np.int32)
        ow = (_mix64(base + _PHI_DRAW) % np.uint64(max_ow + 1)).astype(
            np.int32)
        if mirror:
            flip = (_mix64(base + np.uint64(2) * _PHI_DRAW)
                    & np.uint64(1)).astype(np.int32)
        else:
            flip = np.zeros(n, np.int32)
    return oh, ow, flip


def write_raw_shard(path: str, x: np.ndarray, y: np.ndarray) -> None:
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.int32)
    with open(path, "wb") as f:
        f.write(x.tobytes())
        f.write(y.tobytes())


def write_shard_dir(dir_path: str,
                    batches: Sequence[Tuple[np.ndarray, np.ndarray]]
                    ) -> List[str]:
    """Write batches as raw shards + ``meta.json`` (shapes, dtypes)."""
    os.makedirs(dir_path, exist_ok=True)
    first_x, first_y = batches[0]
    meta = {"x_shape": list(first_x.shape), "y_shape": list(first_y.shape),
            "x_dtype": "float32", "y_dtype": "int32",
            "n_shards": len(batches)}
    with open(os.path.join(dir_path, "meta.json"), "w") as f:
        json.dump(meta, f)
    paths = []
    for i, (x, y) in enumerate(batches):
        if x.shape != first_x.shape or y.shape != first_y.shape:
            raise ValueError("all shards must share one batch shape")
        p = os.path.join(dir_path, f"shard_{i:05d}.raw")
        write_raw_shard(p, x, y)
        paths.append(p)
    return paths


def read_meta(dir_path: str) -> dict:
    with open(os.path.join(dir_path, "meta.json")) as f:
        return json.load(f)


class _ReaderBase:
    """Shapes and the augmentation plan shared by both readers.

    **Aug mode** (``crop_size``/``mirror`` with an ``aug_seed``): each
    image is cropped at a random offset and mirrored with probability
    1/2, drawn from the keyed stream of :func:`aug_draws`; x_shape must
    be (N, H, W, C)."""

    def __init__(self, paths: Sequence[str], x_shape: Tuple[int, ...],
                 y_shape: Tuple[int, ...], crop_size: Optional[int] = None,
                 mirror: bool = False, aug_seed: Optional[int] = None,
                 return_meta: bool = False):
        self.paths = [str(p) for p in paths]
        self.x_shape = tuple(x_shape)
        self.y_shape = tuple(y_shape)
        self.x_bytes = int(np.prod(self.x_shape)) * 4
        self.y_bytes = int(np.prod(self.y_shape)) * 4
        self.aug = aug_seed is not None and (bool(crop_size) or mirror)
        self.return_meta = return_meta
        self.crop_size = crop_size
        self.out_shape = self.x_shape
        if self.aug:
            if len(self.x_shape) != 4:
                raise ValueError("aug mode needs (N, H, W, C) shards")
            n, h, w, c = self.x_shape
            self.crop_h = int(crop_size) if crop_size and crop_size < h else h
            self.crop_w = int(crop_size) if crop_size and crop_size < w else w
            self.out_shape = (n, self.crop_h, self.crop_w, c)
            self.mirror = bool(mirror)
            self.aug_seed = int(aug_seed) & 0xFFFFFFFFFFFFFFFF

    def __iter__(self) -> Iterator:
        return self

    def _result(self, x, y, meta):
        return (x, y, meta) if self.return_meta else (x, y)


class RawShardReader(_ReaderBase):
    """Iterate (x, y) batches of raw shard files in the given order
    through the native ring loader (a C++ thread reads ``depth`` files
    ahead, cropping and mirroring in aug mode).  One pass per instance:
    make a new reader per epoch with that epoch's file order."""

    def __init__(self, paths, x_shape, y_shape, depth: int = 3,
                 crop_size: Optional[int] = None, mirror: bool = False,
                 aug_seed: Optional[int] = None, return_meta: bool = False):
        super().__init__(paths, x_shape, y_shape, crop_size, mirror,
                         aug_seed, return_meta)
        self._lib = load_library()
        self._h = None
        if self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            if self.aug:
                n, h, w, c = self.x_shape
                self._h = self._lib.tnp_loader_open_aug(
                    arr, len(self.paths), n, h, w, c, self.y_bytes,
                    int(crop_size or 0), int(self.mirror), self.aug_seed,
                    depth)
            else:
                self._h = self._lib.tnp_loader_open(
                    arr, len(self.paths), self.x_bytes, self.y_bytes, depth)
            if not self._h:
                raise ValueError("native shard loader refused the shapes "
                                 f"{self.x_shape} / {self.y_shape}")

    def __next__(self):
        if not self._h:
            raise StopIteration
        x = np.empty(self.out_shape, np.float32)
        y = np.empty(self.y_shape, np.int32)
        meta = None
        if self.aug:
            meta = np.empty((self.x_shape[0], 3), np.int32)
            rc = self._lib.tnp_loader_next_aug(
                self._h, x.ctypes.data_as(ctypes.c_void_p),
                y.ctypes.data_as(ctypes.c_void_p),
                meta.ctypes.data_as(ctypes.c_void_p))
        else:
            rc = self._lib.tnp_loader_next(
                self._h, x.ctypes.data_as(ctypes.c_void_p),
                y.ctypes.data_as(ctypes.c_void_p))
        if rc == 1:
            return self._result(x, y, meta)
        err = self._lib.tnp_loader_error(self._h).decode()
        self.close()
        if rc < 0:
            raise IOError(err or "native shard loader failed")
        raise StopIteration

    def close(self):
        if self._h:
            self._lib.tnp_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PlainShardReader(_ReaderBase):
    """The plain NumPy version of :class:`RawShardReader` (the same
    batches, read and augmented on the calling thread); the tests hold
    the native reader to it."""

    def __init__(self, paths, x_shape, y_shape,
                 crop_size: Optional[int] = None, mirror: bool = False,
                 aug_seed: Optional[int] = None, return_meta: bool = False):
        super().__init__(paths, x_shape, y_shape, crop_size, mirror,
                         aug_seed, return_meta)
        self._i = 0

    def __next__(self):
        if self._i >= len(self.paths):
            raise StopIteration
        file_idx, p = self._i, self.paths[self._i]
        self._i += 1
        buf = np.fromfile(p, dtype=np.uint8)
        if buf.nbytes != self.x_bytes + self.y_bytes:
            raise IOError(f"shard {p} has {buf.nbytes} bytes, "
                          f"expected {self.x_bytes + self.y_bytes}")
        x = buf[: self.x_bytes].view(np.float32).reshape(self.x_shape)
        y = buf[self.x_bytes:].view(np.int32).reshape(self.y_shape)
        meta = None
        if self.aug:
            n, h, w, _ = self.x_shape
            oh, ow, flip = aug_draws(self.aug_seed, file_idx, n,
                                     h - self.crop_h, w - self.crop_w,
                                     self.mirror)
            x = np.ascontiguousarray(
                apply_crop_mirror(x, oh, ow, flip, self.crop_h, self.crop_w))
            meta = np.stack([oh, ow, flip], axis=1)
        return self._result(x, y, meta)
