"""Checkpoint / resume — the port's counterpart of
``theanompi_tpu.utils.checkpoint``, in the same file format (v2).

A whole training-state tree (parameters, optimizer state, epoch, rng)
is written in one ``.npz``:

- array leaves → one entry each, ``leaf_{i}``;
- the tree's structure → a JSON document stored as a uint8 entry
  (``__structure__``): containers are encoded recursively
  (dict/list/tuple/namedtuple/None), leaves by index and Python kind,
  so restoring never deserializes executable state.

A file written by either package restores in the other to the same
tree, bit for bit.  Torch tensors (on any device) are written as numpy
arrays of their dtype; restore returns numpy leaves.  The reference's
legacy v1 files (a pickled JAX treedef) are refused: this module never
imports ``pickle``.  The reference's Orbax adapters are not ported (the
port has no JAX tree to hand Orbax).

Writes are atomic (a temporary file, then a rename), so a fault in the
middle of a save cannot corrupt the newest snapshot.
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import queue
import tempfile
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

_META_KEY = "__meta__"  # v1 (pickled treedef) marker
_STRUCT_KEY = "__structure__"  # v2 JSON structure
FORMAT_VERSION = 2


def _to_numpy(x: torch.Tensor, copy: bool) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        raise TypeError("checkpoint cannot hold a bfloat16 tensor (numpy "
                        "has no bfloat16); cast it to float32 first")
    a = x.detach().cpu().numpy()
    # a CPU tensor's .numpy() shares its memory: a snapshot must copy
    return np.array(a) if copy and x.device.type == "cpu" else a


def _encode(node: Any, leaves: List[np.ndarray]) -> Any:
    """Container nodes → JSON-able descriptors, leaves → ``{"leaf": i,
    "kind": ...}`` records (the reference's encoding)."""
    if isinstance(node, dict):
        # insertion order is kept, as the reference keeps it
        return {"t": "dict", "k": list(node.keys()),
                "v": [_encode(node[k], leaves) for k in node.keys()]}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {
            "t": "ntuple",
            "cls": f"{type(node).__module__}:{type(node).__qualname__}",
            "f": list(node._fields),
            "v": [_encode(x, leaves) for x in node],
        }
    if isinstance(node, tuple):
        return {"t": "tuple", "v": [_encode(x, leaves) for x in node]}
    if isinstance(node, list):
        return {"t": "list", "v": [_encode(x, leaves) for x in node]}
    if node is None:
        return {"t": "none"}
    # leaf.  The shape check comes first: numpy scalars subclass Python
    # float/int and must round-trip as 0-d arrays (dtype kept)
    if isinstance(node, torch.Tensor):
        node = _to_numpy(node, copy=False)
    if hasattr(node, "shape"):
        kind = "array"
    elif isinstance(node, (bool, int, float, str)):
        kind = type(node).__name__
    else:
        raise TypeError(
            f"checkpoint cannot serialize leaf of type {type(node).__name__}; "
            "supported: arrays, bool/int/float/str, dict/list/tuple/None"
        )
    idx = len(leaves)
    if kind == "str":
        # UTF-8 bytes: numpy's fixed-width unicode drops trailing NULs
        leaves.append(np.frombuffer(node.encode("utf-8"), dtype=np.uint8))
    else:
        leaves.append(np.asarray(node))
    return {"t": "leaf", "i": idx, "kind": kind}


def _decode(desc: Any, leaves: List[np.ndarray]) -> Any:
    t = desc["t"]
    if t == "dict":
        return {k: _decode(v, leaves) for k, v in zip(desc["k"], desc["v"])}
    if t == "tuple":
        return tuple(_decode(v, leaves) for v in desc["v"])
    if t == "ntuple":
        vals = [_decode(v, leaves) for v in desc["v"]]
        return _resolve_namedtuple(desc.get("cls", ""), desc["f"])(*vals)
    if t == "list":
        return [_decode(v, leaves) for v in desc["v"]]
    if t == "none":
        return None
    if t == "leaf":
        a = leaves[desc["i"]]
        kind = desc.get("kind", "array")
        if kind == "array":
            return a
        if kind == "str":
            if a.dtype == np.uint8:
                return a.tobytes().decode("utf-8")
            return str(a.item())  # legacy files: a 0-d unicode array
        return {"bool": bool, "int": int, "float": float}[kind](a.item())
    raise ValueError(f"unknown checkpoint node type {t!r} (corrupt file?)")


def _resolve_namedtuple(qualified: str, fields: List[str]):
    """The namedtuple class of a restored node: the recorded class when
    it lives in this package and has the same fields, else an anonymous
    namedtuple with the recorded name and fields (attribute access and
    arity kept).  Modules outside ``theanompi_tpu_torch`` are never
    imported."""
    mod_name, _, qual = qualified.partition(":")
    if (mod_name.split(".")[0] == "theanompi_tpu_torch" and qual
            and "." not in qual):
        try:
            cls = getattr(importlib.import_module(mod_name), qual, None)
            if (isinstance(cls, type) and issubclass(cls, tuple)
                    and getattr(cls, "_fields", None) == tuple(fields)):
                return cls
        except ImportError:
            pass
    return collections.namedtuple(qual or "Restored", fields)


def save(path: str, tree: Any) -> str:
    """Serialize a tree of arrays, tensors and scalars to ``path``
    (.npz), atomically."""
    leaves: List[np.ndarray] = []
    structure = _encode(tree, leaves)
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    doc = {"format": FORMAT_VERSION, "n_leaves": len(leaves),
           "structure": structure}
    arrays[_STRUCT_KEY] = np.frombuffer(
        json.dumps(doc).encode("utf-8"), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def restore(path: str) -> Any:
    """Inverse of :func:`save`: the tree with numpy leaves.  A v1 file
    (pickled treedef) raises ``ValueError``."""
    with np.load(path, allow_pickle=False) as d:
        if _STRUCT_KEY in d.files:
            doc = json.loads(d[_STRUCT_KEY].tobytes().decode("utf-8"))
            leaves = [d[f"leaf_{i}"] for i in range(doc["n_leaves"])]
            return _decode(doc["structure"], leaves)
        if _META_KEY in d.files:
            raise ValueError(
                f"{path}: a v1 checkpoint (a pickled JAX treedef); this "
                "package reads format v2 only and never unpickles — "
                "restore it with theanompi_tpu.utils.checkpoint and save "
                "it again there to convert it to v2")
    raise ValueError(f"{path}: not a theanompi_tpu checkpoint (no structure "
                     "entry)")


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a dict/list/tuple/namedtuple
    tree (None stays None)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def host_snapshot(tree: Any) -> Any:
    """Device→host copy of every array leaf (torch tensors on any
    device become numpy copies), scalars passed through.

    The synchronous half of an async save: the training step updates
    parameters and optimizer state in place, so a background writer
    must never hold a reference into them.  After this copy the tree is
    plain numpy."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return _to_numpy(x, copy=True)
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            # np.array, not np.asarray: a view of a buffer the caller
            # keeps changing is not a snapshot
            return np.array(x)
        return x

    return map_tree(leaf, tree)


class AsyncCheckpointer:
    """Background checkpoint writer: training does not wait for the disk.

    ``save()`` copies the tree to host memory at once (the part that
    must happen before the next in-place step), then hands the
    serialization and the atomic write to a worker thread.  The queue
    is bounded: with ``max_pending`` writes in flight ``save()`` blocks.
    A writer's error surfaces on the next ``save()`` or ``wait()``."""

    _STOP = object()

    def __init__(self, max_pending: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[Exception] = None
        self._thread = threading.Thread(
            target=self._run, name="async-ckpt", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                path, tree = item
                try:
                    save(path, tree)
                except Exception as e:  # surfaced on next save()/wait()
                    self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, path: str, tree: Any) -> None:
        """Snapshot now, write soon."""
        self._raise_pending()
        if not self._thread.is_alive():
            raise RuntimeError("AsyncCheckpointer is closed")
        self._q.put((path, host_snapshot(tree)))

    def wait(self) -> None:
        """Block until every queued write is on disk; re-raise a writer
        error."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the worker, surface any trailing error."""
        if self._thread.is_alive():
            self._q.join()
            self._q.put(self._STOP)
            self._thread.join()
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _list_checkpoints(dir_path: str, prefix: str) -> List[str]:
    """Checkpoint file names, oldest first: the one order both
    :func:`latest` and :func:`prune` use.  Ties on mtime break on the
    name, whose zero-padded epoch sorts correctly."""
    if not os.path.isdir(dir_path):
        return []
    cands = [f for f in os.listdir(dir_path)
             if f.startswith(prefix) and f.endswith(".npz")]
    cands.sort(key=lambda f: (os.path.getmtime(os.path.join(dir_path, f)), f))
    return cands


def latest(dir_path: str, prefix: str = "ckpt_") -> Optional[str]:
    """The newest checkpoint in a directory (None when there is none)."""
    cands = _list_checkpoints(dir_path, prefix)
    return os.path.join(dir_path, cands[-1]) if cands else None


def prune(dir_path: str, keep_last: int, prefix: str = "ckpt_") -> List[str]:
    """Delete all but the newest ``keep_last`` checkpoints matching
    ``prefix``; returns the deleted paths.  ``keep_last`` must be >= 1:
    a restart must always find something."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    cands = _list_checkpoints(dir_path, prefix)
    doomed = [os.path.join(dir_path, f) for f in cands[:-keep_last]]
    for p in doomed:
        try:
            os.unlink(p)
        except OSError:
            pass  # already gone (a concurrent prune)
    return doomed
