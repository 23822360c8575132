"""Checkpoints of the trainer's state, with atomic commit and auto-resume.

The on-disk contract of the JAX package's ``ckpt/checkpoint.py``:
  * ``save`` writes to ``step_N.tmp/``, fsyncs, and renames it atomically to
    ``step_N/``: a crash mid-save never corrupts the latest checkpoint;
  * tensors are stored as whole arrays (``leaf_*.npy``) beside a JSON
    manifest of their keys and dtypes; ``restore`` reads them back into the
    structure (and onto the devices and dtypes) of a given tree;
  * keep-last-k garbage collection; ``latest_step`` scans for auto-resume.
A tree is nested dicts, tuples/lists and named tuples (``OptState``) of
tensors or numpy arrays; a leaf's key is its path joined by ``/`` (dict
key, sequence index, or named-tuple field). bfloat16 tensors, which numpy
has no type for, are written as the JAX package writes a bfloat16 leaf: a
2-byte void ``.npy`` (``<V2``) of their bits, ``bfloat16`` in the
manifest; they load back, from either package's files, by the manifest.

``CheckpointManager(async_save=True)`` copies the tree to the host, then
writes on a worker thread, overlapping I/O with the next training step.

``save_state``/``load_state`` commit serving state (nested dicts with int
keys, lists, tuples, sets, strings, None and arrays) with the same atomic
contract, in the JAX package's tagged-JSON layout (``state.json``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs in a fixed order: dict keys sorted (as JAX
    flattens dicts), sequences and named tuples in order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, x in items:
        out += _flatten(x, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten(like: Any, leaves: dict, prefix: str = "") -> Any:
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, key(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves, key(f)) for f, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, key(i)) for i, v in enumerate(like))
    return leaves[prefix]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(array to write, dtype name for the manifest): a tensor goes to the
    host once; a bfloat16 one as its 16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, except that bfloat16 bits get the header JAX's
    ``np.save`` of an ml_dtypes bfloat16 array writes (``<V2``): the two
    packages' files are then byte-identical."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _load_npy(path: Path, dtype: str):
    """A leaf as written: numpy, or for a ``bfloat16`` manifest entry a CPU
    ``torch.bfloat16`` tensor with the same bits (numpy has no bfloat16,
    and the 2-byte void it reads is no array type JAX accepts either)."""
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def save(path: str | os.PathLike, tree: Any, step: int) -> Path:
    """Atomic checkpoint write; returns the committed directory."""
    tmp, final = _staging(path, step)
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _to_host(leaf)
        fn = f"leaf_{i:05d}.npy"
        _save_npy(tmp / fn, arr, dtype)
        manifest["leaves"].append({"key": key, "file": fn, "dtype": dtype})
    (tmp / _MANIFEST).write_text(json.dumps(manifest))
    return _commit(tmp, final)


def _commit(tmp: Path, final: Path) -> Path:
    """fsync the directory's entries, then publish it atomically."""
    for f in tmp.iterdir():
        fd = os.open(f, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _staging(path: str | os.PathLike, step: int) -> tuple[Path, Path]:
    """A fresh ``step_N.tmp/`` and the ``step_N/`` it will become."""
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    return tmp, final


def latest_step(path: str | os.PathLike) -> int | None:
    root = Path(path)
    if not root.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in root.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        and (p / _MANIFEST).exists()
    ]
    return max(steps) if steps else None


def restore(path: str | os.PathLike, like: Any, step: int | None = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``like``: each tensor leaf comes back
    as a tensor on that leaf's device with its dtype (shapes must match;
    a leaf on the ``meta`` device gives only shape and dtype, and comes
    back on the CPU), each other leaf as a numpy array. ``shardings``, a
    tree of the same structure whose leaves are
    ``dist.sharding.NamedSharding``s (or ``None``), re-shards for an
    elastic mesh change, as JAX's ``device_put`` with a target sharding: a
    leaf with one comes back as ``distribute_tensor(leaf, mesh,
    placements)`` on the mesh's device (every rank reads the whole file
    and keeps its shard). Returns ``(tree, step)``."""
    root = Path(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}
    target = dict(_flatten(shardings)) if shardings is not None else {}
    leaves = {}
    for key, leaf in _flatten(like):
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = _load_npy(d / meta["file"], meta["dtype"])
        expect = getattr(leaf, "shape", None)
        if expect is not None and tuple(arr.shape) != tuple(expect):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != expected {tuple(expect)}")
        sh = target.get(key)
        if isinstance(leaf, torch.Tensor):
            dev = "cpu" if leaf.device.type == "meta" else leaf.device
            arr = torch.as_tensor(arr).to(device=dev, dtype=leaf.dtype)
        if sh is not None:
            from torch.distributed.tensor import distribute_tensor

            arr = distribute_tensor(torch.as_tensor(arr), sh.mesh, list(sh.placements))
        leaves[key] = arr
    return _unflatten(like, leaves), step


# ---------------------------------------------------------------- state blobs
#
# ``save``/``restore`` speak trees of tensors, the trainer's language.
# Serving state (``ForestPool.snapshot()`` and friends) is richer: nested
# dicts with int keys, free lists whose order matters, sets, strings, None
# and arrays. The codec encodes containers as tagged JSON (``__dict__``
# keeps int keys and insertion order, ``__tuple__``/``__set__`` round-trip
# exactly, sets sorted by ``repr`` for deterministic bytes) and spills
# arrays to npy leaves beside the manifest: the JAX package's format, so
# one directory loads in either package.

_STATE = "state.json"


def _enc_state(x: Any, arrays: list) -> Any:
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    if isinstance(x, (np.ndarray, torch.Tensor)):
        arrays.append(_to_host(x))
        return {"__arr__": len(arrays) - 1}
    if isinstance(x, tuple):
        return {"__tuple__": [_enc_state(v, arrays) for v in x]}
    if isinstance(x, list):
        return {"__list__": [_enc_state(v, arrays) for v in x]}
    if isinstance(x, (set, frozenset)):
        enc = [_enc_state(v, arrays) for v in x]
        return {"__set__": sorted(enc, key=repr)}
    if isinstance(x, dict):
        return {"__dict__": [[_enc_state(k, arrays), _enc_state(v, arrays)]
                             for k, v in x.items()]}
    raise TypeError(f"save_state cannot encode {type(x).__name__}")


def _dec_state(x: Any, arrays: list) -> Any:
    if isinstance(x, dict):
        if "__arr__" in x:
            return arrays[x["__arr__"]]
        if "__tuple__" in x:
            return tuple(_dec_state(v, arrays) for v in x["__tuple__"])
        if "__list__" in x:
            return [_dec_state(v, arrays) for v in x["__list__"]]
        if "__set__" in x:
            return {_dec_state(v, arrays) for v in x["__set__"]}
        if "__dict__" in x:
            return {_dec_state(k, arrays): _dec_state(v, arrays) for k, v in x["__dict__"]}
        raise ValueError(f"unknown state tag {sorted(x)!r}")
    return x


def save_state(path: str | os.PathLike, state: Any, step: int) -> Path:
    """Atomically commit a nested state blob (the tmp/fsync/rename contract
    of :func:`save`; :func:`latest_step` finds it). Array leaves are numpy
    arrays or tensors on any device."""
    tmp, final = _staging(path, step)
    arrays: list = []
    enc = _enc_state(state, arrays)
    files = []
    for i, (arr, dtype) in enumerate(arrays):
        fn = f"leaf_{i:05d}.npy"
        _save_npy(tmp / fn, arr, dtype)
        files.append({"file": fn, "dtype": dtype})
    (tmp / _STATE).write_text(json.dumps(enc))
    (tmp / _MANIFEST).write_text(json.dumps({"step": step, "kind": "state", "leaves": files}))
    return _commit(tmp, final)


def load_state(path: str | os.PathLike, step: int | None = None) -> tuple[Any, int]:
    """Load a :func:`save_state` blob of either package (latest step by
    default). Array leaves come back as numpy arrays, except bfloat16
    leaves, which come back as CPU ``torch.bfloat16`` tensors with the same
    bits (the manifest names their dtype)."""
    root = Path(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no state snapshot under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    if manifest.get("kind") != "state":
        raise ValueError(f"{d} is a pytree checkpoint, not a state blob")
    arrays = [_load_npy(d / m["file"], m["dtype"]) for m in manifest["leaves"]]
    return _dec_state(json.loads((d / _STATE).read_text()), arrays), step


class CheckpointManager:
    """keep-last-k, optional async, auto-resume.

    Async worker failures are never swallowed: an exception on the write
    thread is captured and re-raised on the next :meth:`save` or
    :meth:`wait` call, so a training loop cannot run on believing that
    checkpoints exist when the disk filled up."""

    def __init__(self, path: str | os.PathLike, keep: int = 3, async_save: bool = False):
        self.root = Path(path)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def _gc(self) -> None:
        steps = sorted(
            p for p in self.root.iterdir()
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        )
        for p in steps[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint save failed") from exc

    def save(self, tree: Any, step: int) -> None:
        if self._thread is not None:
            self._thread.join()  # one in flight
            self._thread = None
        self._raise_pending()
        if not self.async_save:
            save(self.root, tree, step)
            self._gc()
            return
        # snapshot now: the trainer updates its tensors in place
        host = _unflatten(tree, {
            k: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else np.array(x)
            for k, x in _flatten(tree)})

        def work():
            try:
                save(self.root, host, step)
                self._gc()
            except BaseException as e:  # surfaced on the next save()/wait()
                self._exc = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def restore_latest(self, like: Any, shardings: Any = None):
        return restore(self.root, like, None, shardings=shardings)
