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
has no type for, are stored as their 16-bit patterns with dtype
``bfloat16`` in the manifest.

``CheckpointManager(async_save=True)`` copies the tree to the host, then
writes on a worker thread, overlapping I/O with the next training step.
The serving-state codec (``save_state``/``load_state``) is not ported yet
(ROADMAP A6).
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
    """(array to write, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(path: str | os.PathLike, tree: Any, step: int) -> Path:
    """Atomic checkpoint write; returns the committed directory."""
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr, dtype = _to_host(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(tmp / fn, arr)
        manifest["leaves"].append({"key": key, "file": fn, "dtype": dtype})
    (tmp / _MANIFEST).write_text(json.dumps(manifest))
    # fsync directory entries, then atomic publish
    for f in tmp.iterdir():
        fd = os.open(f, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


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


def restore(path: str | os.PathLike, like: Any, step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``like``: each tensor leaf comes back
    as a tensor on that leaf's device with its dtype (shapes must match),
    each other leaf as a numpy array. Returns ``(tree, step)``."""
    root = Path(path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / _MANIFEST).read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}
    leaves = {}
    for key, leaf in _flatten(like):
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(d / meta["file"])
        expect = getattr(leaf, "shape", None)
        if expect is not None and tuple(arr.shape) != tuple(expect):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(expect)}")
        if isinstance(leaf, torch.Tensor):
            t = torch.from_numpy(arr)
            if meta["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            arr = t.to(device=leaf.device, dtype=leaf.dtype)
        leaves[key] = arr
    return _unflatten(like, leaves), step


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

    def restore_latest(self, like: Any):
        return restore(self.root, like, None)
