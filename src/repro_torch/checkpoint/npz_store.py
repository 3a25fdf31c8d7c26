"""Crash-atomic npz checkpoints, in the reference's on-disk layout.

* **Layout.**  ``step_N/manifest.json`` (the step and, per leaf, its name,
  npz key, shape, type and whether it is stored as raw bytes) beside
  ``step_N/shard_0.npz``.  A leaf's name is its path in the tree joined
  by "/": a dict key (dicts in sorted key order), a list or tuple index,
  or ".field" for a NamedTuple field, as the reference names them; so a
  checkpoint written by either package loads in the other.  bf16 and fp8
  leaves, which npz cannot hold, are stored as their raw bytes.
* **Atomicity.**  A save writes ``step_N.tmp-<nonce>/``, fsyncs it, moves
  an existing ``step_N/`` aside, publishes with one ``os.rename`` and
  fsyncs the parent; ``latest_step`` only ever sees complete directories.
  Each ``faults.trip`` marks an instant a process can die in, and the
  fault tests kill a save there.
* **Devices.**  ``load_checkpoint`` places each leaf on its target's
  device, in its target's type.
* **Async.**  ``AsyncCheckpointer`` copies to host memory on the caller's
  thread and writes on a worker thread; an error of the worker is raised
  by ``wait()`` (from the future that ran it).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any

import numpy as np
import torch

from repro_torch.testing import faults

PyTree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_names(tree: PyTree, prefix: tuple = ()
                        ) -> list[tuple[str, Any]]:
    """(name, leaf) pairs in the reference's order: dict keys sorted,
    NamedTuple fields in order (named ".field"), list and tuple entries by
    index; None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, value in items:
        out += _flatten_with_names(value, prefix + (key,))
    return out


def _unflatten(tree: PyTree, leaves: dict, prefix: tuple = ()) -> PyTree:
    """``tree``'s structure with each leaf replaced by ``leaves[name]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       prefix + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


_RAW = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _to_host(leaf) -> tuple[np.ndarray, str, list, bool]:
    """``(array, type name, shape, raw)`` of a leaf; a bf16 or fp8 tensor
    comes as its raw bytes (``raw`` true)."""
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype), list(arr.shape), False
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _RAW:
        raw = t.contiguous().view(torch.uint8).numpy().reshape(-1)
        return raw, name, list(t.shape), True
    return t.numpy(), name, list(t.shape), False


def save_checkpoint(directory: str, step: int, tree: PyTree) -> str:
    """Atomic synchronous save; returns the final checkpoint path.

    Crash discipline, a ``faults.trip`` at each window a process can die
    in (the latest complete checkpoint must still load after any of them):

    1. the payload is written under ``step_N.tmp-<nonce>/`` and fsynced
       (files, then the tmp directory): a crash leaves only a tmp
       directory, which ``latest_step`` never matches;
    2. an existing ``step_N/`` is moved aside (renamed, not deleted), so
       a crash before the publish keeps the old copy;
    3. one ``os.rename(tmp, final)`` publishes; the parent directory is
       fsynced so the publish survives power loss;
    4. only then are the old copy and stale tmp directories removed.
    """
    os.makedirs(directory, exist_ok=True)
    nonce = uuid.uuid4().hex[:8]
    tmp = os.path.join(directory, f"step_{step}.tmp-{nonce}")
    os.makedirs(tmp)
    arrays = {}
    manifest = {"step": step, "leaves": []}
    for name, leaf in _flatten_with_names(tree):
        arr, dtype, shape, raw = _to_host(leaf)
        key = f"a{len(arrays)}"
        arrays[key] = arr
        manifest["leaves"].append({"name": name, "key": key,
                                   "shape": shape, "dtype": dtype,
                                   "raw": raw})
    shard = os.path.join(tmp, "shard_0.npz")
    np.savez(shard, **arrays)
    faults.trip("checkpoint.mid_write")
    mani = os.path.join(tmp, "manifest.json")
    with open(mani, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_file(shard)
    _fsync_dir(tmp)
    faults.trip("checkpoint.after_write")
    final = os.path.join(directory, f"step_{step}")
    aside = None
    if os.path.exists(final):
        aside = os.path.join(directory, f"step_{step}.tmp-old-{nonce}")
        os.rename(final, aside)
        faults.trip("checkpoint.between_renames")
    os.rename(tmp, final)
    _fsync_dir(directory)
    faults.trip("checkpoint.after_publish")
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    # Stale tmp directories of crashed saves (ours are gone already).
    for d in os.listdir(directory):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"checkpoint leaf type {name!r} has no torch type")
    return dt


def load_checkpoint(directory: str, step: int, target: PyTree) -> PyTree:
    """Restore into ``target``'s structure: each leaf of ``target`` (a
    tensor, or anything with ``shape``, ``dtype`` and ``device``) names
    the shape the stored leaf must have and the type and device it is
    placed in."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    stored = {}
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        for leaf in manifest["leaves"]:
            arr = data[leaf["key"]]
            if leaf.get("raw"):
                t = torch.from_numpy(arr.copy()).view(
                    _torch_dtype(leaf["dtype"])).reshape(leaf["shape"])
            else:
                t = torch.from_numpy(np.array(arr))
            stored[leaf["name"]] = t
    out = {}
    for name, tgt in _flatten_with_names(target):
        if name not in stored:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        t = stored[name]
        if tuple(t.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(t.shape)} vs {tuple(tgt.shape)}")
        out[name] = t.to(device=tgt.device, dtype=tgt.dtype)
    return _unflatten(target, out)


class AsyncCheckpointer:
    """Snapshot to host memory on the call, write on a worker thread.

    Each save is a future of a one-thread executor, so saves land in call
    order; ``wait()`` reads every pending future, which raises the first
    error a save met (an injected fault included)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: list[Future] = []

    def _save(self, step: int, host_tree: PyTree) -> None:
        save_checkpoint(self.directory, step, host_tree)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := _STEP_RE.match(d)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def save(self, step: int, tree: PyTree) -> None:
        host = _unflatten(tree, {
            name: (leaf.detach().to("cpu", copy=True)
                   if torch.is_tensor(leaf) else np.array(leaf))
            for name, leaf in _flatten_with_names(tree)})
        self._pending.append(self._pool.submit(self._save, step, host))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        futures_wait(pending)
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown(wait=True)
