"""Checkpoint store: atomic, async, checksummed — the reference's format.

Layout (one directory per step), byte for byte that of
``repro/checkpoint/store.py``, so each package reads the other's
checkpoints::

    <root>/step_000001230/
        manifest.json      # version 1: tree keys, shapes, dtypes, shard
                           # files, sha256 per file, step, wall time
        arr_00000.npy      # one file per leaf *shard*: a leaf over 1 MiB
        arr_00001.npy      #  is cut on axis 0 into ``nshards`` files
        ...

Leaf keys are the reference's pytree paths joined by ``"/"``: dict keys in
sorted order, list and tuple indices, a ``ProgramState``'s fields by their
index in field order, a named tuple's fields as ``.name``.  ``None`` is an
empty subtree.  Python ``str``/``bool``/``int``/``float`` leaves are
``"py"`` entries of the manifest; everything else is a tensor (or an array)
stored as ``.npy``.  Types numpy has no name for (bfloat16, the fp8 types)
are stored as raw bytes under their true dtype name and rebuilt with
``torch.frombuffer(...).view(dtype)`` (the reference rebuilds them with
``ml_dtypes``).

Guarantees: **atomicity** (written into ``<dir>.tmp``, then
``os.replace``\\ d; :func:`latest_step` only sees complete directories),
**integrity** (per-file SHA-256, checked by :func:`verify_checkpoint` and by
restore), **async** (:class:`CheckpointManager` copies every leaf to host
memory before it returns — a CUDA leaf with ``.cpu()``, a CPU tensor with a
copy, since the caller may write it in place — and writes on a daemon
thread), **retention** (the newest ``keep``).

Restore puts every array leaf on ``device`` (default: the card; raises
``RuntimeError`` without one).  The reference's elastic ``shardings=``
path, a placement over a device mesh, waits for sharded fleets (ROADMAP
A5) and raises ``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.state import ProgramState

_MANIFEST = "manifest.json"

#: torch dtypes numpy has no type for: stored as raw bytes, rebuilt by name
_RAW_DTYPES = {"bfloat16": torch.bfloat16,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}

# Leaves that are plain python values (a step counter, a bucket id, a flag)
# round-trip through the manifest itself ("py" entries), as the reference's
# do.
_PY_LEAF_TYPES = (str, bool, int, float)


def _is_py_leaf(leaf: Any) -> bool:
    return isinstance(leaf, _PY_LEAF_TYPES) and not isinstance(
        leaf, np.generic)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix, keys, leaves):
    if tree is None:
        return
    if isinstance(tree, ProgramState):
        items = [(str(i), tree[f]) for i, f in enumerate(tree.fields)]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        keys.append("/".join(prefix))
        leaves.append(tree)
        return
    for k, v in items:
        _flatten(v, prefix + [k], keys, leaves)


def _unflatten(tree, it):
    """Rebuild ``tree``'s structure with leaves taken from ``it`` in
    :func:`_flatten`'s order (dict keys sorted, as the reference's pytrees
    come back)."""
    if tree is None:
        return None
    if isinstance(tree, ProgramState):
        vals = [_unflatten(tree[f], it) for f in tree.fields]
        return ProgramState(dict(zip(tree.fields, vals)),
                            ensemble=tree.ensemble)
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*[_unflatten(v, it) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def _tree_paths(tree):
    """``(keys, leaves)`` of ``tree``: its leaves in the reference's pytree
    order and their ``"/"``-joined paths."""
    keys, leaves = [], []
    _flatten(tree, [], keys, leaves)
    return keys, leaves


def _to_host(leaf: Any):
    """Host snapshot of one leaf: a numpy array that shares nothing with
    the caller (a tensor of a raw dtype: its bytes, see :func:`_raw_name`);
    python scalars and strings pass through untouched."""
    if _is_py_leaf(leaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.cpu() if t.device.type != "cpu" else t.clone()
        name = _raw_name(t.dtype)
        if name is not None:
            return _RawLeaf(name, tuple(t.shape),
                            t.contiguous().view(torch.uint8).numpy())
        return t.numpy()
    return np.array(leaf, copy=True)


class _RawLeaf:
    """The bytes of a tensor whose dtype numpy cannot name."""

    __slots__ = ("dtype", "shape", "data")

    def __init__(self, dtype: str, shape: tuple, data: np.ndarray):
        self.dtype, self.shape, self.data = dtype, shape, data


def _raw_name(dtype: torch.dtype) -> str | None:
    for name, dt in _RAW_DTYPES.items():
        if dt == dtype:
            return name
    return None


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:012d}")


def _save_host(root: str, step: int, keys, host_leaves, extra,
               nshards: int) -> str:
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    entries = []
    fid = 0
    for key, arr in zip(keys, host_leaves):
        if _is_py_leaf(arr):
            entries.append({"key": key, "py": arr,
                            "pytype": type(arr).__name__, "files": []})
            continue
        if isinstance(arr, _RawLeaf):
            store, shape, dtype, raw = (np.ascontiguousarray(arr.data)
                                        .reshape(-1), list(arr.shape),
                                        arr.dtype, True)
        else:
            raw = arr.dtype.kind == "V" or arr.dtype.name not in np.sctypeDict
            store = (np.frombuffer(np.ascontiguousarray(arr).tobytes(),
                                   np.uint8) if raw else arr)
            shape, dtype = list(arr.shape), str(arr.dtype)
        # split big leaves across writer slots (per-host files at scale)
        n0 = store.shape[0] if store.ndim else 1
        cuts = min(nshards, n0) if store.ndim and \
            store.nbytes > (1 << 20) else 1
        bounds = np.linspace(0, n0, cuts + 1, dtype=int) if cuts > 1 else None
        files = []
        for s in range(cuts):
            part = store if cuts == 1 else store[bounds[s]:bounds[s + 1]]
            fname = f"arr_{fid:05d}.npy"
            fid += 1
            np.save(os.path.join(tmp, fname), part)
            files.append({"file": fname,
                          "sha256": _sha256(os.path.join(tmp, fname))})
        entries.append({"key": key, "shape": shape, "dtype": dtype,
                        "raw": bool(raw), "files": files})

    manifest = {
        "version": 1,
        "step": int(step),
        "time": time.time(),
        "extra": extra or {},
        "leaves": entries,
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_checkpoint(root: str, step: int, tree, *, extra: dict | None = None,
                    nshards: int = 4) -> str:
    """Synchronous atomic save.  Returns the final directory path."""
    keys, leaves = _tree_paths(tree)
    return _save_host(root, step, keys, [_to_host(leaf) for leaf in leaves],
                      extra, nshards)


def _load_manifest(path: str) -> dict:
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)


def verify_checkpoint(path: str) -> bool:
    """Whether the manifest at ``path`` loads and every file it names
    exists with its sha256."""
    try:
        man = _load_manifest(path)
    except (OSError, json.JSONDecodeError):
        return False
    for e in man["leaves"]:
        for fl in e.get("files", []):
            fp = os.path.join(path, fl["file"])
            if not os.path.exists(fp) or _sha256(fp) != fl["sha256"]:
                return False
    return True


def checkpoint_steps(root: str) -> list[int]:
    """All complete checkpoint steps under ``root``, oldest first.
    "Complete" = the directory has a manifest (atomic ``os.replace`` means a
    directory either fully exists or doesn't) — contents may still be
    damaged; pair with :func:`verify_checkpoint` to find the newest *valid*
    one."""
    if not os.path.isdir(root):
        return []
    return sorted(
        int(d[len("step_"):]) for d in os.listdir(root)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(root, d, _MANIFEST)))


def latest_step(root: str) -> Optional[int]:
    steps = checkpoint_steps(root)
    return steps[-1] if steps else None


def _leaf_tensor(path: str, e: dict, device) -> torch.Tensor:
    parts = [np.load(os.path.join(path, fl["file"])) for fl in e["files"]]
    arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    shape = list(e["shape"])
    if e.get("raw"):
        dt = _RAW_DTYPES.get(e["dtype"])
        if dt is None:
            raise IOError(f"leaf {e['key']!r}: raw dtype {e['dtype']!r} has "
                          f"no torch counterpart")
        t = torch.frombuffer(bytearray(arr.tobytes()),
                             dtype=torch.uint8).view(dt).reshape(shape)
    else:
        if list(arr.shape) != shape:
            raise IOError(f"shape mismatch for {e['key']}: {arr.shape} vs "
                          f"manifest")
        t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
    return t.to(device)


def restore_checkpoint(root: str, tree_like, *, step: Optional[int] = None,
                       shardings=None, verify: bool = True, device=None):
    """Restore into the structure of ``tree_like`` (shapes are taken from
    the manifest).  ``verify`` (default on) checks every shard's sha256
    against the manifest and raises ``IOError`` on a mismatch — pass
    ``verify=False`` only when the caller already verified (or wants a
    best-effort read of a known-damaged snapshot).  Array leaves come back
    as tensors on ``device`` (``None``: the card).  Returns ``(tree,
    manifest_extra, step)``."""
    from repro_torch.core.memory import _device

    if shardings is not None:
        raise NotImplementedError(
            "restore_checkpoint(shardings=): placing leaves over a device "
            "mesh waits for sharded fleets (ROADMAP A5); restore onto one "
            "device with device=")
    dev = _device(device)
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    path = _step_dir(root, step)
    if verify and not verify_checkpoint(path):
        raise IOError(f"checkpoint {path} failed integrity check")
    man = _load_manifest(path)
    by_key = {e["key"]: e for e in man["leaves"]}

    keys, _ = _tree_paths(tree_like)
    out = []
    for key in keys:
        e = by_key.get(key)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        # a python-scalar/str leaf: the manifest is its storage
        out.append(e["py"] if "py" in e else _leaf_tensor(path, e, dev))
    return _unflatten(tree_like, iter(out)), man.get("extra", {}), step


def _prune(root: str, keep: int):
    steps = checkpoint_steps(root)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


class CheckpointManager:
    """Async save orchestration + retention.

    ``save()`` copies every leaf to host memory before it returns (the only
    part that must see the state as it is now) and writes the files on a
    daemon thread; a failure there re-raises from the next ``wait()`` (or
    ``save()``).
    """

    def __init__(self, root: str, *, keep: int = 3, nshards: int = 4):
        self.root = root
        self.keep = keep
        self.nshards = nshards
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def save(self, step: int, tree, *, extra: dict | None = None,
             blocking: bool = False):
        self.wait()
        keys, leaves = _tree_paths(tree)
        host = [_to_host(leaf) for leaf in leaves]

        def work():
            try:
                _save_host(self.root, step, keys, host, extra, self.nshards)
                _prune(self.root, self.keep)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore_latest(self, tree_like, *, shardings=None, verify=True,
                       device=None):
        return restore_checkpoint(self.root, tree_like, shardings=shardings,
                                  verify=verify, device=device)
