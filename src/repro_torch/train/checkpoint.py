"""Atomic, content-addressed checkpointing with async writes, keep-k
retention and logical restore — the JAX package's
``repro/train/checkpoint.py`` on tensors, with its on-disk layout::

    <dir>/step_000000123.tmp-<pid>/   # staged write
    <dir>/step_000000123/             # atomic rename when complete
        manifest.json                 # keys, shapes, dtypes, hashes
        leaf_00000.npy ...            # one file per leaf

A tree is a nested structure of mappings and named tuples (an
:class:`~repro_torch.train.optimizer.OptState`), with tensors or numpy
arrays at its leaves; an ``nn.Module`` in it stands for its
``state_dict()``.  A leaf's key is the ``/``-joined path of names to
it, so the train state ``{"params": model, "opt": opt_state}`` has keys
``params/layers.0.attn.wq.w`` and ``opt/mu/layers.0.attn.wq.w``.

A bf16 leaf is written as its 2-byte words (numpy's ``V2``, which is what
``np.save`` writes for the JAX package's ``ml_dtypes.bfloat16`` arrays),
with ``"dtype": "bfloat16"`` in the manifest, and its hash is over the
same bytes JAX's ``arr.tobytes()`` hashes; nothing here needs
``ml_dtypes``.  Writes go through a tmp dir and ``os.rename`` (atomic on
POSIX), so a crash mid-write never corrupts the latest checkpoint;
:func:`latest_step` ignores incomplete ``*.tmp-*`` dirs.  Restores are
logical: :func:`restore` puts each leaf on ``device`` (the leaf's own
device by default), :func:`restore_into` copies into the tensors of a
live tree in place.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Tree = Any


def _flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` in the tree's order."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = dict(zip(tree._fields, tree))
    if isinstance(tree, Mapping):
        out: List[Tuple[str, Any]] = []
        for k, v in tree.items():
            out += _flatten(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _unflatten(like: Tree, leaves: Dict[str, Any], prefix: str = "") -> Tree:
    """``like``'s structure with ``leaves[key]`` at each leaf (a module
    becomes its state dict)."""
    if isinstance(like, nn.Module):
        like = like.state_dict()
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves, f"{prefix}{k}/")
                            for k, v in zip(like._fields, like)))
    if isinstance(like, Mapping):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


def _host(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates of it cannot
    reach; bf16 as its 2-byte words (``V2``)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save(directory: str | Path, step: int, tree: Tree, *,
         keep: int = 3, asynchronous: bool = False
         ) -> "threading.Thread | Path":
    """Checkpoint ``tree`` at ``step``.  Returns the final path, or the
    writer thread when ``asynchronous``.  Every leaf is copied to host
    memory before this returns, in either mode: the optimizer updates the
    model in place, and a copy made later would hold a later step."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    keys = [k for k, _ in flat]
    host_leaves = [_host(leaf) for _, leaf in flat]   # snapshot now

    def _write() -> Path:
        final = directory / f"step_{step:09d}"
        tmp = directory / f"step_{step:09d}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        for i, (k, arr) in enumerate(zip(keys, host_leaves)):
            fn = f"leaf_{i:05d}.npy"
            np.save(tmp / fn, arr)
            manifest["leaves"].append({
                "key": k, "file": fn, "shape": list(arr.shape),
                "dtype": _dtype_name(arr), "sha256": _hash(arr)})
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                        # atomic commit
        _retain(directory, keep)
        return final

    if asynchronous:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    return _write()


def _retain(directory: Path, keep: int) -> None:
    steps = sorted(d for d in directory.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and ".tmp-" not in d.name)
    for d in steps[:-keep]:
        shutil.rmtree(d)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in directory.iterdir()
             if d.is_dir() and d.name.startswith("step_")
             and ".tmp-" not in d.name and (d / "manifest.json").exists()]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, entry: Dict[str, Any]) -> torch.Tensor:
    """The stored leaf as a tensor of its stored type."""
    if entry["dtype"] == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _load(directory: str | Path, step: int, like: Tree, verify: bool
          ) -> List[Tuple[str, Any, torch.Tensor]]:
    """``[(key, like's leaf, the stored leaf on the host)]``, each checked
    against its hash and ``like``'s shape."""
    path = Path(directory) / f"step_{step:09d}"
    manifest = json.loads((path / "manifest.json").read_text())
    by_key = {e["key"]: e for e in manifest["leaves"]}
    out = []
    for k, proto in _flatten(like):
        e = by_key[k]
        arr = np.load(path / e["file"])
        if verify:
            h = _hash(arr)
            if h != e["sha256"]:
                raise IOError(f"checkpoint leaf {k} corrupt: {h} != "
                              f"{e['sha256']}")
        if tuple(arr.shape) != tuple(proto.shape):
            raise ValueError(f"leaf {k}: shape {arr.shape} != "
                             f"{tuple(proto.shape)}")
        out.append((k, proto, _tensor(arr, e)))
    return out


def _dtype(proto: Any) -> torch.dtype:
    if isinstance(proto, torch.Tensor):
        return proto.dtype
    return torch.from_numpy(np.zeros((), np.asarray(proto).dtype)).dtype


def restore(directory: str | Path, step: int, like: Tree, *,
            device=None, verify: bool = True) -> Tree:
    """Load step ``step`` into the structure of ``like`` (a tree of
    tensors or numpy arrays, of which only shapes and types are read):
    each leaf a tensor of its ``like`` leaf's type on ``device``, or on
    the ``like`` leaf's device when ``device`` is None (the CPU for a
    numpy leaf)."""
    leaves = {}
    for k, proto, t in _load(directory, step, like, verify):
        dev = device if device is not None else getattr(proto, "device",
                                                         "cpu")
        leaves[k] = t.to(device=dev, dtype=_dtype(proto))
    return _unflatten(like, leaves)


@torch.no_grad()
def restore_into(directory: str | Path, step: int, tree: Tree, *,
                 verify: bool = True) -> Tree:
    """Load step ``step`` into the tensors of ``tree`` in place (each
    leaf checked before any is written); returns ``tree``."""
    loaded = _load(directory, step, tree, verify)
    for _, proto, t in loaded:
        proto.copy_(t)
    return tree
