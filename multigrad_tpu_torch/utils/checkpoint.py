"""Checkpoint / resume for long fits (port of
:mod:`multigrad_tpu.utils.checkpoint`).

:func:`save` and :func:`load` keep a tree (dicts, lists, tuples) of
tensors, numpy arrays and Python scalars in one ``.npz`` of its
flattened leaves, in the JAX package's layout: ``leaf_<i>`` in the order
of a flatten with sorted dict keys, and the format metadata bundled
inside the archive, so the tmp-write and ``os.replace`` is the whole
commit and a preemption never leaves the data and its metadata out of
step.  Archives of the same tree structure read in either package.

The JAX package's ``OrbaxCheckpointer`` (async multi-host checkpoints
through ``orbax.checkpoint``) has no counterpart here: with one process
per shard, process 0 writes the archive and every process reads it.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

#: Archive layout version; :func:`load` rejects any other.
FORMAT_VERSION = 1


def _flatten(tree):
    """The leaves of ``tree`` in order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure filled from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(item, leaves) for item in like)
    return next(leaves)


def _restore(arr: np.ndarray, like):
    """A saved leaf as the type of ``like``'s leaf: a tensor on its device
    and of its dtype, a Python scalar, or a numpy array."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr.item())
    return arr


def save(path: str, tree: Any) -> None:
    """Save ``tree`` to ``path`` (one ``.npz``, written to a temporary
    file and moved into place)."""
    leaves = _flatten(tree)
    arrays = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arrays[f"leaf_{i}"] = np.asarray(leaf)
    arrays["__meta__"] = np.frombuffer(json.dumps(
        {"version": FORMAT_VERSION, "n": len(leaves),
         "is_key": []}).encode(), dtype=np.uint8)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, final)


def load(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save`; ``like`` gives the structure
    and each leaf's type (e.g. a freshly initialised state)."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz_path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        version = meta.get("version", 1)
        if version != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {npz_path!r} has format version {version!r}; "
                f"this build reads version {FORMAT_VERSION}. Re-save the "
                "checkpoint with the current library (or load it with the "
                "version that wrote it).")
        if meta.get("is_key"):
            raise ValueError(
                f"checkpoint {npz_path!r} holds JAX PRNG keys, which have "
                "no counterpart here (keys are integer seeds)")
        like_leaves = _flatten(like)
        if len(like_leaves) != meta["n"]:
            raise ValueError(
                f"checkpoint {npz_path!r} holds {meta['n']} pytree leaves "
                f"but `like` has {len(like_leaves)}: the checkpoint was "
                "written for a different state structure (e.g. different "
                "optimizer or parameter count).")
        restored = [_restore(data[f"leaf_{i}"], leaf)
                    for i, leaf in enumerate(like_leaves)]
    return _unflatten(like, iter(restored))
