"""Checkpoint / resume (port of ``tpu_ac.utils.checkpoint``), in
``tpu_ac``'s on-disk format, so a checkpoint either package wrote resumes
in the other.

``<directory>/<name>-<step:08d>/`` holds ``arrays.npz`` (``leaf_i`` for
each leaf of the state, in the order ``jax.tree.flatten`` gives it) and
``meta.json`` (``step``, ``n_leaves``, ``dtypes``, ``extra``).  Writes go
through a temp dir and an atomic rename; a same-step overwrite parks the
old copy as ``.prev`` first.

The leaf order is computed here in plain Python (``tree_flatten``), with
JAX's rules for the containers a train state is made of: a dict's values
in sorted key order, a tuple's or a NamedTuple's fields in order, None as
no leaf; anything else is a leaf.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch


def tree_flatten(tree) -> list:
    """Leaves of ``tree`` in ``jax.tree.flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_flatten(v)]
    return [tree]


def tree_unflatten(template, leaves: list):
    """``template``'s structure with its leaves replaced, in
    ``tree_flatten`` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            rebuilt = {k: build(t[k]) for k in sorted(t)}
            return {k: rebuilt[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[build(v) for v in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """(array to store, true dtype name).  npz has no bfloat16: such a leaf
    is stored as its uint16 bit view, as ``tpu_ac`` stores ml_dtypes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    a = np.asarray(x)
    name = a.dtype.name
    if a.dtype.kind == "V" or not a.dtype.isbuiltin:
        a = a.view(np.dtype(f"u{a.dtype.itemsize}"))
    return a, name


def save_checkpoint(directory: str, name: str, state, *, step: int = 0,
                    extra: dict | None = None, keep: int | None = None
                    ) -> str:
    """Save ``state`` atomically as ``<directory>/<name>-<step>``; with
    ``keep``, delete all but the ``keep`` newest of ``name``.  Returns the
    checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}-{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes = {}, []
    for i, leaf in enumerate(tree_flatten(state)):
        arrays[f"leaf_{i}"], dtype = _to_numpy(leaf)
        dtypes.append(dtype)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(arrays),
                   "dtypes": dtypes, "extra": extra or {}}, f)
    if os.path.exists(path):
        # same-step overwrite: park the old good checkpoint aside first, so
        # a preemption between the renames leaves one recoverable copy
        prev = path + ".prev"
        if os.path.exists(prev):
            shutil.rmtree(prev)
        os.rename(path, prev)
        os.rename(tmp, path)
        shutil.rmtree(prev)
    else:
        os.rename(tmp, path)
    if keep is not None:
        for _step, old in _list_checkpoints(directory, name)[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    return path


def _list_checkpoints(directory: str, name: str) -> list[tuple[int, str]]:
    if not os.path.isdir(directory):
        return []
    pat = re.compile(rf"^{re.escape(name)}-(\d+)(\.prev)?$")
    bare: dict[int, str] = {}
    prev: dict[int, str] = {}
    for entry in os.listdir(directory):
        m = pat.match(entry)
        if m:
            dst = prev if m.group(2) else bare
            dst[int(m.group(1))] = os.path.join(directory, entry)
    # '.prev' counts only where an overwrite was cut before the new
    # directory landed (the bare entry wins otherwise)
    return sorted({**prev, **bare}.items())


def latest_checkpoint(directory: str, name: str) -> str | None:
    """Most recent checkpoint path, or None."""
    ckpts = _list_checkpoints(directory, name)
    return ckpts[-1][1] if ckpts else None


def _leaf_like(a: np.ndarray, dtype_name: str | None, tmpl):
    if isinstance(tmpl, torch.Tensor):
        if dtype_name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            if dtype_name is not None and a.dtype != np.dtype(dtype_name):
                a = a.view(np.dtype(dtype_name))
            t = torch.from_numpy(np.array(a))
        return t.to(tmpl.device)
    if dtype_name is not None and dtype_name != "bfloat16" \
            and a.dtype != np.dtype(dtype_name):
        a = a.view(np.dtype(dtype_name))
    return a


def restore_checkpoint(path: str, template):
    """Restore a checkpoint into the structure of ``template``: tensor
    leaves come back as tensors on the template leaf's device, other
    leaves as numpy arrays.  Returns (state, meta)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tmpl_leaves = tree_flatten(template)
    if len(tmpl_leaves) != meta["n_leaves"]:
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, template has "
            f"{len(tmpl_leaves)}: structure mismatch")
    dtypes = meta.get("dtypes")
    restored = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, tmpl in enumerate(tmpl_leaves):
            a = data[f"leaf_{i}"]
            shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") \
                else np.shape(tmpl)
            if shape != a.shape:
                raise ValueError(
                    f"checkpoint leaf {i} has shape {a.shape}, template "
                    f"expects {shape}: structure mismatch")
            restored.append(_leaf_like(
                a, dtypes[i] if dtypes is not None else None, tmpl))
    return tree_unflatten(template, restored), meta
