"""Checkpoint / resume of MPC runs (port of
``dlp_admm_tpu/utils/checkpoint.py``).

A planner's MPC carry (the state, the warm starts, the exchange state) is
the checkpoint unit. The file is the JAX package's: ``.npz`` with the
carry's leaves as ``leaf_{i}`` and the step as ``__step__``, written to a
temporary file and moved into place, and a ``.tree`` sidecar holding the
leaf count and the structure string. The carry is flattened as
``jax.tree.flatten`` flattens it (tuples, lists and named tuples in field
order, dicts by sorted key, ``None`` as an empty node), and the structure
string is written as JAX writes it, so leaf ``i`` of a file of this package
is leaf ``i`` of the JAX package's file for the same carry, and either
package's ``load_carry`` reads the other's files.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves``; return its structure string
    in ``jax.tree_util.PyTreeDef``'s notation."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        kids = ", ".join(_flatten(x, leaves) for x in tree)
        return f"CustomNode(namedtuple[{type(tree).__name__}], [{kids}])"
    if isinstance(tree, tuple):
        kids = [_flatten(x, leaves) for x in tree]
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_flatten(x, leaves) for x in tree) + "]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    leaves.append(tree)
    return "*"


def flatten(tree) -> tuple[list, str]:
    """``(leaves, structure)`` of a carry, as ``jax.tree.flatten`` orders
    the leaves and ``str`` of its tree definition reads."""
    leaves: list = []
    return leaves, f"PyTreeDef({_flatten(tree, leaves)})"


def _unflatten(like, it):
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, it) for x in like))
    if isinstance(like, tuple):
        return tuple(_unflatten(x, it) for x in like)
    if isinstance(like, list):
        return [_unflatten(x, it) for x in like]
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(it)


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_carry(path: str, carry, step: int) -> None:
    """Save a carry (tensors in tuples, lists, dicts and named tuples) and
    the step counter to ``path`` (.npz)."""
    leaves, structure = flatten(carry)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    arrays["__step__"] = np.asarray(step)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    with open(path + ".tree", "w") as f:
        json.dump(dict(n_leaves=len(leaves), treedef=structure), f)


def load_carry(path: str, like):
    """Restore a carry saved by :func:`save_carry`; returns ``(carry,
    step)``.

    ``like`` is a carry of the same structure (e.g. a freshly initialized
    one). Each leaf comes back with the dtype of ``like``'s leaf and, for a
    tensor, on its device, so a run resumed on the card continues there.
    The saved leaf count, structure and every leaf shape are checked
    against ``like``: a checkpoint of another carry or planner
    configuration fails here, not downstream.
    """
    data = np.load(path)
    like_leaves, structure = flatten(like)
    if os.path.exists(path + ".tree"):
        with open(path + ".tree") as f:
            saved = json.load(f)
        if saved["n_leaves"] != len(like_leaves):
            raise ValueError(
                f"checkpoint {path} has {saved['n_leaves']} leaves, "
                f"expected {len(like_leaves)}: saved from a different carry")
        if saved["treedef"] != structure:
            raise ValueError(
                f"checkpoint {path} treedef mismatch:\n"
                f"  saved:    {saved['treedef']}\n"
                f"  expected: {structure}")
    leaves = []
    for i, ref in enumerate(like_leaves):
        arr = data[f"leaf_{i}"]
        want = getattr(ref, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(
                f"checkpoint {path} leaf {i} shape {arr.shape} != expected "
                f"{tuple(want)}: saved from a different planner config")
        if torch.is_tensor(ref):
            leaves.append(torch.as_tensor(arr, dtype=ref.dtype,
                                          device=ref.device))
        else:
            leaves.append(torch.as_tensor(np.asarray(
                arr, getattr(ref, "dtype", None))))
    step = int(data["__step__"])
    return _unflatten(like, iter(leaves)), step


def resume_carry(path: Optional[str], resume: bool, like):
    """``(carry, first step)`` of a run: the carry saved at ``path`` and its
    step where ``resume`` is set and the file exists, else ``(like, 0)``."""
    if path is not None and resume and os.path.exists(path):
        return load_carry(path, like)
    return like, 0
