"""Checkpointing of solver state.

Counterpart of ``etol_tpu/io/checkpoint.py``. A :class:`SolveResult`, a
:class:`VGPData` batch, a warm-start tuple or any other tree of
dataclasses, dicts, lists and tuples with tensors (or numpy arrays and
numbers) at its leaves round-trips through one ``.npz`` file keyed by
the leaves' field paths, as the JAX package's ``.npz`` branch writes it.
Loading takes a template tree ``like`` of the same structure and puts
each tensor back in the template leaf's dtype and on its device.

The JAX package writes an orbax checkpoint directory when the path does
not end in ``.npz``; orbax checkpoints JAX arrays, and the port has no
counterpart of it: such a path raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.problem import (tree_flatten, tree_flatten_with_paths,
                            tree_unflatten)
from ..core.trajectory import to_host


def _require_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise ValueError(
            f"{path!r}: the port checkpoints to one .npz file; the JAX "
            "package's orbax directory checkpoints have no PyTorch "
            "counterpart here")


def _restore(value: np.ndarray, like: Any) -> Any:
    """A saved leaf in the kind of the template's leaf."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(value, dtype=like.dtype, device=like.device)
    if isinstance(like, (bool, int, float)):
        return type(like)(value.item())
    return value


def save_checkpoint(path: str, tree: Any) -> str:
    """Save a tree to ``path`` (a ``.npz`` file), one array per leaf
    under the key ``leaf<i>|<field path>``. Returns ``path``."""
    _require_npz(path)
    np.savez(path, **{
        f"leaf{i}|{key}": to_host(leaf)
        for i, (key, leaf) in enumerate(tree_flatten_with_paths(tree))})
    return path


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_checkpoint`. ``like`` is a
    tree of the same structure (the tree before saving, or one made for
    the device and dtype wanted); a leaf that is a tensor in ``like``
    comes back a tensor of its dtype on its device."""
    _require_npz(path)
    with np.load(path) as data:
        items = sorted(data.items(),
                       key=lambda kv: int(kv[0].split("|", 1)[0][4:]))
    want = [key for key, _ in tree_flatten_with_paths(like)]
    have = [k.split("|", 1)[1] for k, _ in items]
    if have != want:
        raise ValueError(
            f"{path!r} holds the leaves {have}, the template {want}")
    return tree_unflatten(like, [
        _restore(v, leaf)
        for (_, v), leaf in zip(items, tree_flatten(like))])
