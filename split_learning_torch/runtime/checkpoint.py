"""Checkpoint / resume.

Port of the JAX package's ``runtime/checkpoint.py``.  The port stores its
own format: ``torch.save`` of ``{"params": state tree, "batch_stats":
..., "meta": {"round_idx": n}}`` with every tensor on the CPU, in
``state.pt`` inside the checkpoint directory (the JAX package writes an
orbax tree; the two formats are not interchangeable — carry weights
across with :mod:`split_learning_torch.convert`).

Crash atomicity is the reference's: a save never touches the live
checkpoint.  The tree is written to a hidden slot directory
(``.{name}.data0``/``.data1``, alternating) and published by atomically
replacing the ``{name}`` symlink.  A process killed at any point leaves
either the previous or the new complete checkpoint visible, and
:func:`load_checkpoint` treats an unreadable checkpoint as absent
(warn + ``None``).

A client's error-feedback residuals (the top-k and delta codecs) are a
sidecar beside it: :func:`save_sidecar` writes ``{name}.pt`` (a flat
``{key: tensor}`` dict, ``torch.save``) into the checkpoint directory
through a temporary file and an atomic rename, and :func:`load_sidecar`
reads it back (``None`` when absent or unreadable).
"""

from __future__ import annotations

import os
import pathlib
import shutil
import warnings
from typing import Any

import numpy as np
import torch

from split_learning_torch.convert import tree_to

_STATE = "state.pt"


def checkpoint_path(directory: str | pathlib.Path,
                    model_key: str) -> pathlib.Path:
    return pathlib.Path(directory).resolve() / model_key


def _publish(path: pathlib.Path, slot_name: str) -> None:
    """Atomically point the live ``path`` symlink at ``slot_name``."""
    staged = path.parent / f".{path.name}.lnk"
    try:
        staged.unlink()
    except FileNotFoundError:
        pass
    os.symlink(slot_name, staged)
    if path.exists() and not path.is_symlink():
        # a real directory where the link goes (not written by this
        # scheme) would make os.replace fail
        shutil.rmtree(path)
    os.replace(staged, path)


def save_checkpoint(directory: str | pathlib.Path, model_key: str,
                    params: Any, batch_stats: Any | None = None,
                    round_idx: int = 0) -> None:
    path = checkpoint_path(directory, model_key)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = {"params": tree_to(params, "cpu"),
            "batch_stats": tree_to(batch_stats or {}, "cpu"),
            "meta": {"round_idx": int(round_idx)}}
    # write into the slot NOT currently live, then flip the symlink
    live = os.readlink(path) if path.is_symlink() else None
    slot_name = (f".{model_key}.data1"
                 if live == f".{model_key}.data0"
                 else f".{model_key}.data0")
    tmp = path.parent / f".{model_key}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(tree, tmp / _STATE)
    final = path.parent / slot_name
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    _publish(path, slot_name)


def load_checkpoint(directory: str | pathlib.Path,
                    model_key: str) -> dict | None:
    """Returns {params, batch_stats, round_idx} with CPU tensors, or None
    when the checkpoint is absent OR unreadable (a corrupt checkpoint
    warns and is treated as no checkpoint)."""
    path = checkpoint_path(directory, model_key)
    if not path.exists():   # dangling symlink also reads as absent
        return None
    try:
        tree = torch.load(path / _STATE, map_location="cpu",
                          weights_only=True)
        return {"params": tree["params"],
                "batch_stats": tree.get("batch_stats") or {},
                "round_idx": int(tree["meta"]["round_idx"])}
    except Exception as e:  # noqa: BLE001 — any torn/corrupt state
        warnings.warn(
            f"checkpoint at {path} is unreadable ({type(e).__name__}: "
            f"{e}); ignoring it and starting fresh", RuntimeWarning,
            stacklevel=2)
        return None


def _sidecar_path(directory: str | pathlib.Path,
                  name: str) -> pathlib.Path:
    return pathlib.Path(directory).resolve() / f"{name}.pt"


def save_sidecar(directory: str | pathlib.Path, name: str,
                 arrays: dict) -> None:
    """Write a flat ``{key: tensor or array}`` dict as ``{name}.pt`` in
    ``directory``, atomically (a reader sees the old file or the new
    one, never a torn one)."""
    path = _sidecar_path(directory, name)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v)))
             for k, v in arrays.items()}
    tmp = path.parent / f".{path.name}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_sidecar(directory: str | pathlib.Path,
                 name: str) -> dict | None:
    """The dict :func:`save_sidecar` wrote (CPU tensors), or None when
    it is absent or unreadable (warned)."""
    path = _sidecar_path(directory, name)
    if not path.exists():
        return None
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 — any torn/corrupt state
        warnings.warn(f"sidecar {path} is unreadable "
                      f"({type(e).__name__}: {e}); ignoring it",
                      RuntimeWarning, stacklevel=2)
        return None
