"""Checkpoint / resume for long-running fits (counterpart of
:mod:`tame.io.checkpoint`, in the same on-disk layout, so either package
reads the other's checkpoints).

* native path: every array goes through the C++ tamestore
  (``tame_torch/io/cstore.cpp``): streaming write, CRC32 integrity, no
  Python object serialization; everything else in a JSON manifest;
* fallback path: numpy ``.npy`` files when no C++ toolchain exists (the
  manifest's ``format`` says which was written).

Tensors leave the device by ``.detach().cpu().numpy()``.  A checkpoint is
atomic: written to ``<dir>.tmp``, then renamed.  The JAX package's orbax
bridge (``save_orbax``/``load_orbax``) has no counterpart here.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from tame_torch.io import native


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(ckpt_dir: str | Path, state: Dict[str, Any]) -> Path:
    """Save a (possibly nested) dict of tensors, arrays and JSON-able
    scalars: arrays land in per-tensor native store files (or ``.npy``),
    everything else in ``manifest.json``.  The write is atomic."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    use_native = native.available()
    manifest = {"format": "tamestore" if use_native else "npy",
                "tensors": {}, "scalars": {}}
    for key, value in _flatten(state).items():
        if isinstance(value, (torch.Tensor, np.ndarray)):
            arr = (value.detach().cpu().numpy()
                   if isinstance(value, torch.Tensor) else value)
            fname = key.replace("/", "__") + (
                ".tame" if use_native else ".npy")
            if use_native:
                native.write_tensor(tmp / fname, arr)
            else:
                np.save(tmp / fname, arr)
            manifest["tensors"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype)}
        else:
            manifest["scalars"][key] = value
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)

    if ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    tmp.rename(ckpt_dir)
    return ckpt_dir


def load_checkpoint(ckpt_dir: str | Path) -> Dict[str, Any]:
    """Load a checkpoint written by :func:`save_checkpoint` (or by
    ``tame.io.save_checkpoint``): arrays come back as numpy arrays."""
    ckpt_dir = Path(ckpt_dir)
    with open(ckpt_dir / "manifest.json") as f:
        manifest = json.load(f)
    flat: Dict[str, Any] = dict(manifest["scalars"])
    for key, meta in manifest["tensors"].items():
        path = ckpt_dir / meta["file"]
        if manifest["format"] == "tamestore":
            flat[key] = native.read_tensor(path)
        else:
            flat[key] = np.load(path)
    return _unflatten(flat)
