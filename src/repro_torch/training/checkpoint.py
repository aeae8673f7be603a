"""Fault-tolerant checkpointing: atomic, self-validating, and in the JAX
package's on-disk format, so a checkpoint either package writes, the other
restores.

Layout of a checkpoint directory:

    <dir>/step_000123/            (written as .tmp_step_000123, then renamed)
        manifest.json             leaf paths, keys, shapes, logical dtypes,
                                  step, config fingerprint, leaf checksums
        arrays.npz                leaves (bf16 stored as uint16 views)

Leaves are saved from whatever device they are on and restored as tensors
on the device asked for.  ``latest_step`` skips corrupt or partial
directories, so a job killed mid-save resumes from the previous valid
checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "prune"]

_BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    out[prefix] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as stored, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    """The byte sum the JAX package stores.  Its code takes
    ``arr.view(np.uint8)``, which numpy refuses for a 0-d array (the 8-bit
    AdamW state's scale of each 1-D leaf); the flattened array has the same
    bytes, so the checksum is equal wherever the JAX package can compute
    one."""
    return int(np.uint64(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).sum()))


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         fingerprint: str = "") -> str:
    """Atomic save of ``tree`` (nested dicts of tensors or arrays)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, f".tmp_{name}")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays, meta = {}, {}
    for path, leaf in _flatten(tree).items():
        arr, logical = _to_numpy(leaf)
        key = hashlib.sha1(path.encode()).hexdigest()[:16]
        arrays[key] = arr
        meta[path] = {"key": key, "dtype": logical, "shape": list(arr.shape),
                      "crc": _crc(arr)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "leaves": meta, "extra": extra or {},
                "fingerprint": fingerprint, "version": 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _valid(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            json.load(f)
    except (OSError, ValueError):
        return False
    return os.path.exists(os.path.join(path, "arrays.npz"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and _valid(os.path.join(ckpt_dir, d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, fingerprint: str = "",
            device="cpu") -> Tuple[Any, dict, int]:
    """Returns (tree of tensors on ``device``, extra, step).  Validates the
    checksums and the fingerprint."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if fingerprint and manifest["fingerprint"] and \
            manifest["fingerprint"] != fingerprint:
        raise ValueError("checkpoint fingerprint mismatch: "
                         f"{manifest['fingerprint']} != {fingerprint}")
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        for leaf_path, m in manifest["leaves"].items():
            arr = npz[m["key"]]
            if _crc(arr) != m["crc"]:
                raise ValueError(f"checksum mismatch for {leaf_path}")
            if m["dtype"] == _BF16:
                t = torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.tensor(arr)
            flat[leaf_path] = t.to(device)
    return _unflatten(flat), manifest["extra"], manifest["step"]


def prune(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
