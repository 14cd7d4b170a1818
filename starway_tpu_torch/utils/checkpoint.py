"""Checkpoint / resume for parameter and optimizer trees (npz backend).

The layout is the JAX package's npz backend: a directory holding
``leaves.npz`` (leaf ``i`` under the key ``"i"``) and ``manifest.json``
(``{"backend": "npz", "n": ..., "leaves": [{"shape", "dtype"}, ...]}``),
the manifest written last and atomically, so its presence marks a complete
checkpoint.  Leaves are numbered in JAX's flatten order (utils/tree.py:
dict keys sorted), so a float32 tree written by either package restores
in the other.  Restore validates the leaf count and shapes against the
manifest and casts each leaf to the dtype and device of the caller's
``like`` tree.

bfloat16 leaves: numpy has no bfloat16 of its own, so the port writes a
bfloat16 leaf widened to float32 (exact) and records ``"bfloat16"`` in the
manifest; restoring it into a bfloat16 ``like`` leaf gives back the same
bits.  A bfloat16 leaf written by the JAX package (2-byte records that
numpy reads as raw ``V2``) is read bit for bit.  The JAX package's orbax
backend is not read here: restoring an orbax checkpoint raises.

>>> save_pytree("/ckpt/step1000", {"params": params, "opt": opt_state})
>>> restored = restore_pytree("/ckpt/step1000",
...                           like={"params": params, "opt": opt_state})
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .tree import tree_leaves, tree_unflatten

_MANIFEST = "manifest.json"


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: Any) -> str:
    """Persist a tree of tensors (or arrays, or Python numbers); returns
    the backend used, always ``"npz"``."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree)
    np.savez(p / "leaves.npz",
             **{str(i): _to_numpy(x) for i, x in enumerate(leaves)})
    tmp = p / (_MANIFEST + ".tmp")
    tmp.write_text(json.dumps({
        "backend": "npz", "n": len(leaves),
        "leaves": [{"shape": list(np.shape(x)), "dtype": _dtype_name(x)}
                   for x in leaves]}))
    os.replace(tmp, p / _MANIFEST)
    return "npz"


def _validate(manifest: dict, leaves, path: Path) -> None:
    if manifest.get("n") != len(leaves):
        raise ValueError(
            f"checkpoint {path}: structure mismatch -- holds "
            f"{manifest.get('n')} leaves, 'like' tree has {len(leaves)}")
    for i, (spec, leaf) in enumerate(zip(manifest.get("leaves") or [],
                                         leaves)):
        want, got = tuple(spec["shape"]), tuple(np.shape(leaf))
        if want != got:
            raise ValueError(
                f"checkpoint {path}: leaf {i} shape mismatch -- checkpoint "
                f"has {want}, 'like' tree has {got}")


def _tensor(a: np.ndarray, saved_dtype) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        if saved_dtype != "bfloat16":
            raise ValueError(f"2-byte raw leaf recorded as {saved_dtype}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def restore_pytree(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_pytree` (of either package),
    shaped like ``like``: each tensor leaf takes its ``like`` leaf's dtype
    and device; other leaves come back as numpy arrays."""
    p = Path(path)
    leaves = tree_leaves(like)
    mf_path = p / _MANIFEST
    if mf_path.exists():
        manifest = json.loads(mf_path.read_text())
        _validate(manifest, leaves, p)
        backend = manifest["backend"]
    else:  # a manifest-less checkpoint: npz marker file or orbax directory
        manifest = {}
        backend = "npz" if (p / "leaves.npz").exists() else "orbax"
    if backend != "npz":
        raise RuntimeError(
            f"checkpoint {p} was written by the {backend} backend; the port "
            f"reads npz checkpoints only (orbax is not ported, ROADMAP.md "
            f"Queue 1 item 12)")
    specs = manifest.get("leaves") or [{}] * len(leaves)
    with np.load(p / "leaves.npz") as data:
        if len(data.files) != len(leaves):
            raise ValueError(f"checkpoint {p}: holds {len(data.files)} "
                             f"leaves, 'like' tree has {len(leaves)}")
        restored = []
        for i, leaf in enumerate(leaves):
            a = data[str(i)]
            if isinstance(leaf, torch.Tensor):
                t = _tensor(a, specs[i].get("dtype"))
                restored.append(t.to(device=leaf.device, dtype=leaf.dtype))
            else:
                restored.append(a)
    return tree_unflatten(like, restored)
