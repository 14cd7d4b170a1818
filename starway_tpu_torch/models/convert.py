"""Parameter trees from numpy: the bridge that lets the port compute with
the same weights as any other holder of a Llama tree.

``params_from_numpy`` takes the stacked-layer tree as nested dicts of
numpy arrays (raw weights, W8A16 ``{"q", "s"}`` pairs, ``bq/bk/bv``
biases) and returns the same tree of torch tensors.  bfloat16 arrays (the
``ml_dtypes`` numpy extension type) are carried over bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: dict, device="cuda",
                      dtype: Optional[torch.dtype] = None,
                      requires_grad: bool = False) -> dict:
    """The torch tree of a numpy parameter tree, on ``device``.

    ``dtype`` casts the floating leaves (weights, norms, biases, the
    embedding); the int8 codes and the float32 scales of W8A16 pairs keep
    their types.  ``requires_grad`` marks those floating leaves as leaves
    of autograd, ready to train."""

    def walk(node, keep_types: bool):
        if isinstance(node, dict):
            quant = "q" in node and "s" in node
            return {k: walk(v, keep_types or quant) for k, v in node.items()}
        t = _tensor(node, device, None if keep_types else dtype)
        if requires_grad and not keep_types and t.is_floating_point():
            t.requires_grad_()
        return t

    return walk(tree, False)
