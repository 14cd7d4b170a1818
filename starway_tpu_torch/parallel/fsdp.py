"""ZeRO-style fully-sharded data parallelism over a mesh axis.

Port of the JAX package's ``parallel/fsdp.py``.  The JAX package shards
every parameter and its optimizer state with ``NamedSharding`` and lets
XLA insert the all-gather before each use and the reduce-scatter after
the backward.  The port keeps the same specs and writes the schedule out
(models/sharded.py): each slot of the mesh holds 1/N of every sharded
leaf, gathers a layer's weights over the axis just before their use, and
the gradient of that gather is the reduce-scatter, so every slot ends the
backward holding the summed gradient of its own shard only.

* :func:`fsdp_specs` maps a tree of tensors to ``P`` specs, sharding the
  largest divisible dimension of each leaf over ``axis`` (skipping dims a
  base spec already takes, e.g. llama's tp specs: the hybrid FSDP x TP
  layout).  Stacked-layer leaves ``[L, ...]`` (ndim >= 3) never shard the
  leading layer dim.
* The same rule applied to the optimizer state (``tx.init(params)``)
  shards Adam's mu/nu exactly like their parameters; :func:`shard_tree`
  of the parameters is enough for that, since ``tx.init`` of a sharded
  tree is sharded like it (utils/tree.py).
* :func:`make_fsdp_train_step` runs the ordinary train step
  (models/llama.py ``make_train_step``) on the sharded trees, the batch
  cut over ``axis`` (FSDP is still data parallelism).

Every slot sitting in one process (a mesh without a process group) saves
no memory: the process holds all N shards.  Split over processes, each
holds 1/N of the parameters and of mu/nu.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .sharding import P, shard_array, spec_axes


def _stacked_layer_rule(shape) -> int:
    """Dims to protect at the front: 1 for stacked-layer leaves (ndim >= 3,
    the [n_layers, ...] convention of models/), else 0."""
    return 1 if len(shape) >= 3 else 0


def _leaf_spec(shape, base, axis: str, n: int, skip: int) -> P:
    """Shard the largest dim of ``shape`` divisible by ``n`` over ``axis``,
    keeping any dims already sharded by ``base`` untouched."""
    entries = [None] * len(shape)
    if base is not None:
        for i, e in enumerate(base):
            if i < len(entries):
                entries[i] = e
    candidates = [(dim, i) for i, dim in enumerate(shape)
                  if entries[i] is None and i >= skip and dim % n == 0
                  and dim >= n]
    if candidates:
        _, i = max(candidates)
        entries[i] = axis
    return P(*entries)


def fsdp_specs(tree, mesh, *, axis: str = "fsdp", base_specs=None,
               skip_leading: Union[int, Callable] = _stacked_layer_rule):
    """A ``P`` tree sharding each leaf's largest free dim over ``axis``.

    ``tree`` holds tensors (or anything with a ``shape``: the optimizer
    state of ``tx.init`` too).  ``base_specs`` (the tree's structure, e.g.
    llama's ``param_specs``) pins dims that keep their sharding; pass it
    only when ``axis`` shares one mesh with those axes.  Leaves with no
    dim divisible by the axis size stay replicated (scalars, odd-sized
    norms).  ``skip_leading`` protects leading dims: an int, or a callable
    ``shape -> int`` (default: the stacked-layer dim of ndim >= 3
    leaves)."""
    n = mesh.shape[axis]
    skip_fn = skip_leading if callable(skip_leading) else (
        lambda _s: skip_leading)
    leaves = tree_leaves(tree)
    base_leaves = None
    if base_specs is not None:
        base_leaves = tree_leaves(base_specs)
        if len(base_leaves) != len(leaves):
            raise ValueError(f"base_specs has {len(base_leaves)} leaves, "
                             f"tree has {len(leaves)}")
    specs = []
    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape)
        if not shape:
            specs.append(P())
            continue
        base = base_leaves[i] if base_leaves is not None else None
        skip = min(skip_fn(shape), len(shape) - 1)
        specs.append(_leaf_spec(shape, base, axis, n, skip))
    return tree_unflatten(tree, specs)


def shard_tree(tree, mesh, specs):
    """``shard_array`` of every leaf onto its spec (each process keeps the
    boxes of its slots)."""
    flat = tree_leaves(tree)
    spec_flat = tree_leaves(specs)  # a P is a leaf
    out = [shard_array(mesh, x, *s) for x, s in zip(flat, spec_flat)]
    return tree_unflatten(tree, out)


def make_fsdp_train_step(train_step, mesh, param_specs, opt_specs=None, *,
                         axis: str = "fsdp", batch_spec: Optional[P] = None,
                         donate: bool = True):
    """``train_step(params, opt_state, batch)`` (models/llama.py
    ``make_train_step``) over ZeRO shardings.

    Plain trees are sharded on the way in (``param_specs``,
    ``opt_specs``); sharded ones step in place, unless ``donate=False``,
    which steps copies and leaves the caller's trees as they were.  The
    batch shards its leading dim over ``axis`` unless ``batch_spec``
    names other axes."""
    from ..models.sharded import batch_axes, is_sharded

    data = tuple(spec_axes((batch_spec if batch_spec is not None
                            else P(axis))[:1]))

    def step(params, opt_state, batch):
        if not is_sharded(params):
            params = shard_tree(params, mesh, param_specs)
        if opt_specs is not None and not is_sharded(opt_state):
            opt_state = shard_tree(opt_state, mesh, opt_specs)
        if not donate:
            params, opt_state = (tree_map(lambda t: t.clone(), x)
                                 for x in (params, opt_state))
        with batch_axes(data):
            return train_step(params, opt_state, batch)

    return step
