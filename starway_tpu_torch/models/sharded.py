"""The slots that run the Llama model: a parameter tree sharded over a
mesh by ``param_specs`` (models/llama.py), ``fsdp_specs``
(parallel/fsdp.py) or both, or a tree not sharded at all, which is the one
slot of a mesh of its own.

models/llama.py has one decoder block (``decoder_block``), which runs on a
list of shards; :class:`SlotTree` gives it each slot's shards and the
collectives where the slots meet.  The JAX package shards the tree with
``NamedSharding`` and lets GSPMD insert the collectives.  Here every slot
of the mesh that this process holds (parallel/sharding.py) runs the model
on its own shards, and the slots meet in the collectives of
ops/collectives.py (each the identity on a mesh of one slot):

* **Data** (every axis but ``"tp"``, ``"sp"`` and ``"ep"``: ``"dp"``,
  ``"fsdp"``): each slot takes its block of the batch.
* **Tensor parallelism** (``"tp"``, Megatron's layout, which is what
  ``param_specs`` describes): q/k/v, gate/up and the biases are split on
  their output dim, so each slot runs ``Hq / tp`` query and ``Hkv / tp``
  kv heads and ``F / tp`` of the MLP; wo and down are split on their input
  dim and their products are summed over tp (``psum``).  The embedding is
  split on the vocab: each slot looks up the rows it holds, the others are
  zero, then a ``psum``.  ``lm_head`` is split on the vocab and the logits
  are gathered over tp.
* **Sequence parallelism** (``"sp"``, through ``make_sharded_attn`` or
  ``make_ulysses_attention``) and **experts** (``"ep"``, through
  ``make_sharded_moe``): the attention or MoE function takes the slots'
  lists (its ``slots`` method) and cuts and rejoins the sequence itself.
  Any other MoE function, and the global view, route the whole batch.
* **Sharded storage** (``"fsdp"``, or any axis the model does not
  consume): a leaf is gathered over those axes just before its use, a
  layer at a time, and the gradient of the gather is the reduce-scatter.

Activations outside the sharded regions are replicated over the axes that
do not cut the batch.  A training step differentiates the slots' losses
with each one weighted so that their sum is the global loss: each
collective's backward is its adjoint, so the gradient a slot gets for a
leaf is its share, and the shares are summed over the axes the leaf is
replicated on.  Every sum runs in a fixed order, so a mesh split over
processes gives the bits of the one-process run.

Serving (``decode_step``, ``SlotServer``, the speculative drivers) takes a
tree over ``{"tp": n}`` in one process: the cache of each slot holds its
kv heads (:class:`HeadSplit`), and the decode kernel runs at the slot's
head count.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

from ..ops import collectives as col
from ..parallel.sharding import Mesh, join_blocks, local_shards
from ..reshard.api import ShardedTensor, SlotSharding
from .llama import matmul_w, moe_ffn, rmsnorm

TP = "tp"
EP = "ep"
MODEL_AXES = ("tp", "sp", "ep")


# ------------------------------------------------------------ the tree


def tree_mesh(tree):
    """The mesh of the first sharded leaf of ``tree``, or None."""
    for leaf in _walk(tree):
        if isinstance(leaf, ShardedTensor):
            return leaf.sharding.mesh
    return None


def _walk(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def is_sharded(tree) -> bool:
    return tree_mesh(tree) is not None


def _spec(x, ndim: int) -> list:
    """Per dimension, the axes that split it (a tuple, maybe empty)."""
    spec = x.sharding.spec if isinstance(x, ShardedTensor) else ()
    out = []
    for d in range(ndim):
        entry = spec[d] if d < len(spec) else None
        out.append(() if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry)))
    return out


def _paths(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _paths(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _put(tree: dict, path, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _gathers(spec, mesh, keep) -> list:
    """``(dim, axis)`` of every axis of ``spec`` that the model does not
    consume (those not in ``keep``), innermost axis first, so gathered in
    this order the blocks join in the order of the spec."""
    return [(d, a) for d, axes in enumerate(spec) for a in reversed(axes)
            if a not in keep and mesh.shape[a] > 1]


def _kept(spec, d, keep) -> tuple:
    return tuple(a for a in spec[d] if a in keep)


class _Leaf:
    """One leaf of the tree as the slots see it: ``vals`` the tensor of
    each local slot, ``spec`` per dimension the axes that split it,
    ``lo`` each slot's offset along every dimension; each use gathers it
    over the axes of its spec not in ``keep``.  A leaf of the stacked
    layers (``stacked``) is split into its layers by one ``unbind`` when
    autograd records: the gradient of the stacked leaf is then one stack
    of the per-layer gradients, where indexing it once a layer would
    write a zero tensor the size of the whole stack for every layer."""

    def __init__(self, x, mesh, keep, alias: bool, stacked: bool):
        self.x, self.mesh = x, mesh
        if isinstance(x, ShardedTensor):
            vals = local_shards(x)
            boxes = x.sharding.indices_map(x.shape)
            self.lo = [[lo for lo, _ in boxes[mesh.slots[i]]]
                       for i in mesh.local_slots]
        else:
            vals = [x] * len(mesh.local_slots)
            self.lo = [[0] * x.dim() for _ in mesh.local_slots]
        self.spec = _spec(x, vals[0].dim())
        self.gathers = _gathers(self.spec[1:] if stacked else self.spec,
                                mesh, keep)
        self.trains = alias and vals[0].is_floating_point()
        if self.trains:
            vals = [v.detach().requires_grad_() for v in vals]
        self.vals = vals
        self.layers = None
        if stacked and (self.trains or torch.is_grad_enabled()):
            self.layers = [v.unbind(0) for v in vals]

    def values(self, i: Optional[int] = None) -> list:
        """Each local slot's value (of layer ``i`` for a stacked leaf),
        gathered."""
        if i is None:
            vals = self.vals
        elif self.layers is not None:
            vals = [u[i] for u in self.layers]
        else:
            vals = [v[i] for v in self.vals]
        for d, a in self.gathers:
            vals = col.all_gather(vals, self.mesh, a, d)
        return vals


_BATCH_AXES = contextvars.ContextVar("batch_axes", default=None)


@contextlib.contextmanager
def batch_axes(axes):
    """Within the block, the batch of a sharded step is cut over ``axes``
    (parallel/fsdp.py ``make_fsdp_train_step``'s ``batch_spec``)."""
    token = _BATCH_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _BATCH_AXES.reset(token)


def _data_axes(mesh) -> tuple:
    """The axes that cut the batch: set by :func:`batch_axes`, or every
    axis of the mesh but the model's own (tp, sp, ep)."""
    data_axes = _BATCH_AXES.get()
    if data_axes is None:
        data_axes = tuple(a for a in mesh.axis_names if a not in MODEL_AXES)
    return tuple(a for a in data_axes if mesh.shape.get(a, 1) > 1)


def _device(tree):
    return next(_walk(tree)).device


class SlotTree:
    """The slots' view of a parameter tree: each leaf as a :class:`_Leaf`,
    with per-slot leaves that take gradients when ``alias``.  A tree with
    no sharded leaf is the one slot of a mesh of its own, on the tree's
    device.  The model consumes the ``"tp"`` axis sharded, and the
    experts' axis when ``moe_fn`` takes the slots (its ``slots``
    method); every other axis a leaf is split over is gathered before
    its use."""

    def __init__(self, params: dict, *, moe_fn=None, alias: bool = False):
        mesh = tree_mesh(params)
        self.sharded = mesh is not None
        self.mesh = mesh if self.sharded else Mesh({}, _device(params))
        self.n = len(self.mesh.local_slots)
        self.keep = {TP}
        if self.sharded and getattr(moe_fn, "slots", None) is not None:
            self.keep.add(getattr(moe_fn, "ep_axis", EP))
        self.data_axes = _data_axes(self.mesh)
        self.leaves = {path: _Leaf(x, self.mesh, self.keep, alias,
                                   path[0] == "layers")
                       for path, x in _paths(params)}
        # The layers' leaves by name, and key within a {"q", "s"} pair or
        # the "moe" subtree.
        self._layer_leaves = [(path[1], path[2] if len(path) > 2 else None,
                               leaf) for path, leaf in self.leaves.items()
                              if path[0] == "layers"]
        # Per layer matmul leaf, the axes the model consumes that split its
        # input dim (a W8A16 pair's from its codes: the scales drop it).
        self._row_split = {path[1]: _kept(leaf.spec, 1, self.keep)
                           for path, leaf in self.leaves.items()
                           if path[0] == "layers" and path[-1] != "s"}

    def grad_inputs(self) -> list:
        return [v for leaf in self.leaves.values() if leaf.trains
                for v in leaf.vals]

    def _values(self, *path) -> list:
        return self.leaves[tuple(path)].values()

    def layer(self, i: int) -> list:
        """Each local slot's params of layer ``i``, nested as the tree's
        ``layers`` (a W8A16 leaf a ``{"q", "s"}`` pair)."""
        out = [{} for _ in range(self.n)]
        for name, key, leaf in self._layer_leaves:
            for lp, v in zip(out, leaf.values(i)):
                if key is None:
                    lp[name] = v
                else:
                    lp.setdefault(name, {})[key] = v
        return out

    def reduce(self, ys: list, name: str) -> list:
        """The sum over the slots of their partial products of the
        row-split layer leaf ``name`` (``"wo"``, ``"w_down"``): a psum
        over each axis the model consumes that splits its input dim."""
        for a in self._row_split[name]:
            ys = col.psum(ys, self.mesh, a)
        return ys

    def attend(self, attn_fn):
        """``attend(qs, ks, vs)`` for ``decoder_block``: ``attn_fn``'s
        ``slots`` on a sharded tree, else ``attn_fn`` slot by slot."""
        slots = getattr(attn_fn, "slots", None) if self.sharded else None
        if slots is not None:
            return slots
        return lambda qs, ks, vs: [attn_fn(q, k, v)
                                   for q, k, v in zip(qs, ks, vs)]

    def moe(self, xs: list, ms: list, cfg, moe_fn) -> tuple:
        """The MoE FFN on the slots' normed hidden states ``xs``, ``ms``
        each slot's ``moe`` subtree: ``(ys, auxes, stats or None)``.
        A ``moe_fn`` with ``slots`` takes the slots' lists.  Any other
        routes the whole batch at once, as the JAX package's GSPMD gives
        it the global batch (its capacity, its priority order and its
        stats are the whole batch's): the batch is gathered over the data
        axes first and each slot keeps its own rows."""
        slots = getattr(moe_fn, "slots", None) if self.sharded else None
        if slots is not None:
            return slots(xs, *([m.get(name) for m in ms] for name in
                               ("router", "w_in", "w_out", "w_gate")))
        full = list(xs)
        for a in reversed(self.data_axes):
            full = col.all_gather(full, self.mesh, a, 0)
        outs = [moe_ffn(x, m, cfg, moe_fn) for x, m in zip(full, ms)]
        ys = [y for y, _, _ in outs]
        if self.data_axes:
            rows = xs[0].shape[0]
            ys = [y[s:s + rows] for y, s in zip(ys, self._row_starts(rows))]
        return ys, [aux for _, aux, _ in outs], outs[0][2]

    def _row_starts(self, rows: int) -> list:
        out = []
        for i in self.mesh.local_slots:
            c = self.mesh.slot_coords(i)
            idx = 0
            for a in self.data_axes:
                idx = idx * self.mesh.shape[a] + c[a]
            out.append(idx * rows)
        return out

    def embed(self, toks: list, cfg) -> list:
        """Each slot's embedding of its tokens (vocab-parallel over a kept
        axis: the rows this slot holds, the others zero, then a psum)."""
        leaf = self.leaves[("embed",)]
        split = _kept(leaf.spec, 0, self.keep)
        out = []
        for j, (e, tok) in enumerate(zip(leaf.values(), toks)):
            if split:
                local = tok - leaf.lo[j][0]
                hit = (local >= 0) & (local < e.shape[0])
                h = (e[local.clamp(0, e.shape[0] - 1)]
                     * hit[..., None].to(e.dtype))
            else:
                h = e[tok]
            out.append(h)
        for a in split:
            out = col.psum(out, self.mesh, a)
        if cfg.scaled_embed:
            out = [h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                                    device=h.device) for h in out]
        return out

    def head(self, hs: list, cfg) -> list:
        """Final norm and ``lm_head``: each slot's float32 logits (a
        vocab-split head gathered over its kept axes)."""
        w_leaf = (self.leaves.get(("lm_head",))
                  or self.leaves[("lm_head", "q")])
        if ("lm_head",) in self.leaves:
            ws = self._values("lm_head")
        else:
            ws = [{"q": q, "s": s} for q, s in
                  zip(self._values("lm_head", "q"),
                      self._values("lm_head", "s"))]
        out = [matmul_w(rmsnorm(h, n, cfg.norm_eps), w).float()
               for h, n, w in zip(hs, self._values("final_norm"), ws)]
        for a in reversed(_kept(w_leaf.spec, len(w_leaf.spec) - 1,
                                self.keep)):
            out = col.all_gather(out, self.mesh, a, -1)
        return out

    # ---------------------------------------------------- the batch

    def _batch_spec(self) -> tuple:
        return (self.data_axes if self.data_axes else None,)

    def cut_batch(self, x) -> list:
        """Each local slot's block of the global batch ``x`` (dim 0)."""
        if not self.sharded:
            return [x]
        boxes = SlotSharding(self.mesh, self._batch_spec()).indices_map(
            x.shape)
        return [x[slice(*boxes[self.mesh.slots[i]][0])]
                for i in self.mesh.local_slots]

    def join_batch(self, vals: list):
        """Inverse of :meth:`cut_batch` over this process's slots: the
        batch rows they hold, in order."""
        if not self.sharded:
            return vals[0]
        spec = self._batch_spec() + (None,) * (vals[0].dim() - 1)
        return join_blocks(vals, self.mesh, spec)

    def kv(self, kvs: list):
        """Per-slot ``(k, v)`` stacks as the cache prefix: the tensors of a
        whole tree, or :class:`HeadSplit` s over the tp slots."""
        if not self.sharded:
            return kvs[0]
        _tp_only(self.mesh)
        return (HeadSplit([k for k, _ in kvs], 2),
                HeadSplit([v for _, v in kvs], 2))

    # ---------------------------------------------------- gradients

    def mean_loss(self, losses: list, weight: float):
        """The global loss from the slots' weighted losses."""
        vals = [l.detach() * weight for l in losses]
        for a in self.mesh.axis_names:
            if self.mesh.shape[a] > 1:
                vals = col.psum(vals, self.mesh, a)
        return vals[0]

    def grad_tree(self, grads, params: dict) -> dict:
        """The gradients of :meth:`grad_inputs` as a tree like ``params``
        (sharded as it is): each leaf's slots summed over the axes the
        leaf is replicated on, zeros for leaves that do not train."""
        it = iter(grads)
        out = {}
        for path, leaf in self.leaves.items():
            if not leaf.trains:
                _put(out, path, _zeros_like_leaf(leaf.x))
                continue
            g = [next(it) for _ in leaf.vals]
            named = set(a for axes_d in leaf.spec for a in axes_d)
            for a in self.mesh.axis_names:
                if a not in named and self.mesh.shape[a] > 1:
                    g = col.psum(g, self.mesh, a)
            _put(out, path, _rebuild(leaf.x, g, self.mesh))
        return _like(params, out)


def _zeros_like_leaf(x):
    if isinstance(x, ShardedTensor):
        return x.tree_rebuild([torch.zeros_like(t)
                               for t in x.tree_children()])
    return torch.zeros_like(x)


def _rebuild(x, per_slot, mesh):
    """A leaf like ``x`` holding ``per_slot`` (one tensor a local slot;
    slots that share a box take the first slot's)."""
    if not isinstance(x, ShardedTensor):
        return per_slot[0]
    first = {}
    for j, i in enumerate(mesh.local_slots):
        first.setdefault(id(x.shards[mesh.slots[i]]), per_slot[j])
    return x.tree_rebuild([first[id(t)] for t in x.tree_children()])


def _like(params: dict, flat: dict) -> dict:
    """``flat`` (nested as built) in the key order of ``params``."""
    return {k: (_like(v, flat[k]) if isinstance(v, dict) else flat[k])
            for k, v in params.items()}


# ------------------------------------------------------------ serving


def serving_tree(params: dict) -> SlotTree:
    """The :class:`SlotTree` of a tree the decode paths take: whole, or
    sharded over ``{"tp": n}`` in one process."""
    tree = SlotTree(params)
    if tree.sharded:
        _tp_only(tree.mesh)
    return tree


class HeadSplit:
    """A tensor ``[..., H, ...]`` held as the parts of the tp slots, split
    on dimension ``dim`` (the heads of a KV cache ``[L, B, Hkv, T, D]``,
    dim 2).  Indexing that keeps ``dim`` whole applies to every part, so
    the servers' cache bookkeeping runs unchanged."""

    def __init__(self, parts: list, dim: int):
        self.parts = list(parts)
        self.dim = dim

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return tuple(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    def _index(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        dim = self.dim
        for d, i in enumerate(idx[:self.dim]):
            if isinstance(i, int):
                dim -= 1
        if len(idx) > self.dim and idx[self.dim] != slice(None):
            raise IndexError("a HeadSplit keeps its head dimension whole")
        return idx, dim

    def __getitem__(self, idx):
        idx, dim = self._index(idx)
        return HeadSplit([p[idx] for p in self.parts], dim)

    def __setitem__(self, idx, value):
        idx, _ = self._index(idx)
        for p, v in zip(self.parts, value.parts):
            p[idx] = v

    def copy_(self, other):
        for p, o in zip(self.parts, other.parts):
            p.copy_(o)
        return self

    def map(self, fn):
        """``fn`` over every part; a ``fn`` that returns a tuple gives a
        tuple of HeadSplits."""
        outs = [fn(p) for p in self.parts]
        if isinstance(outs[0], tuple):
            return tuple(HeadSplit(list(o), self.dim) for o in zip(*outs))
        return HeadSplit(outs, self.dim)

    def index_select(self, dim: int, index):
        if dim == self.dim:
            raise IndexError("a HeadSplit keeps its head dimension whole")
        return self.map(lambda p: p.index_select(dim, index))


def per_part(fn, x):
    """``fn(x)`` of a cache leaf: over every part of a :class:`HeadSplit`
    (:meth:`HeadSplit.map`), or of a tensor."""
    return x.map(fn) if isinstance(x, HeadSplit) else fn(x)


def cache_parts(x) -> list:
    """Each slot's part of a cache leaf (a tensor is one slot's)."""
    return x.parts if isinstance(x, HeadSplit) else [x]


def _tp_only(mesh):
    extra = [a for a, n in mesh.shape.items() if n > 1 and a != TP]
    if extra or mesh.world > 1:
        raise NotImplementedError(
            f"serving a tree sharded over {mesh.shape} (world "
            f"{mesh.world}): the port serves over {{'tp': n}} in one "
            f"process (ROADMAP.md, Queue 1 item 6)")


def tp_init_cache(cfg, mesh, batch: int, max_len: int) -> dict:
    """A zeroed cache for a tp tree: each slot's part holds its kv heads."""
    from .generate import init_cache

    _tp_only(mesh)
    tp = mesh.shape.get(TP, 1)
    if cfg.n_kv_heads % tp:
        raise ValueError(f"n_kv_heads={cfg.n_kv_heads} does not split over "
                         f"tp={tp}")
    lcfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               head_dim_override=cfg.head_dim)
    parts = [init_cache(lcfg, batch, max_len, device=mesh.device)
             for _ in range(tp)]
    return {name: HeadSplit([p[name] for p in parts], 2)
            for name in parts[0]}
