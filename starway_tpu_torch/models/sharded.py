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

Serving (``prefill``, ``decode_step``, ``prefill_rolling``,
``generate``, ``SlotServer`` dense or rolling, ``PagedSlotServer``, the
speculative decoders) takes every tree the JAX package serves, in one
process or over a group of processes.  :func:`serving_axes` splits the
mesh: the model's axes, ``"tp"`` and ``"ep"`` where a leaf is split over
them, and the data axes, every other one (``"dp"``, ``"fsdp"``, and
``"sp"``, ``"pp"`` or a dense tree's ``"ep"``, over which no leaf of
``param_specs`` is split).  The batch rows are cut over the data axes in
blocks as even as they come (:func:`row_blocks`; a block may be empty),
except for a MoE whose capacity can drop tokens: which tokens it drops
depends on the whole batch's routing, as the JAX package's GSPMD routes
it, so every group runs every row (aligned ``generate()`` and the
prefill; the servers need a dropless MoE).  Each data group (the slots that share a block, :class:`DataGroups`) runs
the decode paths on its rows with a view of the tree over its slots,
which shares the shards' storage (weights replicated over the data axes
are held once), and a leaf split over a data axis (``fsdp_specs``) is
gathered a layer before its use, as in training.  The cache of each slot
holds its kv heads of its group's rows (:class:`HeadSplit`; a paged pool
a contiguous part ``[L, n_pages, Hkv / tp, page, D]`` of every page), the
decode and paged kernels run at the slot's head count, and over ``"ep"``
each slot runs its own experts (models/moe.py ``make_expert_view``: no
expert leaf is gathered).  Every process runs the same loop on the same
requests, and the logits of the rows are gathered over the data axes, so
every process samples the same tokens.  A data group's slots may sit in
several processes: its view is then a mesh across them, and the groups
run in rounds in which every process that holds a group's slots runs it.
Where a leaf split over a data axis is gathered across processes, a
process with no rows in a round (a batch with fewer rows than data
groups, or a round none of its groups runs in) posts the gathers of the
groups that run and computes nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch

from ..ops import collectives as col
from ..parallel.sharding import AxisSlice, Mesh, join_blocks, local_shards
from ..reshard.api import ShardedTensor, SlotSharding
from .llama import matmul_w, moe_ffn, rmsnorm

TP = "tp"
EP = "ep"
MODEL_AXES = ("tp", "sp", "ep")


# ------------------------------------------------------------ the tree


def tree_mesh(tree):
    """The mesh of the first sharded leaf of ``tree``, or None."""
    for leaf in _walk(tree):
        if isinstance(leaf, (ShardedTensor, _GroupLeaf)):
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
    spec = (x.sharding.spec if isinstance(x, (ShardedTensor, _GroupLeaf))
            else ())
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
    write a zero tensor the size of the whole stack for every layer.

    A data group's leaf split over the data axes (:class:`_GroupLeaf`)
    holds the tensors of every local slot of the whole mesh: each use
    gathers them over the data axes there and keeps the group's."""

    def __init__(self, x, mesh, keep, alias: bool, stacked: bool):
        self.x, self.mesh, self.src, self.pick = x, mesh, mesh, None
        if isinstance(x, (ShardedTensor, _GroupLeaf)):
            boxes = x.sharding.indices_map(x.shape)
            self.lo = [[lo for lo, _ in boxes[mesh.slots[i]]]
                       for i in mesh.local_slots]
        if isinstance(x, _GroupLeaf):
            self.src = x.parent
            vals = local_shards(x.x)
            local = list(x.parent.local_slots)
            self.pick = [local.index(i) for i in x.slots]
            split = _spec(x.x, vals[0].dim())
        elif isinstance(x, ShardedTensor):
            vals = local_shards(x)
            split = _spec(x, vals[0].dim())
        else:
            vals = [x] * len(mesh.local_slots)
            self.lo = [[0] * x.dim() for _ in mesh.local_slots]
            split = _spec(x, vals[0].dim())
        self.spec = _spec(x, vals[0].dim())
        self.gathers = _gathers(split[1:] if stacked else split, self.src,
                                keep)
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
            vals = col.all_gather(vals, self.src, a, d)
        if self.pick is not None:
            vals = [vals[j] for j in self.pick]
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
        self.moe_fn = moe_fn
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

    def _head_weights(self) -> tuple:
        """Each local slot's ``lm_head`` (a W8A16 ``{"q", "s"}`` pair) and
        final norm, gathered in this order."""
        if ("lm_head",) in self.leaves:
            ws = self._values("lm_head")
        else:
            ws = [{"q": q, "s": s} for q, s in
                  zip(self._values("lm_head", "q"),
                      self._values("lm_head", "s"))]
        return ws, self._values("final_norm")

    def head(self, hs: list, cfg) -> list:
        """Final norm and ``lm_head``: each slot's float32 logits (a
        vocab-split head gathered over its kept axes)."""
        w_leaf = (self.leaves.get(("lm_head",))
                  or self.leaves[("lm_head", "q")])
        ws, norms = self._head_weights()
        out = [matmul_w(rmsnorm(h, n, cfg.norm_eps), w).float()
               for h, n, w in zip(hs, norms, ws)]
        for a in reversed(_kept(w_leaf.spec, len(w_leaf.spec) - 1,
                                self.keep)):
            out = col.all_gather(out, self.mesh, a, -1)
        return out

    def post_gathers(self, n_layers: int, bodies: int = 1) -> None:
        """Gather every leaf as ``bodies`` passes of the decode paths over
        ``n_layers`` layers and one head would (the embedding, each
        layer's leaves, ``lm_head`` and the final norm), computing nothing:
        a process with no rows joins the gathers that the data groups with
        rows wait in (:meth:`DataGroups.each`)."""
        for _ in range(bodies):
            self._values("embed")
            for i in range(n_layers):
                self.layer(i)
        self._head_weights()

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
        whole tree, or :class:`HeadSplit` s over the tp slots (and the
        data groups' rows)."""
        if not self.sharded:
            return kvs[0]
        heads = kvs[0][0].shape[2] * self.mesh.shape.get(TP, 1)
        rows = batch = None
        if self.data_axes:
            batch = kvs[0][0].shape[1] * math.prod(
                self.mesh.shape[a] for a in self.data_axes)
            boxes = SlotSharding(self.mesh, self._batch_spec()).indices_map(
                (batch,))
            rows = [boxes[self.mesh.slots[i]][0]
                    for i in self.mesh.local_slots]
        return (HeadSplit([k for k, _ in kvs], 2, rows, batch, heads),
                HeadSplit([v for _, v in kvs], 2, rows, batch, heads))

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


def serving_axes(params: dict) -> tuple:
    """``(model, data)``: the axes of a serving tree's mesh (above 1)
    that its slots consume sharded, and those its batch rows are cut
    over.  The model's axes are ``"tp"`` and ``"ep"`` where a leaf is
    split over them (the heads, the experts); every other axis is a data
    axis: ``"dp"``, ``"fsdp"``, and ``"sp"``, ``"pp"`` or a dense tree's
    ``"ep"``, over which no leaf of ``param_specs`` is split."""
    mesh = tree_mesh(params)
    split = set()
    for leaf in _walk(params):
        if isinstance(leaf, (ShardedTensor, _GroupLeaf)):
            split.update(a for axes in _spec(leaf, len(leaf.shape))
                         for a in axes)
    model = tuple(a for a in mesh.axis_names
                  if a in (TP, EP) and a in split and mesh.shape[a] > 1)
    data = tuple(a for a in mesh.axis_names
                 if a not in model and mesh.shape[a] > 1)
    return model, data


def serving_moe(params: dict, cfg):
    """The MoE function of the decode paths over a tree whose experts are
    split over ``"ep"`` (models/moe.py ``make_expert_view``: no expert
    leaf is gathered), else None (the global view, or a dense tree)."""
    if cfg is None or cfg.n_experts == 0 or tree_mesh(params) is None:
        return None
    if EP not in serving_axes(params)[0]:
        return None
    from .moe import make_expert_view

    return make_expert_view(tree_mesh(params),
                            capacity_factor=cfg.moe_capacity_factor,
                            k=cfg.moe_top_k)


def serving_tree(params: dict, cfg=None) -> SlotTree:
    """The :class:`SlotTree` of a tree the decode paths take: whole, or
    sharded over the model's axes (in one process or over a group of
    processes); over ``"ep"`` the experts stay split (:func:`serving_moe`,
    which needs ``cfg``).  A tree with a data axis runs them per data
    group (:func:`data_groups`; the embedding's or the head's subtree
    alone, which does not show the model's axes, is taken as it comes)."""
    tree = SlotTree(params, moe_fn=serving_moe(params, cfg))
    if tree.sharded and "layers" in params and serving_axes(params)[1]:
        raise NotImplementedError(
            f"a tree over {tree.mesh.shape} runs the decode paths per "
            f"data group (models/sharded.py data_groups)")
    return tree


def row_blocks(batch: int, n: int, every_row: bool = False) -> list:
    """``(lo, hi)`` of each of ``n`` blocks of ``batch`` rows: as even as
    they come, the first ``batch % n`` a row longer (a block may be
    empty); with ``every_row``, every block all the rows."""
    if every_row:
        return [(0, batch)] * n
    size, extra = divmod(batch, n)
    out, lo = [], 0
    for g in range(n):
        hi = lo + size + (g < extra)
        out.append((lo, hi))
        lo = hi
    return out


def routes_whole_batch(cfg) -> bool:
    """Whether ``cfg`` is a MoE whose capacity can drop tokens: which it
    drops then depends on the whole batch's routing (the JAX package's
    GSPMD routes the global batch), so every data group runs every row
    (:class:`DataGroups`).  A dropless MoE routes each token alone."""
    return (cfg is not None and cfg.n_experts > 0
            and cfg.moe_capacity_factor < cfg.n_experts)


def _group_of(mesh, axes: tuple, index: int) -> int:
    """The data group of slot ``index``: its coordinate over ``axes``,
    row-major."""
    c, g = mesh.slot_coords(index), 0
    for a in axes:
        g = g * mesh.shape[a] + c[a]
    return g


class DataGroups:
    """The data groups of a serving tree: the slots at one coordinate of
    its data axes (:func:`serving_axes`), which hold one block of the
    batch rows (row-major over the data axes, in the blocks of
    :func:`row_blocks`).  Each group this process holds slots of has a
    view of the tree (``views[g]``: the tree over the group's slots, on
    the mesh of the model's axes at the group's data coordinates,
    parallel/sharding.py ``AxisSlice``, sharing this process's shards; a
    leaf split over a data axis is a :class:`_GroupLeaf`, gathered a
    layer at a time).  A group's slots may sit in several processes, a
    process holding any number of them: the group's collectives then run
    across those processes, as the tree's do.

    The groups run in rounds (:meth:`each`): all the processes that hold
    a group's slots run it in the same round, and no process runs two
    groups in one round, so the hops of a group that spans processes
    meet.  Where a leaf split over a data axis is gathered across
    processes (``gathers_across``), each gather spans the whole mesh, so
    a process that runs no group in a round (its groups' blocks of the
    batch are empty, or none of them runs in that round) posts the
    gathers of one group's run instead (:meth:`SlotTree.post_gathers`)
    and computes nothing.  Every group runs every row where ``cfg``
    routes a MoE over the whole batch (:func:`routes_whole_batch`)."""

    def __init__(self, params: dict, mesh, axes: tuple, cfg=None):
        self.mesh, self.axes, self.cfg = mesh, axes, cfg
        self.size = math.prod(mesh.shape[a] for a in axes)
        self.every_row = routes_whole_batch(cfg)
        self.group_of = [_group_of(mesh, axes, i) for i in range(mesh.size)]
        self.slots_of = [[] for _ in range(self.size)]
        for i in range(mesh.size):
            self.slots_of[self.group_of[i]].append(i)
        # The processes (ranks of the mesh's group) that hold each group.
        self.holders = [frozenset(mesh.slots[i].rank for i in slots)
                        for slots in self.slots_of]
        local = list(mesh.local_slots)
        self.local = sorted({self.group_of[i] for i in local})
        # g -> [(local part index, the slot's index in the group's view)]
        self.members = {g: [(local.index(i), k)
                            for k, i in enumerate(self.slots_of[g])
                            if i in mesh.local_slots] for g in self.local}
        self.views = {}
        for g in self.local:
            first = mesh.slot_coords(self.slots_of[g][0])
            sub = AxisSlice(mesh, tuple(axes), tuple(first[a] for a in axes))
            self.views[g] = _group_view(params, mesh, sub, self.slots_of[g],
                                        axes)
        self.gathers_across = mesh.world > 1 and any(
            isinstance(leaf, _GroupLeaf) for v in self.views.values()
            for leaf in _walk(v))

    def blocks(self, batch: int) -> list:
        """``(lo, hi)`` of each group's rows of a batch of ``batch``."""
        return row_blocks(batch, self.size, self.every_row)

    def rows(self, batch: int, g: int) -> slice:
        """Group ``g``'s block of a batch of ``batch`` rows."""
        return slice(*self.blocks(batch)[g])

    def group_rows(self, batch: int, row: int) -> int:
        """The group whose block of a batch of ``batch`` rows holds
        ``row`` (the first such, where every group runs every row)."""
        return next(g for g, (lo, hi) in enumerate(self.blocks(batch))
                    if lo <= row < hi)

    def _rounds(self, groups) -> list:
        """The groups of ``groups`` in rounds: each in the first round in
        which none of its processes runs another group."""
        rounds, busy = [], []
        for g in groups:
            r = next((r for r, b in enumerate(busy)
                      if not b & self.holders[g]), len(rounds))
            if r == len(rounds):
                rounds.append([])
                busy.append(frozenset())
            rounds[r].append(g)
            busy[r] |= self.holders[g]
        return rounds

    def post_gathers(self, view, bodies: int = 1) -> None:
        """The gathers of one run of the decode paths (``bodies`` passes
        of the embedding and the layers, one head) over ``view``."""
        tree = SlotTree(view, moe_fn=serving_moe(view, self.cfg))
        tree.post_gathers(self.cfg.n_layers, bodies)

    def each(self, groups, fn, ghost=None) -> dict:
        """``{g: fn(view, g)}`` of the groups of ``groups`` that this
        process holds slots of, run in rounds (the class docstring);
        where the leaves are gathered across processes, ``ghost(view)``
        (default :meth:`post_gathers`) in each round this process runs no
        group."""
        out = {}
        for round_groups in self._rounds(groups):
            mine = [g for g in round_groups if g in self.members]
            if mine:
                out[mine[0]] = fn(self.views[mine[0]], mine[0])
            elif self.gathers_across:
                (ghost or self.post_gathers)(self.views[self.local[0]])
        return out

    def cover(self) -> list:
        """Groups whose runs give every process a part at each view index
        of its slots (the slots at one index of every group hold the same
        shards of the replicated weights): the groups covering the most
        (process, index) pairs not yet covered, first, until all are;
        over one process, the first group."""
        need = {(self.mesh.slots[i].rank, k)
                for slots in self.slots_of for k, i in enumerate(slots)}
        out = []
        while need:
            gain = [len(need & {(self.mesh.slots[i].rank, k)
                                for k, i in enumerate(slots)})
                    for slots in self.slots_of]
            g = gain.index(max(gain))
            out.append(g)
            need -= {(self.mesh.slots[i].rank, k)
                     for k, i in enumerate(self.slots_of[g])}
        return sorted(out)

    def spread(self, caches: dict) -> dict:
        """``{name: {view index: part}}`` of the caches that the local
        groups of :meth:`cover` made (``{g: cache}``)."""
        out = {}
        for g, cache in caches.items():
            for p, (_j, k) in enumerate(self.members[g]):
                for name, c in cache.items():
                    out.setdefault(name, {}).setdefault(k, c.parts[p])
        return out

    def fill(self, cache: dict, parts: dict, batch: int, row: int,
             width: Optional[int] = None) -> None:
        """Copy one row's :meth:`spread` ``parts`` into row ``row`` of a
        cache of ``batch`` rows (positions ``:width`` of dimension 3), in
        the parts of every local group whose block holds the row."""
        for g in self.local:
            lo, hi = self.blocks(batch)[g]
            if not lo <= row < hi:
                continue
            for j, k in self.members[g]:
                for name, c in cache.items():
                    src = parts[name][k]
                    w = src.shape[3] if width is None else width
                    c.parts[j][:, row - lo:row - lo + 1, :, :w] = \
                        src[:, :, :, :w]

    def cache_of(self, cache: dict, g: int) -> dict:
        """Group ``g``'s parts of a cache (its rows, every head)."""
        return {name: HeadSplit([c.parts[j] for j, _ in self.members[g]],
                                c.dim, heads=c.heads)
                for name, c in cache.items()}

    def join_cache(self, caches: dict, batch: int) -> dict:
        """One cache from each local group's (``{g: cache}``)."""
        first = next(iter(caches.values()))
        parts = {name: [None] * len(self.mesh.local_slots) for name in first}
        rows = [None] * len(self.mesh.local_slots)
        for g, cache in caches.items():
            r = self.rows(batch, g)
            for p, (j, _) in enumerate(self.members[g]):
                rows[j] = (r.start, r.stop)
                for name in first:
                    parts[name][j] = cache[name].parts[p]
        return {name: HeadSplit(parts[name], c.dim, rows, batch, c.heads)
                for name, c in first.items()}

    def run(self, batch: int, fn, tail: tuple, ghost=None, blocks=None):
        """``fn(view, g, rows)`` of every group whose block of the
        ``batch`` rows (``blocks``, default :meth:`blocks`) is not empty,
        in the rounds of :meth:`each` (``ghost`` as there); its output
        (the group's rows on dim 0, ``tail`` the trailing shape, float32)
        gathered over the data axes into the whole batch's, which every
        process receives.  The blocks are padded to the longest for the
        gather.  Where every group runs every row, each computes the whole
        batch's output and the first local group's is returned."""
        if self.every_row:
            outs = self.each(range(self.size),
                             lambda view, g: fn(view, g, slice(0, batch)),
                             ghost)
            return outs[min(outs)]
        blocks = self.blocks(batch) if blocks is None else blocks
        most = max(hi - lo for lo, hi in blocks)
        outs = self.each([g for g, (lo, hi) in enumerate(blocks) if hi > lo],
                         lambda view, g: fn(view, g, slice(*blocks[g])),
                         ghost)
        for g in self.local:
            lo, hi = blocks[g]
            out = outs.get(g)
            if out is None:
                out = torch.zeros((0,) + tuple(tail), dtype=torch.float32,
                                  device=self.mesh.device)
            if hi - lo < most:
                out = torch.cat([out, out.new_zeros(
                    (most - (hi - lo),) + tuple(out.shape[1:]))])
            outs[g] = out
        vals = [outs[self.group_of[i]] for i in self.mesh.local_slots]
        for a in reversed(self.axes):
            vals = col.all_gather(vals, self.mesh, a, 0)
        whole = vals[0]
        if any(hi - lo < most for lo, hi in blocks):
            whole = torch.cat([whole[g * most:g * most + hi - lo]
                               for g, (lo, hi) in enumerate(blocks)])
        return whole


class _GroupLeaf:
    """A leaf split over the data axes as a data group's view holds it:
    the tree's leaf ``x`` over ``parent``, the group's ``slots`` that
    this process holds (their parent indices, in the view's order) and
    the view's ``sharding`` (the
    spec of ``x`` without the data axes, over the view's mesh).
    :class:`_Leaf` gathers it over the data axes before each use."""

    def __init__(self, x: ShardedTensor, parent, slots: list, sharding):
        self.x, self.parent, self.slots = x, parent, slots
        self.sharding = sharding
        self.shape, self.dtype = x.shape, x.dtype

    @property
    def device(self):
        return self.x.device


def _group_view(params, mesh, sub, slots: list, axes: tuple):
    """``params`` over the slots ``slots`` of ``mesh`` (one data group, in
    order) as a tree over ``sub``: this process's shard tensors, new
    shardings; a leaf split over the data ``axes`` as a
    :class:`_GroupLeaf`."""
    if isinstance(params, dict):
        return {k: _group_view(v, mesh, sub, slots, axes)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_group_view(v, mesh, sub, slots, axes)
                            for v in params)
    if not isinstance(params, ShardedTensor):
        return params
    spec = params.sharding.spec
    kept = []
    for entry in spec:
        names = (() if entry is None else
                 (entry,) if isinstance(entry, str) else tuple(entry))
        names = tuple(a for a in names if a not in axes)
        kept.append(names[0] if len(names) == 1 else (names or None))
    sharding = SlotSharding(sub, tuple(kept))
    if tuple(kept) != tuple(spec):
        return _GroupLeaf(params, mesh, [slots[k] for k in sub.local_slots],
                          sharding)
    return ShardedTensor(params.shape, params.dtype, sharding,
                         {sub.slots[k]: params.shards[mesh.slots[slots[k]]]
                          for k in sub.local_slots})


def data_groups(params: dict, cfg=None) -> Optional[DataGroups]:
    """The :class:`DataGroups` of a serving tree with a data axis above 1,
    else None (a whole tree, or one over the model's axes alone); ``cfg``
    the model's (a MoE that drops tokens runs every row in every
    group)."""
    mesh = tree_mesh(params)
    if mesh is None:
        return None
    axes = serving_axes(params)[1]
    return DataGroups(params, mesh, axes, cfg) if axes else None


class HeadSplit:
    """A tensor ``[..., B, H, ...]`` held as the parts of the slots, split
    on dimension ``dim`` over tp (the heads of a KV cache ``[L, B, Hkv, T,
    D]``, dim 2; ``heads`` the whole count, where slots along ``"ep"``
    hold copies of the same heads) and, with ``rows``, on the batch
    dimension before it over the data axes: ``rows`` gives each part's
    ``(lo, hi)`` of the batch of ``batch`` rows (a process may hold the
    parts of some rows only).  Indexing that keeps ``dim`` whole applies
    to every part; a slice of the batch dimension takes the parts whose
    rows hold it (none of a process that holds no slot of those rows), so
    the servers' cache bookkeeping runs unchanged."""

    def __init__(self, parts: list, dim: int, rows=None,
                 batch: Optional[int] = None, heads: Optional[int] = None):
        self.parts = list(parts)
        self.dim = dim
        self.rows = None if rows is None else [tuple(r) for r in rows]
        self.batch = batch
        self.heads = heads

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        first = self.rows[0] if self.rows else None
        s[self.dim] = (self.heads if self.heads is not None else
                       sum(p.shape[self.dim] for j, p in enumerate(self.parts)
                           if first is None or self.rows[j] == first))
        if self.rows:
            s[self.dim - 1] = self.batch
        return tuple(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    def _index(self, idx):
        """``(parts, each part's index, dim, rows)`` of an index."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        dim = self.dim
        for d, i in enumerate(idx[:self.dim]):
            if isinstance(i, int):
                dim -= 1
        if len(idx) > self.dim and idx[self.dim] != slice(None):
            raise IndexError("a HeadSplit keeps its head dimension whole")
        row = self.dim - 1
        if (self.rows is None or len(idx) <= row
                or idx[row] == slice(None)):
            return self.parts, [idx] * len(self.parts), dim, self.rows
        sel = idx[row]
        if not isinstance(sel, slice) or sel.step not in (None, 1):
            raise IndexError("a HeadSplit over the data axes takes a "
                             "contiguous slice of its batch rows")
        a, b, _ = sel.indices(self.batch)
        parts, idxs = [], []
        for p, (lo, hi) in zip(self.parts, self.rows):
            if lo <= a and b <= hi:
                parts.append(p)
                idxs.append(idx[:row] + (slice(a - lo, b - lo),)
                            + idx[row + 1:])
            elif a < hi and lo < b:
                raise IndexError(f"rows {a}:{b} cross the data groups' "
                                 f"blocks {self.rows}")
        return parts, idxs, dim, None

    def __getitem__(self, idx):
        parts, idxs, dim, rows = self._index(idx)
        return HeadSplit([p[i] for p, i in zip(parts, idxs)], dim, rows,
                         self.batch, self.heads)

    def __setitem__(self, idx, value):
        parts, idxs, _, _ = self._index(idx)
        for p, i, v in zip(parts, idxs, value.parts):
            p[i] = v

    def copy_(self, other):
        for p, o in zip(self.parts, other.parts):
            p.copy_(o)
        return self

    def map(self, fn):
        """``fn`` over every part; a ``fn`` that returns a tuple gives a
        tuple of HeadSplits."""
        outs = [fn(p) for p in self.parts]
        if isinstance(outs[0], tuple):
            return tuple(HeadSplit(list(o), self.dim, self.rows, self.batch,
                                   self.heads) for o in zip(*outs))
        return HeadSplit(outs, self.dim, self.rows, self.batch, self.heads)

    def index_select(self, dim: int, index):
        if dim == self.dim or (self.rows is not None and dim == self.dim - 1):
            raise IndexError("a HeadSplit keeps its head dimension whole "
                             "(and the batch rows of its data groups)")
        return self.map(lambda p: p.index_select(dim, index))


def per_part(fn, x):
    """``fn(x)`` of a cache leaf: over every part of a :class:`HeadSplit`
    (:meth:`HeadSplit.map`), or of a tensor."""
    return x.map(fn) if isinstance(x, HeadSplit) else fn(x)


def cache_parts(x) -> list:
    """Each slot's part of a cache leaf (a tensor is one slot's)."""
    return x.parts if isinstance(x, HeadSplit) else [x]


def shard_cache(cfg, params: dict, batch: Optional[int], make) -> dict:
    """A cache for a sharded serving tree: ``make(local_cfg, rows)``, the
    cache of a whole tree at a slot's head counts (``n_heads / tp``,
    ``n_kv_heads / tp``) for ``rows`` batch rows, once a local slot: each
    part holds the slot's kv heads of its data group's block of the
    ``batch`` rows (all of them where the tree has no data axis; a
    ``batch`` of None cuts no rows: a paged pool, whose pages any row
    may take)."""
    mesh = tree_mesh(params)
    model, data = serving_axes(params)
    tp = mesh.shape[TP] if TP in model else 1
    if cfg.n_kv_heads % tp:
        raise ValueError(f"n_kv_heads={cfg.n_kv_heads} does not split over "
                         f"tp={tp}")
    lcfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               head_dim_override=cfg.head_dim)
    rows = None
    if data and batch is not None:
        blocks = row_blocks(batch, math.prod(mesh.shape[a] for a in data),
                            routes_whole_batch(cfg))
        rows = [blocks[_group_of(mesh, data, i)] for i in mesh.local_slots]
    parts = [make(lcfg, batch if rows is None else hi - lo)
             for lo, hi in (rows or [(0, batch)] * len(mesh.local_slots))]
    return {name: HeadSplit([p[name] for p in parts], 2, rows,
                            None if rows is None else batch, cfg.n_kv_heads)
            for name in parts[0]}
