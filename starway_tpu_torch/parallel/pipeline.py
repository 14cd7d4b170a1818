"""Pipeline parallelism: the forward pipeline and the 1F1B training
schedule.

Port of the JAX package's ``parallel/pipeline.py``.  Each slot of the
mesh's pipeline axis (``"pp"``) owns one stage's parameters; microbatches
enter at stage 0, activations hop stage to stage and cotangents hop back,
each hop a rotation along the axis (ops/collectives.py).  The slots may
sit several to a process (parallel/sharding.py): in one process a hop
moves tensors in a list, which runs every stage at its real shape on one
card; a slot held by another process is reached by ``torch.distributed``.

Forward only (:func:`pipeline_apply`, :func:`make_pipeline`): the skewed
loop of ``M + S - 1`` ticks for S stages and M microbatches; the outputs
come from the last stage's slots only.

Training (:func:`pipeline_train_apply`, :func:`make_pipeline_train`): the
collective 1F1B schedule.  Every tick has one forward slot and one
backward slot on every stage:

* F slot, stage ``s``, tick ``t``: microbatch ``i = t - s``;
* B slot, stage ``s``, tick ``t``: microbatch ``j = t - 2(S-1) + s``: the
  last stage backpropagates a microbatch the tick it finishes its forward,
  and the cotangent hops back one stage a tick.

``M + 2(S-1)`` ticks, bubble fraction ``2(S-1) / (M + 2(S-1))``.  A stage
holds at most ``2(S-1-s) + 1`` inputs in flight, so its stash has
``stash_depth(S) = 2(S-1) + 1`` entries: O(S), independent of M.

The JAX package runs one masked program on every device at every tick.
Here a slot whose F or B slot is idle this tick computes nothing, but it
posts its hops all the same (zeros), so every process of a group posts
every hop of every tick in one order.  No graph spans ticks: the F slot
runs the stage without autograd, and the B slot replays the stage from its
stashed input under ``torch.enable_grad()`` and takes
``torch.autograd.grad`` of it (the last stage of its loss, a mid stage
against the cotangent that arrived, its aux output seeded with 1).  The
schedule so holds the stash and one stage's graph at a time, under a
caller's ``torch.no_grad()`` too.  Parameter gradients accumulate in
float32, and the cotangents hop in float32.

Stages are homogeneous: every stage maps ``[mb, ...]`` activations of one
shape and dtype.  A stage function is ``stage_fn(p, x) -> y`` (``(y,
aux)`` with ``with_aux``) on one slot's stage parameters (the leading
stage dim of size 1 kept, as ``shard_map`` keeps it) and activation; or,
for a stage whose slots meet in collectives along the other axes (experts
over ``"ep"``), a function with a ``slots(ps, xs, mesh)`` method over this
process's slots of one stage, ``mesh`` their
:class:`~starway_tpu_torch.parallel.sharding.AxisSlice`.  Token embedding
runs outside the pipeline (chained through ``return_dx``) and the head
inside the last stage's loss (``with_head``): models/pp_llama.py wires
both for the Llama family.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import collectives as col
from ..reshard.api import ShardedTensor
from .sharding import AxisSlice, P, cut_blocks, join_blocks, local_shards


def pipeline_ticks(n_micro: int, n_stages: int, *, train: bool = True) -> int:
    """Ticks of the schedule (see the module docstring)."""
    return n_micro + (2 if train else 1) * (n_stages - 1)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Fraction of 1F1B tick-slots that are idle."""
    return 2 * (n_stages - 1) / pipeline_ticks(n_micro, n_stages)


def stash_depth(n_stages: int) -> int:
    """Max in-flight activations any stage holds under 1F1B: O(S), not
    O(M)."""
    return 2 * (n_stages - 1) + 1


# ------------------------------------------------------------ trees


def tree_paths(tree, prefix=()):
    """``(path, leaf)`` of a nest of dicts (anything else is a leaf), keys
    in sorted order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from tree_paths(tree[key], prefix + (key,))


def tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def tree_put(tree, path, value):
    """``tree`` with ``value`` at ``path`` (in place in a dict; the value
    itself when the path is empty)."""
    if not path:
        return value
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nest of dicts and of trees like it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def spec_tree(specs, tree):
    """``specs`` as a tree like ``tree``: one ``P`` for every leaf, or
    already a tree."""
    if isinstance(specs, dict):
        return specs
    return tree_map(lambda _x: specs, tree)


def slot_values(x, mesh, spec) -> list:
    """Each local slot's box of a leaf: a ``ShardedTensor``'s shards, or
    the blocks of a tensor (this process's box) under ``spec``."""
    if isinstance(x, ShardedTensor):
        return local_shards(x)
    return cut_blocks(x, mesh, spec)


def from_slots(x, vals: list, mesh, spec):
    """A leaf like ``x`` holding each local slot's value ``vals``: a
    ``ShardedTensor`` rebuilt (slots that share a box take the first
    slot's), or this process's box joined from the blocks."""
    if not isinstance(x, ShardedTensor):
        return join_blocks(vals, mesh, spec)
    first = {}
    for j, i in enumerate(mesh.local_slots):
        first.setdefault(id(x.shards[mesh.slots[i]]), vals[j])
    return x.tree_rebuild([first[id(t)] for t in x.tree_children()])


def slot_trees(tree, mesh, specs) -> list:
    """Each local slot's tree of boxes, in slot order."""
    vals = tree_map(lambda x, s: slot_values(x, mesh, s), tree,
                    spec_tree(specs, tree))
    return [tree_map(lambda v, j=j: v[j], vals)
            for j in range(len(mesh.local_slots))]


def trees_from_slots(tree, per_slot: list, mesh, specs):
    """Inverse of :func:`slot_trees` for per-slot trees like ``tree``."""
    specs = spec_tree(specs, tree)
    out = tree_map(lambda x: x, tree)
    for path, x in tree_paths(tree):
        out = tree_put(out, path, from_slots(
            x, [tree_get(t, path) for t in per_slot], mesh,
            tree_get(specs, path)))
    return out


# ------------------------------------------------------------ the slots


class Stash:
    """The stage inputs one slot keeps for its backward replays:
    ``depth`` entries, each written by an F slot and released by the B
    slot that reads it."""

    def __init__(self, depth: int):
        self.entries = [None] * depth

    def put(self, pos: int, x) -> None:
        if self.entries[pos] is not None:
            raise RuntimeError(f"stash entry {pos} is still in use")
        self.entries[pos] = x

    def take(self, pos: int):
        x, self.entries[pos] = self.entries[pos], None
        return x


def stage_groups(mesh, axis: str) -> list:
    """This process's slots by stage: ``[(stage, local positions,
    AxisSlice)]`` in stage order."""
    by: dict = {}
    for j, s in enumerate(col.axis_index(mesh, axis)):
        by.setdefault(s, []).append(j)
    return [(s, js, AxisSlice(mesh, axis, s)) for s, js in sorted(by.items())]


def stage_runner(stage_fn: Callable, with_aux: bool) -> Callable:
    """``run(ps, xs, mesh) -> (ys, auxes or None)`` over one stage's
    slots: ``stage_fn.slots`` when it has one, else ``stage_fn`` slot by
    slot."""
    slots = getattr(stage_fn, "slots", None)

    def run(ps, xs, sub):
        if slots is not None:
            out = slots(ps, xs, sub)
            return tuple(out) if with_aux else (out, None)
        outs = [stage_fn(p, x) for p, x in zip(ps, xs)]
        if with_aux:
            return [o[0] for o in outs], [o[1] for o in outs]
        return outs, None

    return run


def stage_backward(run, ps, xs, sub, *, cts=None, loss_fn=None,
                   heads=None, targets=None) -> tuple:
    """Replay one stage's slots from their inputs ``xs`` under autograd and
    differentiate: the last stage (``loss_fn`` given) its loss (``loss_fn(
    head, y, target)`` with ``heads``, else ``loss_fn(y, target)``) plus
    its aux; a mid stage its outputs against the cotangents ``cts`` and its
    aux against 1.  Returns per slot ``(param grads in tree_paths order,
    dx, head grads or None, loss or None)``."""
    with torch.enable_grad():
        p_leaves = [[leaf.detach().requires_grad_() for _, leaf in
                     tree_paths(p)] for p in ps]
        pt = [tree_rebuilt(p, ls) for p, ls in zip(ps, p_leaves)]
        xl = [x.detach().requires_grad_() for x in xs]
        h_leaves = [[leaf.detach().requires_grad_() for _, leaf in
                     tree_paths(h)] for h in heads] if heads else None
        ys, auxes = run(pt, xl, sub)
        outs, seeds, losses = [], [], None
        if loss_fn is not None:
            losses = []
            for k, y in enumerate(ys):
                loss = (loss_fn(tree_rebuilt(heads[k], h_leaves[k]), y,
                                targets[k]) if heads
                        else loss_fn(y, targets[k]))
                if auxes is not None:
                    loss = loss + auxes[k]
                losses.append(loss)
                outs.append(loss)
                seeds.append(torch.ones_like(loss))
        else:
            for y, ct in zip(ys, cts):
                outs.append(y)
                seeds.append(ct.to(y.dtype))
            for a in auxes or ():
                outs.append(a)
                seeds.append(torch.ones_like(a))
        keep = [k for k, o in enumerate(outs) if o.requires_grad]
        inputs = [leaf for ls in p_leaves for leaf in ls] + xl + [
            leaf for ls in (h_leaves or ()) for leaf in ls]
        grads = list(torch.autograd.grad(
            [outs[k] for k in keep], inputs,
            grad_outputs=[seeds[k] for k in keep], allow_unused=True,
            materialize_grads=True))
    it = iter(grads)

    def take(n):
        return [next(it) for _ in range(n)]

    dps = [take(len(ls)) for ls in p_leaves]
    dxs = take(len(xl))
    return [(dp, dx.float(), take(len(h_leaves[k])) if h_leaves else None,
             None if losses is None else losses[k].detach().float())
            for k, (dp, dx) in enumerate(zip(dps, dxs))]


def tree_rebuilt(like, leaves: list):
    """A tree like ``like`` holding ``leaves`` (in tree_paths order)."""
    out = tree_map(lambda x: x, like)
    for (path, _), leaf in zip(tree_paths(like), leaves):
        out = tree_put(out, path, leaf)
    return out


def accumulate(acc, grads):
    """``acc + grads`` in float32 (``acc`` None: the first grads, copied,
    since autograd may hand back a tensor it also holds)."""
    if acc is None:
        return [g.to(torch.float32, copy=True) for g in grads]
    for a, g in zip(acc, grads):
        a.add_(g)
    return acc


def broadcast_from(vals: list, mesh, axis: str, coord: int, like) -> list:
    """Every slot receives the value of the slot at ``coord`` of its group
    along ``axis`` (the psum of a value only ``coord`` holds), a tree of
    tensors; ``like``: a tree of the value's shape, for a process that
    holds no slot at ``coord``."""
    out = [tree_map(lambda x: x, like) for _ in vals]
    for path, leaf in tree_paths(like):
        got = col.broadcast([None if v is None else tree_get(v, path)
                             for v in vals], mesh, axis, coord, leaf)
        out = [tree_put(o, path, g) for o, g in zip(out, got)]
    return out


# ------------------------------------------------------------ forward


def pipeline_apply(stage_fn: Callable, stage_params: list, microbatches: list,
                   mesh, axis_name: str = "pp") -> list:
    """The forward pipeline over this process's slots, without autograd.

    ``stage_params``: each local slot's stage parameters; ``microbatches``:
    each slot's ``[M, mb, ...]`` stream (only stage 0 reads it).  Returns
    each slot's ``[M, mb, ...]`` outputs on the last stage's slots, None
    on the others."""
    n = mesh.shape[axis_name]
    m = microbatches[0].shape[0]
    run = stage_runner(stage_fn, False)
    groups = stage_groups(mesh, axis_name)
    zero = torch.zeros(microbatches[0].shape[1:],
                       dtype=microbatches[0].dtype,
                       device=microbatches[0].device)
    state = [zero] * len(stage_params)
    outputs = {j: [] for s, js, _ in groups if s == n - 1 for j in js}
    with torch.no_grad():
        for t in range(pipeline_ticks(m, n, train=False)):
            hop = [zero] * len(stage_params)
            for s, js, sub in groups:
                i = t - s
                if not 0 <= i < m:
                    continue
                xs = [microbatches[j][i] if s == 0 else state[j] for j in js]
                ys = run([stage_params[j] for j in js], xs, sub)[0]
                for j, y in zip(js, ys):
                    hop[j] = y.to(zero.dtype)
                    if j in outputs:
                        outputs[j].append(hop[j])
            state = col.ring_shift(hop, mesh, axis_name, 1)
    return [torch.stack(outputs[j]) if j in outputs else None
            for j in range(len(stage_params))]


def make_pipeline(mesh, stage_fn: Callable, axis_name: str = "pp"):
    """Global-view forward pipeline: ``run(stage_params, microbatches) ->
    [M, mb, ...]``.  ``stage_params`` has a leading stage dim split over
    ``axis_name`` (a tree of tensors or of ``ShardedTensor`` s);
    ``microbatches`` is whole on every slot.  The outputs come from the
    last stage's slot only, with no broadcast: a process that holds no
    slot of the last stage gets None."""
    def run(stage_params, microbatches):
        ps = slot_trees(stage_params, mesh, P(axis_name))
        outs = pipeline_apply(stage_fn, ps,
                              [microbatches] * len(ps), mesh, axis_name)
        return next((o for o in outs if o is not None), None)

    return run


# ------------------------------------------------------------ 1F1B


def pipeline_train_apply(stage_fn: Callable, loss_fn: Callable,
                         stage_params: list, inputs: list, targets: list,
                         mesh, axis_name: str = "pp", head_params=None,
                         return_dx: bool = False,
                         with_aux: bool = False) -> tuple:
    """The 1F1B schedule over this process's slots (the JAX package's
    per-device body).

    Every argument is a list over the local slots: ``stage_params`` each
    slot's stage parameters, ``inputs`` its ``[M, mb, ...]`` activation
    microbatches (stage 0 injects them), ``targets`` its ``[M, ...]``
    targets for the last stage's loss (``loss_fn(y, target)``, or with
    ``head_params``, each slot's head, ``loss_fn(head, y, target)``).
    Returns lists ``(losses, dparams[, dhead][, dinputs])``:

    * ``losses``: the mean loss over the microbatches, every stage's aux
      included (psum over the axis);
    * ``dparams``: each slot's gradient of its stage (float32), a tree
      like its parameters;
    * ``dhead``: the head gradient on the last stage's slots, None on the
      others (its psum over the axis is left to the caller, after any
      data-axis mean, which then runs among the last stage's slots only);
    * ``dinputs``: ``[M, mb, ...]`` float32 cotangents of ``inputs`` on
      stage 0's slots, None on the others.

    ``with_aux``: ``stage_fn`` returns ``(y, aux)``, a float32 scalar loss
    term of the stage (the MoE balance term, already scaled).  Every
    stage's aux joins the loss: the F slot adds its value on every stage
    but the last, whose aux joins the loss it differentiates; a mid
    stage's B slot seeds the aux with cotangent 1, so its gradient rides
    the backward hops to every upstream stage."""
    n = mesh.shape[axis_name]
    k = len(stage_params)
    m = inputs[0].shape[0]
    depth = stash_depth(n)
    run = stage_runner(stage_fn, with_aux)
    groups = stage_groups(mesh, axis_name)
    like = inputs[0][0]
    zero_f = torch.zeros(like.shape, dtype=like.dtype, device=like.device)
    zero_b = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
    fwd_in, bwd_in = [zero_f] * k, [zero_b] * k
    stash = [Stash(depth) for _ in range(k)]
    loss_acc = [torch.zeros((), dtype=torch.float32, device=like.device)
                for _ in range(k)]
    dparams, dhead = [None] * k, [None] * k
    dx_buf = [None] * k

    for t in range(pipeline_ticks(m, n, train=True)):
        # ---- F slot: microbatch i = t - stage
        fwd_out = [zero_f] * k
        for s, js, sub in groups:
            i = t - s
            if not 0 <= i < m:
                continue
            xs = [inputs[j][i] if s == 0 else fwd_in[j] for j in js]
            with torch.no_grad():
                ys, auxes = run([stage_params[j] for j in js], xs, sub)
            for q, j in enumerate(js):
                stash[j].put(i % depth, xs[q])
                fwd_out[j] = ys[q].to(like.dtype)
                if auxes is not None and s != n - 1:
                    loss_acc[j] = loss_acc[j] + auxes[q].float()
        fwd_in = col.ring_shift(fwd_out, mesh, axis_name, 1)

        # ---- B slot: microbatch mb = t - 2(n-1) + stage
        bwd_out = [zero_b] * k
        for s, js, sub in groups:
            mb = t - 2 * (n - 1) + s
            if not 0 <= mb < m:
                continue
            xs = [stash[j].take(mb % depth) for j in js]
            ps = [stage_params[j] for j in js]
            if s == n - 1:
                res = stage_backward(
                    run, ps, xs, sub, loss_fn=loss_fn,
                    heads=None if head_params is None
                    else [head_params[j] for j in js],
                    targets=[targets[j][mb] for j in js])
            else:
                res = stage_backward(run, ps, xs, sub,
                                     cts=[bwd_in[j] for j in js])
            for j, (dp, dx, dh, loss) in zip(js, res):
                dparams[j] = accumulate(dparams[j], dp)
                if dh is not None:
                    dhead[j] = accumulate(dhead[j], dh)
                if loss is not None:
                    loss_acc[j] = loss_acc[j] + loss
                if return_dx and s == 0:
                    if dx_buf[j] is None:
                        dx_buf[j] = torch.zeros((m,) + tuple(like.shape),
                                                dtype=torch.float32,
                                                device=like.device)
                    dx_buf[j][mb] = dx
                bwd_out[j] = dx
        bwd_in = col.ring_shift(bwd_out, mesh, axis_name, -1)

    # Only the last stage saw losses: the scalar psum is the one per-step
    # collective beyond the hops.  Cotangents were seeded with 1 per
    # microbatch, so the sums are divided by M for the mean loss (in
    # place: the accumulators are the schedule's own).
    losses = [x / m for x in col.psum(loss_acc, mesh, axis_name)]
    grads = [tree_rebuilt(p, [g.div_(m) for g in acc])
             for p, acc in zip(stage_params, dparams)]
    out = (losses, grads)
    if head_params is not None:
        out += ([None if acc is None else
                 tree_rebuilt(h, [g.div_(m) for g in acc])
                 for h, acc in zip(head_params, dhead)],)
    if return_dx:
        out += ([None if b is None else b.div_(m) for b in dx_buf],)
    return out


def dp_compose(mesh, dp_axis: "str | None", axis_name: str, *,
               with_head: bool, return_dx: bool,
               ep_axis: "str | None" = None, expert_spec=None):
    """Data parallelism for both 1F1B builders (plain and interleaved):
    validates ``dp_axis``, gives the specs of the data, and returns the
    reducer of the per-slot outputs.

    Returns ``(data_spec, dx_spec, dp_reduce)``: inputs and targets split
    their dim 1 (the within-microbatch batch) over the data axes, as does
    the input cotangent the step returns (``dx_spec``); ``dp_reduce``
    averages the loss, the stage gradients and the head gradient over the
    data axes and scales the input cotangents by ``1/ndp`` (each shard's
    cotangent differentiates the averaged loss).

    ``ep_axis``: an expert-parallel data axis: tokens split over it as
    over dp, but the stage leaves marked True in ``expert_spec`` (a tree
    of bools like a stage's parameters) hold different experts on each ep
    slot, so their gradients are not averaged across ep.  The backward of
    the expert all-to-all has already summed every slot's contribution
    into the owner's gradient, so the mean-loss scale is ``grad / ep``
    (then the mean over dp); every other leaf takes the mean over both
    axes."""
    if dp_axis is not None and dp_axis not in mesh.shape:
        raise ValueError(f"dp_axis={dp_axis!r} is not an axis of {mesh.shape}")
    if dp_axis == axis_name:
        # Sharding the batch over the stage axis would run every schedule
        # slot on a different batch slice and a different stage at once.
        raise ValueError(f"dp_axis must differ from the pipeline axis "
                         f"{axis_name!r}")
    if (ep_axis is None) != (expert_spec is None):
        # ep without the mask would average different experts' gradients;
        # the mask without ep has no axis to reduce over.
        raise ValueError("ep_axis and expert_spec must be given together")
    if ep_axis is not None:
        if ep_axis not in mesh.shape:
            raise ValueError(
                f"ep_axis={ep_axis!r} is not an axis of {mesh.shape}")
        if ep_axis in (axis_name, dp_axis):
            raise ValueError(f"ep_axis must differ from the pipeline and dp "
                             f"axes, got {ep_axis!r}")
    axes = tuple(a for a in (dp_axis, ep_axis) if a is not None)
    data_spec = P(None, axes) if axes else P()
    n_data = 1
    for a in axes:
        n_data *= mesh.shape[a]

    def reduce_leaf(vals, is_expert, on):
        if is_expert:
            vals = [g / mesh.shape[ep_axis] for g in vals]
            return col.pmean(vals, on, dp_axis) if dp_axis is not None \
                else vals
        return col.pmean(vals, on, axes)

    def dp_reduce(out):
        """Reduce :func:`pipeline_train_apply`'s lists in place."""
        if not axes:
            return out
        losses = col.pmean(out[0], mesh, axes)
        grads = out[1]
        experts = (dict(tree_paths(expert_spec)) if expert_spec is not None
                   else {})
        for path, _ in tree_paths(grads[0]):
            vals = reduce_leaf([tree_get(g, path) for g in grads],
                               experts.get(path, False), mesh)
            grads = [tree_put(g, path, v) for g, v in zip(grads, vals)]
        rest = list(out[2:])
        if with_head:
            # The head gradient lives on the last stage's slots: averaged
            # among them, then handed to every stage by the caller.
            heads = rest[0]
            last = mesh.shape[axis_name] - 1
            js = [j for j, s in enumerate(col.axis_index(mesh, axis_name))
                  if s == last]
            if js:
                sub = AxisSlice(mesh, axis_name, last)
                for path, _ in tree_paths(heads[js[0]]):
                    vals = reduce_leaf([tree_get(heads[j], path)
                                        for j in js], False, sub)
                    for j, v in zip(js, vals):
                        heads[j] = tree_put(heads[j], path, v)
        if return_dx:
            rest[-1] = [None if d is None else d / n_data for d in rest[-1]]
        return (losses, grads) + tuple(rest)

    return data_spec, data_spec, dp_reduce


def _meta(x):
    """A float32 tensor of ``x``'s shape that holds no memory."""
    return torch.empty(x.shape, dtype=torch.float32, device="meta")


def finish(mesh, axis_name: str, out, *, head_params, head_slots,
           return_dx: bool, data_spec, x) -> tuple:
    """The extras of a reduced step as the caller's: the head gradient
    from the last stage to every slot, laid out like ``head_params``; the
    input cotangent from stage 0 to every slot, this process's box of the
    inputs (``x``: a slot's block of them)."""
    extra = ()
    rest = out[2:]
    if head_params is not None:
        n = mesh.shape[axis_name]
        per = broadcast_from(rest[0], mesh, axis_name, n - 1,
                             tree_map(_meta, head_slots[0]))
        extra += (trees_from_slots(head_params, per, mesh, P()),)
    if return_dx:
        dxs = broadcast_from(rest[-1], mesh, axis_name, 0, _meta(x))
        extra += (join_blocks(dxs, mesh, data_spec),)
    return extra


def make_pipeline_train(mesh, stage_fn: Callable, loss_fn: Callable,
                        axis_name: str = "pp", *, with_head: bool = False,
                        return_dx: bool = False, dp_axis: str | None = None,
                        with_aux: bool = False, ep_axis: str | None = None,
                        param_specs=None, expert_spec=None):
    """Global-view 1F1B training step:
    ``step(stage_params[, head_params], inputs, targets) -> (loss, grads[,
    dhead][, dinputs])``.

    ``stage_params`` (a tree of tensors or of ``ShardedTensor`` s) and
    ``grads`` have a leading stage dim ``[S, ...]`` split over
    ``axis_name``; ``grads`` come back laid out like the params, ready for
    an optimizer.  ``inputs [M, mb, ...]`` and ``targets [M, ...]`` are
    whole on every stage (this process's box of them over the data axes).

    ``with_head``: the step takes a ``head_params`` tree, consumed by
    ``loss_fn(head_params, y, target)`` and returned with its gradient,
    replicated.  ``return_dx``: the ``[M, mb, ...]`` cotangent of
    ``inputs``, to chain into the embedding; stage 0 computes it and every
    process gets it.  Extras are appended in that order.

    ``dp_axis``: pp x dp, each dp group an independent schedule over its
    slice of every microbatch (``mb`` splits over dp, ``M`` stays whole);
    the loss and the gradients are averaged over dp, and ``dinputs`` carry
    the ``1/ndp`` factor.  ``with_aux``: every stage's aux joins the loss
    and the gradients (:func:`pipeline_train_apply`).  ``ep_axis`` with
    ``expert_spec``: tokens also split over an expert-parallel axis, with
    the expert-aware gradient reduction of :func:`dp_compose`.
    ``param_specs``: a ``P`` tree like the stage params for leaves split
    beyond the stage dim (expert tables over ep); default ``P(axis_name)``
    on every leaf."""
    data_spec, dx_spec, dp_reduce = dp_compose(
        mesh, dp_axis, axis_name, with_head=with_head, return_dx=return_dx,
        ep_axis=ep_axis, expert_spec=expert_spec)
    p_spec = P(axis_name) if param_specs is None else param_specs

    def step(stage_params, *args):
        head_params = args[0] if with_head else None
        inputs, targets = args[-2:]
        ps = slot_trees(stage_params, mesh, p_spec)
        hs = slot_trees(head_params, mesh, P()) if with_head else None
        xs = cut_blocks(inputs, mesh, data_spec)
        out = dp_reduce(pipeline_train_apply(
            stage_fn, loss_fn, ps, xs, cut_blocks(targets, mesh, data_spec),
            mesh, axis_name, head_params=hs, return_dx=return_dx,
            with_aux=with_aux))
        grads = trees_from_slots(stage_params, out[1], mesh, p_spec)
        return (out[0][0], grads) + finish(
            mesh, axis_name, out, head_params=head_params, head_slots=hs,
            return_dx=return_dx, data_spec=dx_spec, x=xs[0])

    return step
