"""Mixture-of-experts FFN with top-k routing and expert parallelism.

Port of the JAX package's ``models/moe.py``: Switch/GShard-style
static-capacity routing.

* **Dispatch is scatter/gather, not a dense one-hot product.**  Each routed
  (token, choice) gets the slot ``expert * C + position``, and the token
  rows are scattered into an ``[E*C, D]`` buffer (overflow goes to a trash
  row): O(T*k) index work plus the O(E*C*D) buffer, the same function as
  the JAX package's, shapes fixed by ``T``, ``k`` and the capacity factor.
* **Top-k routing** (k=1 Switch, k=2 GShard/Mixtral): first choices take
  capacity priority over second choices; top-2 gates are renormalised over
  the chosen pair.  Ties between router probabilities go to the lower
  expert index, as ``lax.top_k`` breaks them (a stable sort; bf16 router
  probabilities over 8 experts tie often).
* Two views of the same math: :func:`switch_moe`, the global view (one
  process, every expert), and :func:`sharded_switch_moe`, the view of the
  shards of a mesh's ``"ep"`` axis (parallel/sharding.py) with an explicit
  ``all_to_all`` pair (ops/collectives.py); :func:`make_sharded_moe` wraps
  it as ``forward(..., moe_fn=...)``.

The expert products are batched matrix products (``torch.bmm``), as the
JAX package's are ``einsum``s outside any Pallas kernel.  The
load-balancing auxiliary loss is ``E * sum_e(frac_first_choice_e *
mean_router_prob_e)`` (Switch eq. 4).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.collectives import all_to_all, pmean
from .llama import top_k_stable


def init_moe_params(generator: torch.Generator, n_layers: int,
                    n_experts: int, d_model: int, d_ff: int, dtype,
                    swiglu: bool = False) -> dict:
    """The expert subtree: ``router [L, D, E]``, ``w_in [L, E, D, F]``,
    ``w_out [L, E, F, D]`` and, with ``swiglu``, ``w_gate [L, E, D, F]``;
    scaled normals drawn from ``generator`` on its device.  Each leaf is
    filled a layer at a time, so the float32 draw never holds more than one
    layer of it."""
    dev = generator.device

    def norm(shape, scale):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for layer in out:
            w = torch.randn(shape[1:], generator=generator,
                            dtype=torch.float32, device=dev)
            layer.copy_(w.mul_(scale))
            del w
        return out

    L, E, D, Ff = n_layers, n_experts, d_model, d_ff
    out = {
        "router": norm((L, D, E), D ** -0.5),
        "w_in": norm((L, E, D, Ff), D ** -0.5),
        "w_out": norm((L, E, Ff, D), Ff ** -0.5),
    }
    if swiglu:
        # Mixtral-style SwiGLU experts; _expert_ffn keys off the leaf.
        out["w_gate"] = norm((L, E, D, Ff), D ** -0.5)
    return out


def moe_specs(swiglu: bool = False) -> dict:
    """``PartitionSpec``s of the expert subtree: experts shard over the
    "ep" mesh axis, the router is replicated."""
    from ..parallel.sharding import P

    out = {"router": P(None, None, None), "w_in": P(None, "ep", None, None),
           "w_out": P(None, "ep", None, None)}
    if swiglu:
        out["w_gate"] = P(None, "ep", None, None)
    return out


def require_dropless(cfg, context: str) -> None:
    """Raise unless ``cfg`` is dense or provably dropless MoE
    (``moe_capacity_factor >= n_experts``, so capacity >= T * k for any
    token count by :func:`moe_capacity`'s ceiling).  Ragged generation,
    continuous batching and the speculative chunk verify rely on routing
    that does not depend on the forward's shape, which only droplessness
    guarantees."""
    if cfg.n_experts > 0 and cfg.moe_capacity_factor < cfg.n_experts:
        raise ValueError(
            f"{context} needs dense FFNs or provably-dropless MoE: expert "
            f"capacity is computed per forward, so routing could differ "
            f"across forward shapes; set moe_capacity_factor >= n_experts "
            f"(= {cfg.n_experts}) to make drops impossible (the Mixtral "
            f"conversion default)")


def moe_capacity(n_assignments: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Static per-expert capacity for ``n_assignments`` routed (token,
    choice) pairs (``T * k``: GShard scales capacity by k).  A ceiling, so
    that ``capacity_factor >= n_experts`` gives capacity ``>=
    n_assignments`` (the ``1e-9`` keeps an exact quotient from rounding
    up)."""
    return max(1, math.ceil(n_assignments * capacity_factor / n_experts
                            - 1e-9))


def _route(xt, router_w, k: int):
    """Router statistics for ``xt [T, D]``: ``(expert_flat [T*k] int64,
    gate_flat [T*k] float32, aux scalar float32)`` in choice-major order
    (every first choice in token order, then every second choice), so a
    running count over the flat order gives first choices capacity
    priority."""
    e = router_w.shape[-1]
    logits = (xt @ router_w).float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_stable(probs, k)  # [T, k], ties to the lower index
    if k > 1:
        # Mixtral/GShard: renormalise the chosen gates over the pair.
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # Load-balancing aux loss from the first choices (Switch eq. 4).
    frac_tokens = F.one_hot(top_i[:, 0], e).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = e * (frac_tokens * frac_probs).sum()
    return top_i.t().reshape(-1), top_p.t().reshape(-1), aux


def _dispatch_slots(expert_flat, n_experts: int, capacity: int):
    """Slot per routed (token, choice): ``expert * C + position``, where
    ``position`` counts earlier assignments to the same expert in the flat
    order; overflow maps to the trash slot ``E*C``.  Counted in int32.
    Returns ``(slot [T*k] int64, keep [T*k] bool, counts [E] int32)``:
    ``counts`` is each expert's routed total."""
    onehot = F.one_hot(expert_flat, n_experts).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot).sum(
        dim=-1, dtype=torch.int32) - 1
    keep = pos < capacity
    pos = pos.clamp(0, capacity - 1)
    slot = torch.where(keep, expert_flat * capacity + pos,
                       torch.full_like(expert_flat, n_experts * capacity))
    return slot, keep, onehot.sum(dim=0, dtype=torch.int32)


def _scatter_tokens(xt, slot, k: int, n_experts: int, capacity: int):
    """The ``[E*C, D]`` buffer of routed token rows (a trash row takes the
    overflow and is cut off)."""
    t, d = xt.shape
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf[slot] = xt.repeat(k, 1)  # rows in choice-major order, as slot
    return buf[:-1]


def _combine_tokens(y_buf, slot, keep, gate_flat, k: int, t: int):
    """Inverse of :func:`_scatter_tokens`: each routed choice's expert
    output, weighted by its gate (0 where dropped), summed over the k
    choices of a token."""
    y = y_buf[slot.clamp(0, y_buf.shape[0] - 1)]  # [T*k, D]
    w = (gate_flat * keep.float()).to(y.dtype)
    return (y * w[:, None]).reshape(k, t, -1).sum(dim=0)


def _routing_stats(expert_counts, keep) -> dict:
    """Router health from what the dispatch computed: ``drop_fraction``,
    the share of routed pairs over capacity, and ``expert_load [E]``, each
    expert's share of the routed pairs (1/E everywhere is balanced)."""
    load = expert_counts.float() / keep.shape[0]
    drop = 1.0 - keep.float().mean()
    return {"drop_fraction": drop, "expert_load": load}


def _expert_ffn(expert_in, w_in, w_out, w_gate=None):
    """``[E, C', D] -> [E, C', D]`` through each expert's MLP: gelu (tanh
    form, ``jax.nn.gelu``'s default) on ``x @ w_in`` by default, or SwiGLU
    ``(silu(x @ w_gate) * (x @ w_in)) @ w_out`` with ``w_gate [E, D, F]``;
    the activation in float32."""
    cd = expert_in.dtype
    if w_gate is not None:
        g = F.silu(torch.bmm(expert_in, w_gate).float()).to(cd)
        h = g * torch.bmm(expert_in, w_in)
    else:
        h = F.gelu(torch.bmm(expert_in, w_in).float(),
                   approximate="tanh").to(cd)
    return torch.bmm(h, w_out)


def switch_moe(x, router_w, w_in, w_out, *, capacity_factor: float = 1.25,
               k: int = 1, with_stats: bool = False, w_gate=None):
    """``x [B, S, D] -> (y [B, S, D], aux float32 scalar[, stats])``: the
    global view.  Tokens over capacity are dropped (the residual path
    carries them); ``with_stats`` adds :func:`_routing_stats`."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    t = b * s
    xt = x.reshape(t, d)
    capacity = moe_capacity(t * k, e, capacity_factor)

    expert_flat, gate_flat, aux = _route(xt, router_w, k)
    slot, keep, counts = _dispatch_slots(expert_flat, e, capacity)
    expert_in = _scatter_tokens(xt, slot, k, e, capacity).reshape(
        e, capacity, d)
    expert_out = _expert_ffn(expert_in, w_in, w_out, w_gate)
    y = _combine_tokens(expert_out.reshape(e * capacity, d), slot, keep,
                        gate_flat, k, t).reshape(b, s, d)
    if with_stats:
        return y, aux, _routing_stats(counts, keep)
    return y, aux


def _sharded_slots(xs, routers, w_ins, w_outs, w_gates, mesh, axis,
                   capacity_factor, k, with_stats):
    """:func:`sharded_switch_moe` with a router a slot: ``(ys, auxes,
    stats)``, the aux (and stats) of each slot averaged over its group
    along ``axis``."""
    ep = mesh.shape[axis]
    if not (len(xs) == len(w_ins) == len(w_outs)):
        raise ValueError(f"{len(xs)} token shards for {len(w_ins)} expert "
                         f"shards: give this process's shards of {axis!r}")
    if w_gates is None:
        w_gates = [None] * len(xs)
    b, s, d = xs[0].shape
    e_loc = w_ins[0].shape[0]
    e = e_loc * ep
    t = b * s
    capacity = moe_capacity(t * k, e, capacity_factor)

    routed, sends = [], []
    for x, router_w in zip(xs, routers):
        xt = x.reshape(t, d)
        expert_flat, gate_flat, aux = _route(xt, router_w, k)
        slot, keep, counts = _dispatch_slots(expert_flat, e, capacity)
        routed.append((slot, keep, counts, gate_flat, aux))
        sends.append(_scatter_tokens(xt, slot, k, e, capacity).reshape(
            ep, e_loc, capacity, d))
    # The leading axis becomes the source shard.
    recvs = all_to_all(sends, mesh, axis, 0, 0, tiled=False)
    backs = []
    for recv, w_in, w_out, w_gate in zip(recvs, w_ins, w_outs, w_gates):
        # Each local expert sees the rows every shard bucketed for it.
        expert_in = recv.transpose(0, 1).reshape(e_loc, ep * capacity, d)
        expert_out = _expert_ffn(expert_in, w_in, w_out, w_gate)
        backs.append(expert_out.reshape(e_loc, ep, capacity, d)
                     .transpose(0, 1))
    gots = all_to_all(backs, mesh, axis, 0, 0, tiled=False)
    ys = [_combine_tokens(got.reshape(e * capacity, d), slot, keep,
                          gate_flat, k, t).reshape(b, s, d)
          for got, (slot, keep, _c, gate_flat, _a) in zip(gots, routed)]
    if with_stats:
        packed = []
        for slot, keep, counts, _g, aux in routed:
            stats = _routing_stats(counts, keep)
            packed.append(torch.cat([torch.stack(
                [aux, stats["drop_fraction"]]), stats["expert_load"]]))
        return ys, pmean(packed, mesh, axis)
    return ys, pmean([r[4] for r in routed], mesh, axis)


def _unpack(packed) -> tuple:
    return packed[0], {"drop_fraction": packed[1],
                       "expert_load": packed[2:]}


def sharded_switch_moe(xs, router_w, w_ins, w_outs, mesh, axis: str = "ep",
                       *, capacity_factor: float = 1.25, k: int = 1,
                       with_stats: bool = False, w_gates=None):
    """The view of the shards of ``axis``, with an explicit expert
    all-to-all.  Arguments are this process's shards along the axis, in
    the order of ``mesh.local_range(axis)``: ``xs`` tokens ``[B_loc,
    S_loc, D]``; ``w_ins``/``w_outs`` (and ``w_gates``) experts ``[E_loc,
    D, F]``/``[E_loc, F, D]`` (E = E_loc * ep); ``router_w [D, E]`` is
    replicated.  Returns ``(ys, aux[, stats])``: the shards' outputs, and
    the aux (and stats) averaged over the axis.

    Capacity is per (source shard, expert), from the local token count;
    each shard's send buffer is ``[ep, E_loc, C, D]``, one ``all_to_all``
    brings every shard's rows for an expert to the expert's shard, the
    local experts run over ``[E_loc, ep * C, D]``, and a second
    ``all_to_all`` takes the outputs home.  The stats ride the aux's
    ``pmean`` as one packed vector."""
    ys, avg = _sharded_slots(xs, [router_w] * len(xs), w_ins, w_outs,
                             w_gates, mesh, axis, capacity_factor, k,
                             with_stats)
    if with_stats:
        return (ys,) + _unpack(avg[0])
    return ys, avg[0]


def make_sharded_moe(mesh, *, ep_axis: str = "ep", dp_axis: str = "dp",
                     capacity_factor: float = 1.25, k: int = 1,
                     with_stats: bool = False, swiglu: bool = False):
    """``moe_fn(x, router_w, w_in, w_out[, w_gate]) -> (y, aux[, stats])``
    running :func:`sharded_switch_moe` for ``forward(..., moe_fn=...)``:
    the tokens shard over ``(dp_axis, ep_axis)`` (batch over dp, sequence
    over ep), the experts over ``ep_axis``, and the aux (and stats) are
    averaged over every other axis of the mesh, as the JAX package's
    ``shard_map`` replicates them.

    The returned fn takes the global ``x`` and expert tables (this
    process's box of them on a mesh with a process group); its
    ``slots(xs, routers, w_ins, w_outs, w_gates)`` takes the slots' values
    of a sharded tree's forward (models/sharded.py): each slot's tokens
    with the whole sequence and its own experts.  ``with_stats`` returns
    the router health as a third element; ``swiglu`` takes the ``w_gate``
    experts of a Mixtral tree."""
    from ..ops.collectives import all_gather, axis_index
    from ..parallel.sharding import P, cut_blocks, join_blocks

    ep = mesh.shape[ep_axis]
    others = tuple(a for a in mesh.axis_names
                   if a != ep_axis and mesh.shape[a] > 1)
    x_spec = P(dp_axis if dp_axis in mesh.shape else None, ep_axis, None)
    e_spec = P(ep_axis, None, None)

    def check(w_gates):
        if (w_gates[0] is not None) != swiglu:
            raise ValueError(
                f"make_sharded_moe(swiglu={swiglu}) got "
                f"{'a' if w_gates[0] is not None else 'no'} w_gate")

    def run(xs, routers, w_ins, w_outs, w_gates):
        check(w_gates)
        ys, avg = _sharded_slots(
            xs, routers, w_ins, w_outs,
            None if w_gates[0] is None else w_gates, mesh, ep_axis,
            capacity_factor, k, with_stats)
        if others:
            avg = pmean(avg, mesh, others)
        if with_stats:
            auxes = [a[0] for a in avg]
            return ys, auxes, _unpack(avg[0])[1]
        return ys, avg, None

    def slots(xs, routers, w_ins, w_outs, w_gates):
        if xs[0].shape[1] % ep:
            raise ValueError(f"sequence {xs[0].shape[1]} must divide over "
                             f"{ep_axis}={ep}")
        t = xs[0].shape[1] // ep
        blocks = [x[:, i * t:(i + 1) * t]
                  for x, i in zip(xs, axis_index(mesh, ep_axis))]
        ys, auxes, stats = run(blocks, routers, w_ins, w_outs, w_gates)
        return all_gather(ys, mesh, ep_axis, 1), auxes, stats

    def fn(x, router_w, w_in, w_out, w_gate=None):
        if x.shape[1] % ep or w_in.shape[0] % ep:
            raise ValueError(
                f"sequence {x.shape[1]} and experts {w_in.shape[0]} must "
                f"both divide over {ep_axis}={ep}")
        n = len(mesh.local_slots)
        experts = [cut_blocks(w, mesh, e_spec) if w is not None
                   else [None] * n for w in (w_in, w_out, w_gate)]
        ys, auxes, stats = run(cut_blocks(x, mesh, x_spec), [router_w] * n,
                               *experts)
        out = (join_blocks(ys, mesh, x_spec), auxes[0])
        return out + (stats,) if with_stats else out

    fn.slots = slots
    fn.ep_axis = ep_axis
    return fn


def make_expert_view(mesh, *, ep_axis: str = "ep",
                     capacity_factor: float = 1.25, k: int = 1):
    """The experts split over ``ep_axis`` for slots that all hold the same
    tokens (a serving tree's slots, models/sharded.py: the batch rows are
    cut over the data axes, never over ``ep_axis``, so the cut of
    :func:`make_sharded_moe` does not apply to a decode step's one token a
    row).  As ``moe_fn``, the global view (:func:`switch_moe`); its
    ``slots(xs, routers, w_ins, w_outs, w_gates)`` routes the tokens once,
    runs each local shard of experts (one a coordinate of ``ep_axis``) on
    the rows routed to its experts, at :func:`switch_moe`'s capacity over
    all the tokens, and sums the outputs over ``ep_axis``: no expert leaf
    is gathered.  Equal to :func:`switch_moe` on the same tokens up to the
    order of the sum over the k choices (bit for bit at k <= 2)."""
    from ..ops.collectives import axis_index, psum

    def fn(x, router_w, w_in, w_out, w_gate=None):
        return switch_moe(x, router_w, w_in, w_out, w_gate=w_gate,
                          capacity_factor=capacity_factor, k=k)

    def slots(xs, routers, w_ins, w_outs, w_gates):
        b, s, d = xs[0].shape
        t = b * s
        xt = xs[0].reshape(t, d)
        e_loc = w_ins[0].shape[0]
        e = e_loc * mesh.shape[ep_axis]
        capacity = moe_capacity(t * k, e, capacity_factor)
        expert_flat, gate_flat, aux = _route(xt, routers[0], k)
        slot, keep, _counts = _dispatch_slots(expert_flat, e, capacity)
        shards = {}
        for j, c in enumerate(axis_index(mesh, ep_axis)):
            if c in shards:
                continue
            lo = c * e_loc
            mine = keep & (expert_flat >= lo) & (expert_flat < lo + e_loc)
            local = torch.where(mine, slot - lo * capacity,
                                torch.full_like(slot, e_loc * capacity))
            expert_in = _scatter_tokens(xt, local, k, e_loc,
                                        capacity).reshape(e_loc, capacity, d)
            out = _expert_ffn(expert_in, w_ins[j], w_outs[j], w_gates[j])
            shards[c] = _combine_tokens(out.reshape(e_loc * capacity, d),
                                        local, mine, gate_flat, k,
                                        t).reshape(b, s, d)
        ys = psum([shards[c] for c in axis_index(mesh, ep_axis)], mesh,
                  ep_axis)
        return ys, [aux] * len(xs), None

    fn.slots = slots
    fn.ep_axis = ep_axis
    return fn
