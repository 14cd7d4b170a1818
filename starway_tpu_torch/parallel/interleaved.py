"""Interleaved 1F1B: virtual pipeline stages (Megatron-style chunks).

Port of the JAX package's ``parallel/interleaved.py``.  The plain 1F1B
schedule (parallel/pipeline.py) has bubble fraction ``2(S-1) / (M +
2(S-1))``.  Splitting the model into ``V`` chunks per stage slot (virtual
stages) shortens the pipeline's fill to one chunk's flight.

Accounting for this schedule: the tables below give every tick one F and
one B slot on every stage; the port runs only the live ones, but the
ticks still count the critical path.  The greedy schedule sits on the
critical-path lower bound (stage 0's F throughput plus the last
microbatch's chain of 2VS hops), and its win over plain 1F1B on the same
V*S-layer model and the same stages, ticks counted in chunk passes, is
``(V-1)(S-2)`` ticks for M >= S: ``V(M + 2(S-1))`` plain against ``VM +
VS + S - 2`` interleaved.

* **Placement**: virtual stage ``v`` of ``V*S`` lives on stage slot ``v %
  S`` as its chunk ``v // S``.  Consecutive virtual stages sit on
  consecutive slots, so every activation hop is the ring shift the plain
  pipeline uses; the wraps (slot S-1 to slot 0 forward, slot 0 to slot
  S-1 backward) carry the flow into the next chunk.
* **The schedule is two injection sequences**, built and verified on the
  host (pure numpy, :func:`build_interleaved_schedule`, a copy of the JAX
  package's): every F slot follows from the tick its (chunk, microbatch)
  entered slot 0, every B slot from the tick its backward entered slot
  S-1.  The step runs the per-tick slot tables.
* **Stash and inbox are table-indexed**: stage inputs stash per slot for
  the backward replay (free-list positions assigned on the host), and the
  backward wraps queue in a per-chunk ring whose read and write positions
  are in the tables.  Forward wraps need no queue: the exact ``S``
  spacing of chunk entries consumes every wrap the tick it arrives.

The same homogeneous-stage constraint as the plain schedule, and its
stage functions (``stage_fn(p, x)`` on one chunk's parameters, or a
``slots`` method), replay and hops (parallel/pipeline.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops import collectives as col
from .pipeline import (P, Stash, accumulate, dp_compose, finish, slot_trees,
                       stage_backward, stage_groups, stage_runner, tree_map,
                       tree_rebuilt, trees_from_slots)
from .sharding import cut_blocks


@dataclasses.dataclass(frozen=True)
class InterleavedSchedule:
    """Host-built slot program for one (M, S, V).  All arrays [ticks, S]
    int32 unless noted; -1 = no slot this tick."""

    n_micro: int
    n_devices: int
    n_chunks: int
    ticks: int
    stash_depth: int      # per-chunk stash slots
    inbox_depth: int      # per-chunk backward wrap-queue slots
    # F slot: chunk, microbatch, stash slot to write, inject? (device 0
    # chunk 0 reads inputs[i]; every other F consumes the fwd ring carry).
    f_chunk: np.ndarray
    f_micro: np.ndarray
    f_stash: np.ndarray
    f_inject: np.ndarray  # bool [ticks, S]
    # B slot: chunk, microbatch, stash slot to read, final? (loss vjp),
    # wrap-inbox read position (-1 = take the bwd ring carry).
    b_chunk: np.ndarray
    b_micro: np.ndarray
    b_stash: np.ndarray
    b_final: np.ndarray   # bool
    b_inbox_rd: np.ndarray
    # Backward wrap WRITE: where tick t's incoming bwd ppermute lands
    # (only ever valid on device S-1): chunk, ring position.
    w_chunk: np.ndarray
    w_pos: np.ndarray


def build_interleaved_schedule(m: int, s: int, v: int) -> InterleavedSchedule:
    """Build + verify the slot program (pure numpy, cache-friendly args)."""
    if m < 1 or s < 1 or v < 1:
        raise ValueError(f"need m,s,v >= 1, got {(m, s, v)}")

    # ---- forward injections at device 0: groups of up to S microbatches,
    # chunk-major inside a group, stride V*S per full group.  Spacing of a
    # microbatch's chunk entries is EXACTLY S -> wraps consumed on arrival.
    entry0 = np.zeros((v, m), np.int64)
    base = 0
    for g0 in range(0, m, s):
        gsz = min(s, m - g0)
        for c in range(v):
            for i in range(gsz):
                entry0[c, g0 + i] = base + c * s + i
        base += v * s  # uniform stride, even for a partial last group

    # ---- backward injections at device S-1: greedy, lowest chunk first
    # (drain depth-first frees stash earliest).  Chunk V-1 of microbatch j
    # becomes ready the tick its forward REACHES device S-1 (the loss-vjp
    # slot recomputes from the stash written that same tick); chunk c < V-1
    # becomes ready when chunk c+1's backward wrap ARRIVES
    # (binj(c+1) + S-1 done at device 0, +1 for the hop).
    f_done = entry0 + (s - 1)          # F tick at device S-1 per (c, j)
    binj = -np.ones((v, m), np.int64)
    ready = {(v - 1, j): int(f_done[v - 1, j]) for j in range(m)}
    t = 0
    remaining = v * m
    # The loop injects at most one backward per tick, so it NEEDS ~v*m
    # ticks; the horizon must scale with that (a bound in m alone
    # spuriously failed valid v >= 5 configs at large m).
    horizon = (v * m + v * s * max(v, s) + 64) * 4
    while remaining and t < horizon:
        # one backward injection per tick max (device S-1's single B slot)
        cand = [(c, j) for (c, j), rt in ready.items() if rt <= t]
        if cand:
            c, j = min(cand, key=lambda cj: (cj[0], cj[1]))
            del ready[(c, j)]
            binj[c, j] = t
            remaining -= 1
            if c > 0:
                # wrap finishes the chunk at device 0 at t + S-1, arrives
                # back at device S-1 next tick.
                ready[(c - 1, j)] = t + s
        t += 1
    if remaining:
        raise RuntimeError("interleaved schedule failed to converge "
                           f"(m={m}, s={s}, v={v})")

    ticks = int(max(binj.max() + s, entry0.max() + s))

    # ---- per-device slot tables --------------------------------------
    f_chunk = -np.ones((ticks, s), np.int32)
    f_micro = -np.ones((ticks, s), np.int32)
    f_inject = np.zeros((ticks, s), bool)
    b_chunk = -np.ones((ticks, s), np.int32)
    b_micro = -np.ones((ticks, s), np.int32)
    b_final = np.zeros((ticks, s), bool)
    for c in range(v):
        for i in range(m):
            for d in range(s):
                tf = int(entry0[c, i]) + d
                assert f_chunk[tf, d] == -1, "F slot collision"
                f_chunk[tf, d] = c
                f_micro[tf, d] = i
                f_inject[tf, d] = (d == 0 and c == 0)
                tb = int(binj[c, i]) + (s - 1 - d)
                assert b_chunk[tb, d] == -1, "B slot collision"
                b_chunk[tb, d] = c
                b_micro[tb, d] = i
                b_final[tb, d] = (d == s - 1 and c == v - 1)

    # ---- stash slots: free-list per (device is uniform: F at device d is
    # entry0+d, B at binj+(s-1-d); the in-flight WINDOW is widest at
    # device 0 for F / also fine to compute per device and take the max).
    stash_sl = -np.ones((ticks, s), np.int32)   # slot written by F
    stash_rd = -np.ones((ticks, s), np.int32)   # slot read by B
    depth = 0
    for d in range(s):
        slot_of = {}
        free: list = []
        next_new = 0
        for t in range(ticks):
            if f_chunk[t, d] >= 0:
                key = (int(f_chunk[t, d]), int(f_micro[t, d]))
                if free:
                    sl = free.pop()
                else:
                    sl = next_new
                    next_new += 1
                slot_of[key] = sl
                stash_sl[t, d] = sl
            if b_chunk[t, d] >= 0:
                key = (int(b_chunk[t, d]), int(b_micro[t, d]))
                sl = slot_of.pop(key)
                stash_rd[t, d] = sl
                free.append(sl)
        depth = max(depth, next_new)

    # ---- backward wrap inbox (device S-1 only): a B of chunk c>=1 done
    # at device 0 at tick t lands at device S-1 at t+1 for chunk c-1;
    # consumed at binj[c-1, j].  FIFO ring per chunk, positions baked in.
    w_chunk = -np.ones((ticks, s), np.int32)
    w_pos = -np.ones((ticks, s), np.int32)
    b_inbox_rd = -np.ones((ticks, s), np.int32)
    inbox_depth = 1
    wr = np.zeros(v, np.int64)
    rd = np.zeros(v, np.int64)
    pos_of = {}
    for t in range(ticks):
        # arrival first (ppermute from the previous tick's device-0 B)...
        if t > 0 and b_chunk[t - 1, 0] >= 1:
            c_arr = int(b_chunk[t - 1, 0]) - 1
            w_chunk[t, s - 1] = c_arr  # position filled in the second pass
            pos_of[(c_arr, int(b_micro[t - 1, 0]))] = int(wr[c_arr])
            wr[c_arr] += 1
        # ...then consumption by this tick's B slot at device S-1.
        if b_chunk[t, s - 1] >= 0 and not b_final[t, s - 1]:
            c = int(b_chunk[t, s - 1])
            j = int(b_micro[t, s - 1])
            if c == v - 1:
                raise AssertionError("non-final B at chunk V-1, device S-1")
            abs_pos = pos_of.pop((c, j))
            assert abs_pos == rd[c], "inbox consumed out of FIFO order"
            b_inbox_rd[t, s - 1] = abs_pos  # ring-reduced after sizing
            rd[c] += 1
            inbox_depth = max(inbox_depth, int((wr - rd).max()) + 1)
    # size the ring, then assign positions modulo the final depth
    wr = np.zeros(v, np.int64)
    for t in range(ticks):
        if w_chunk[t, s - 1] >= 0:
            w_pos[t, s - 1] = int(wr[w_chunk[t, s - 1]] % inbox_depth)
            wr[w_chunk[t, s - 1]] += 1
    rd = np.zeros(v, np.int64)
    for t in range(ticks):
        if b_inbox_rd[t, s - 1] >= 0:
            c = int(b_chunk[t, s - 1])
            b_inbox_rd[t, s - 1] = int(rd[c] % inbox_depth)
            rd[c] += 1

    return InterleavedSchedule(
        n_micro=m, n_devices=s, n_chunks=v, ticks=ticks,
        stash_depth=max(depth, 1), inbox_depth=inbox_depth,
        f_chunk=f_chunk, f_micro=f_micro, f_stash=stash_sl,
        f_inject=f_inject, b_chunk=b_chunk, b_micro=b_micro,
        b_stash=stash_rd, b_final=b_final, b_inbox_rd=b_inbox_rd,
        w_chunk=w_chunk, w_pos=w_pos,
    )


def interleaved_train_apply(stage_fn: Callable, loss_fn: Callable,
                            stage_params: list, inputs: list, targets: list,
                            mesh, axis_name: str,
                            sched: InterleavedSchedule, head_params=None,
                            return_dx: bool = False,
                            with_aux: bool = False) -> tuple:
    """The interleaved schedule over this process's slots.

    ``stage_params``: each local slot's chunks, leaves with a leading dim
    V (chunk ``c`` is virtual stage ``c*S + d`` of the slot at stage ``d``).
    ``inputs``, ``targets``, ``head_params`` and the returned lists follow
    :func:`~starway_tpu_torch.parallel.pipeline.pipeline_train_apply`:
    ``(losses, dparams [V, ...][, dhead][, dinputs])``; ``dinputs`` are
    the chunk-0 backwards of stage 0.  ``with_aux``: every virtual stage's
    aux joins the loss as in the plain schedule, the last virtual stage's
    inside its loss."""
    s, v, m = sched.n_devices, sched.n_chunks, sched.n_micro
    k = len(stage_params)
    run = stage_runner(stage_fn, with_aux)
    groups = stage_groups(mesh, axis_name)
    like = inputs[0][0]
    zero_f = torch.zeros(like.shape, dtype=like.dtype, device=like.device)
    zero_b = torch.zeros(like.shape, dtype=torch.float32, device=like.device)
    fwd_in, bwd_in = [zero_f] * k, [zero_b] * k
    stash = [Stash(sched.stash_depth) for _ in range(k)]
    inbox = [[[None] * sched.inbox_depth for _ in range(v)]
             for _ in range(k)]
    loss_acc = [torch.zeros((), dtype=torch.float32, device=like.device)
                for _ in range(k)]
    dparams = [[None] * v for _ in range(k)]
    dhead, dx_buf = [None] * k, [None] * k
    chunks = [[tree_map(lambda a, c=c: a[c], p) for c in range(v)]
              for p in stage_params]

    for t in range(sched.ticks):
        for d, js, _ in groups:
            # The backward wrap arrives at stage S-1: file last tick's
            # cotangent into its chunk's ring before any use.
            wc = int(sched.w_chunk[t, d])
            if wc >= 0:
                for j in js:
                    inbox[j][wc][int(sched.w_pos[t, d])] = bwd_in[j]

        # ---- F slot
        fwd_out = [zero_f] * k
        for d, js, sub in groups:
            fc, fi = int(sched.f_chunk[t, d]), int(sched.f_micro[t, d])
            if fc < 0:
                continue
            xs = [inputs[j][fi] if sched.f_inject[t, d] else fwd_in[j]
                  for j in js]
            with torch.no_grad():
                ys, auxes = run([chunks[j][fc] for j in js], xs, sub)
            last_vstage = d == s - 1 and fc == v - 1
            for q, j in enumerate(js):
                stash[j].put(int(sched.f_stash[t, d]), xs[q])
                fwd_out[j] = ys[q].to(like.dtype)
                if auxes is not None and not last_vstage:
                    loss_acc[j] = loss_acc[j] + auxes[q].float()
        fwd_in = col.ring_shift(fwd_out, mesh, axis_name, 1)

        # ---- B slot
        bwd_out = [zero_b] * k
        for d, js, sub in groups:
            bc, bj = int(sched.b_chunk[t, d]), int(sched.b_micro[t, d])
            if bc < 0:
                continue
            xs = [stash[j].take(int(sched.b_stash[t, d])) for j in js]
            ps = [chunks[j][bc] for j in js]
            if sched.b_final[t, d]:
                res = stage_backward(
                    run, ps, xs, sub, loss_fn=loss_fn,
                    heads=None if head_params is None
                    else [head_params[j] for j in js],
                    targets=[targets[j][bj] for j in js])
            else:
                rd = int(sched.b_inbox_rd[t, d])
                cts = []
                for j in js:
                    if rd >= 0:
                        ct, inbox[j][bc][rd] = inbox[j][bc][rd], None
                    else:
                        ct = bwd_in[j]
                    cts.append(ct)
                res = stage_backward(run, ps, xs, sub, cts=cts)
            for j, (dp, dx, dh, loss) in zip(js, res):
                dparams[j][bc] = accumulate(dparams[j][bc], dp)
                if dh is not None:
                    dhead[j] = accumulate(dhead[j], dh)
                if loss is not None:
                    loss_acc[j] = loss_acc[j] + loss
                if return_dx and d == 0 and bc == 0:
                    if dx_buf[j] is None:
                        dx_buf[j] = torch.zeros((m,) + tuple(like.shape),
                                                dtype=torch.float32,
                                                device=like.device)
                    dx_buf[j][bj] = dx
                bwd_out[j] = dx
        bwd_in = col.ring_shift(bwd_out, mesh, axis_name, -1)

    losses = [x / m for x in col.psum(loss_acc, mesh, axis_name)]
    grads = []
    for p, acc in zip(stage_params, dparams):
        # The chunks' accumulators stacked [V, ...], each freed as it goes.
        leaves = []
        for i in range(len(acc[0])):
            leaves.append(torch.stack([a[i] for a in acc]).div_(m))
            for a in acc:
                a[i] = None
        grads.append(tree_rebuilt(p, leaves))
    out = (losses, grads)
    if head_params is not None:
        out += ([None if acc is None else
                 tree_rebuilt(h, [g.div_(m) for g in acc])
                 for h, acc in zip(head_params, dhead)],)
    if return_dx:
        out += ([None if b is None else b.div_(m) for b in dx_buf],)
    return out


def make_interleaved_pipeline_train(mesh, stage_fn: Callable,
                                    loss_fn: Callable,
                                    axis_name: str = "pp", *,
                                    n_chunks: int, n_micro: int,
                                    with_head: bool = False,
                                    return_dx: bool = False,
                                    dp_axis: str | None = None,
                                    with_aux: bool = False):
    """Global-view interleaved-1F1B training step.

    ``stage_params``: ``[V, S, ...]`` leaves, ``stage_params[c, d]``
    virtual stage ``c*S + d`` (stage slot d's chunk c), dim 1 split over
    ``axis_name``.  Returns ``step(stage_params[, head_params], inputs,
    targets) -> (loss, grads[, dhead][, dinputs])`` with the grads laid
    out like the params; ``with_head``, ``return_dx`` and ``dp_axis``
    follow :func:`~starway_tpu_torch.parallel.pipeline.make_pipeline_train`.
    ``n_micro`` is fixed: the slot tables are built for it; inputs
    ``[M, mb, ...]``."""
    s = mesh.shape[axis_name]
    sched = build_interleaved_schedule(n_micro, s, n_chunks)
    data_spec, dx_spec, dp_reduce = dp_compose(
        mesh, dp_axis, axis_name, with_head=with_head, return_dx=return_dx)
    spec = P(None, axis_name)

    def peel(tree):
        # Each slot's box is [V, 1, ...]: its chunks, [V, ...].
        return tree_map(lambda a: a[:, 0], tree)

    def unpeel(tree):
        return tree_map(lambda a: a[:, None], tree)

    def step(stage_params, *args):
        head_params = args[0] if with_head else None
        inputs, targets = args[-2:]
        ps = [peel(p) for p in slot_trees(stage_params, mesh, spec)]
        hs = slot_trees(head_params, mesh, P()) if with_head else None
        xs = cut_blocks(inputs, mesh, data_spec)
        out = dp_reduce(interleaved_train_apply(
            stage_fn, loss_fn, ps, xs, cut_blocks(targets, mesh, data_spec),
            mesh, axis_name, sched, head_params=hs, return_dx=return_dx,
            with_aux=with_aux))
        grads = trees_from_slots(stage_params, [unpeel(g) for g in out[1]],
                                 mesh, spec)
        return (out[0][0], grads) + finish(
            mesh, axis_name, out, head_params=head_params, head_slots=hs,
            return_dx=return_dx, data_spec=dx_spec, x=xs[0])

    return step
