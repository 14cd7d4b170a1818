"""Pipeline-parallel Llama training: embedding, the staged decoder
pipeline and the head.

Port of the JAX package's ``models/pp_llama.py``.  1F1B over the mesh's
``"pp"`` axis with every parameter receiving its gradient: the token
embedding (outside the pipeline, chained through the input cotangent the
schedule returns), ``n_layers / n_stages`` decoder blocks a stage
(parallel/pipeline.py), and the head (final norm and ``lm_head``,
differentiated inside the last stage's loss).  A stage runs
:func:`~starway_tpu_torch.models.llama.decoder_block`, the one block body
of every path of the model.

Layout: the parameters live pre-split in pipeline form
(:func:`pp_split_params`)::

    {"embed": [V, D],                             # replicated
     "stages": {name: [n_stages, L/S, ...]},       # dim 0 over pp
     "head": {"final_norm": [D], "lm_head": [D, V]}}  # replicated

so the optimizer state splits the same way and nothing is reshuffled per
step; :func:`pp_merge_params` restores the flat tree.  The interleaved
layout (:func:`ppv_split_params`) has stages ``[V, S, L/(V*S), ...]``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops import collectives as col
from ..parallel.pipeline import tree_map, tree_paths, trees_from_slots
from ..parallel.sharding import P, cut_blocks, local_shards, process_box
from ..reshard.api import ShardedTensor
from .llama import (LlamaConfig, cfg_rope_tables, decoder_block,
                    head_logits, moe_ffn, resolve_attn_fn, token_ce,
                    unstack_layers)


def _reshape(tree, fn):
    """``fn`` over the leaves, a ``ShardedTensor`` assembled first (the
    process must hold all of it)."""
    return tree_map(lambda a: fn(a.full() if isinstance(a, ShardedTensor)
                                 else a), tree)


def _whole(x):
    return x.full() if isinstance(x, ShardedTensor) else x


def pp_split_params(params: dict, n_stages: int) -> dict:
    """Flat ``init_params`` tree -> pipeline layout (module docstring)."""
    layers = params["layers"]
    lead = next(leaf for _, leaf in tree_paths(layers)).shape[0]
    if lead % n_stages:
        raise ValueError(f"n_layers={lead} not divisible by {n_stages} stages")
    stages = _reshape(layers, lambda a: a.reshape(
        n_stages, lead // n_stages, *a.shape[1:]))
    return {
        "embed": params["embed"],
        "stages": stages,
        "head": {"final_norm": params["final_norm"],
                 "lm_head": params["lm_head"]},
    }


def pp_merge_params(pp_params: dict) -> dict:
    """Pipeline layout -> flat ``init_params`` tree (sharded leaves
    assembled)."""
    stages = pp_params["stages"]
    lead = next(leaf for _, leaf in tree_paths(stages))
    n_layers = lead.shape[0] * lead.shape[1]
    return {
        "embed": _whole(pp_params["embed"]),
        "layers": _reshape(stages, lambda a: a.reshape(n_layers,
                                                       *a.shape[2:])),
        "final_norm": _whole(pp_params["head"]["final_norm"]),
        "lm_head": _whole(pp_params["head"]["lm_head"]),
    }


def _moe_stage_template(cfg: LlamaConfig) -> dict:
    """Shape-free skeleton of one MoE stage tree (the keys of
    ``init_params``' layer dict for ``cfg``), enough to build the spec
    trees before any parameters exist."""
    t = {
        "wq": 0, "wk": 0, "wv": 0, "wo": 0,
        "attn_norm": 0, "mlp_norm": 0,
        "moe": {"router": 0, "w_in": 0, "w_out": 0},
    }
    if cfg.moe_swiglu:
        t["moe"]["w_gate"] = 0
    if cfg.attn_bias:
        t.update(bq=0, bk=0, bv=0)
    return t


def _expert_leaf_spec(stages: dict) -> dict:
    """A tree of bools like ``stages``: True on the expert tables
    (``moe/w_in``, ``moe/w_out``, SwiGLU's ``moe/w_gate``), whose rows are
    per expert, False elsewhere (the router included)."""
    def mark(tree, in_moe=False):
        return {k: (mark(v, in_moe or k == "moe") if isinstance(v, dict)
                    else in_moe and k in ("w_in", "w_out", "w_gate"))
                for k, v in tree.items()}

    return mark(stages)


def pp_stage_specs(stages: dict, axis_name: str = "pp",
                   ep_axis: Optional[str] = None) -> dict:
    """``P`` specs of the ``stages`` subtree: every leaf splits its
    leading (stage) dim over ``axis_name``; with ``ep_axis``, the expert
    tables ``[S, L/S, E, ...]`` also split their expert dim."""
    if ep_axis is None:
        return tree_map(lambda _a: P(axis_name), stages)
    return tree_map(lambda is_exp: P(axis_name, None, ep_axis) if is_exp
                    else P(axis_name), _expert_leaf_spec(stages))


def pp_param_specs(pp_params: dict, axis_name: str = "pp",
                   ep_axis: Optional[str] = None) -> dict:
    """The ``P`` tree of the pipeline layout (for parallel/fsdp.py
    ``shard_tree``): stage leaves split their stage dim over
    ``axis_name`` (expert tables also over ``ep_axis``), the embedding and
    the head are replicated."""
    return {
        "embed": P(),
        "stages": pp_stage_specs(pp_params["stages"], axis_name, ep_axis),
        "head": tree_map(lambda _a: P(), pp_params["head"]),
    }


def shard_pp_params(pp_params: dict, mesh, axis_name: str = "pp",
                    ep_axis: Optional[str] = None) -> dict:
    from ..parallel.fsdp import shard_tree

    return shard_tree(pp_params, mesh,
                      pp_param_specs(pp_params, axis_name, ep_axis))


def ppv_split_params(params: dict, n_stages: int, n_chunks: int) -> dict:
    """Flat ``init_params`` tree -> the interleaved layout: stages
    ``[V, S, L/(V*S), ...]``, ``stages[c, d]`` virtual stage ``c*S + d``
    (parallel/interleaved.py's placement)."""
    flat = pp_split_params(params, n_stages * n_chunks)
    return {
        "embed": flat["embed"],
        "stages": _reshape(flat["stages"], lambda a: a.reshape(
            n_chunks, n_stages, *a.shape[1:])),
        "head": flat["head"],
    }


def ppv_merge_params(ppv_params: dict) -> dict:
    return pp_merge_params({
        "embed": ppv_params["embed"],
        "stages": _reshape(ppv_params["stages"], lambda a: a.reshape(
            a.shape[0] * a.shape[1], *a.shape[2:])),
        "head": ppv_params["head"],
    })


def ppv_param_specs(ppv_params: dict, axis_name: str = "pp") -> dict:
    """Specs of the interleaved layout: stage leaves split dim 1 (the
    stage dim) over ``axis_name``; dim 0 (the chunk dim) stays whole."""
    return {
        "embed": P(),
        "stages": tree_map(lambda _a: P(None, axis_name),
                           ppv_params["stages"]),
        "head": tree_map(lambda _a: P(), ppv_params["head"]),
    }


def shard_ppv_params(ppv_params: dict, mesh, axis_name: str = "pp") -> dict:
    from ..parallel.fsdp import shard_tree

    return shard_tree(ppv_params, mesh,
                      ppv_param_specs(ppv_params, axis_name))


def make_pp_stage_fn(cfg: LlamaConfig, attn_fn: Optional[Callable] = None,
                     *, ep_axis: Optional[str] = None) -> Callable:
    """The stage function of the pipeline layout: ``stage_fn(p, h)`` on a
    stage tree ``[1, L/S, ...]`` (its ``chunk`` method on a chunk tree
    ``[L/(V*S), ...]``) runs its layers' decoder blocks on ``h [mb, S,
    D]``, and its ``slots(ps, hs, mesh)`` on a stage's slots.  A dense
    config returns ``h``; an MoE config ``(h, aux)``, the layers' balance
    terms scaled as ``loss_fn``'s (``coef * sum / n_layers``) so that the
    stages' terms add up to it, routed per microbatch (capacity from its
    token count).  ``ep_axis``: the expert tables are the slot's shard
    over that axis of the stage's ``mesh`` and the tokens go to them by
    :func:`~starway_tpu_torch.models.moe.sharded_switch_moe`'s
    all-to-all."""
    attn = resolve_attn_fn(cfg, attn_fn)
    moe = cfg.n_experts > 0

    def attend(qs, ks, vs):
        return [attn(q, k, v) for q, k, v in zip(qs, ks, vs)]

    def run_layers(ps: list, hs: list, mesh) -> tuple:
        cos, sin = cfg_rope_tables(cfg, hs[0].shape[1], device=hs[0].device)
        n_local = next(leaf for _, leaf in tree_paths(ps[0])).shape[0]
        layers = [unstack_layers(p, n_local) for p in ps]

        def moe_slots(xs, ms):
            if ep_axis is None:
                outs = [moe_ffn(x, m, cfg) for x, m in zip(xs, ms)]
                return [y for y, _, _ in outs], [a for _, a, _ in outs], None
            from .moe import _sharded_slots

            ys, auxes = _sharded_slots(
                xs, [m["router"] for m in ms], [m["w_in"] for m in ms],
                [m["w_out"] for m in ms],
                [m["w_gate"] for m in ms] if "w_gate" in ms[0] else None,
                mesh, ep_axis, cfg.moe_capacity_factor, cfg.moe_top_k, False)
            return ys, auxes, None

        auxes = None
        for i in range(n_local):
            hs, layer_aux = decoder_block(
                [lay[i] for lay in layers], hs, cfg, cos, sin, attend,
                moe_slots, lambda ys, _name: ys)[:2]
            if layer_aux is not None:
                auxes = layer_aux if auxes is None else [
                    a + b for a, b in zip(auxes, layer_aux)]
        if moe:
            return hs, [a * (cfg.moe_aux_coef / cfg.n_layers) for a in auxes]
        return hs

    def peel(p):  # a stage tree's leading stage dim of 1
        return tree_map(lambda a: a[0], p)

    def chunk(p, h):
        out = run_layers([p], [h], None)
        return (out[0][0], out[1][0]) if moe else out[0]

    def stage_fn(p, h):
        return chunk(peel(p), h)

    stage_fn.slots = lambda ps, hs, mesh: run_layers([peel(p) for p in ps],
                                                     hs, mesh)
    chunk.slots = run_layers
    stage_fn.chunk = chunk
    return stage_fn


def _embed(e, tokens, cfg: LlamaConfig):
    h = e[tokens]
    if cfg.scaled_embed:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h


def _replicated(x):
    """The tensor of a replicated leaf (a ``ShardedTensor``'s one box)."""
    return local_shards(x)[0] if isinstance(x, ShardedTensor) else x


def make_pp_llama_train(mesh, cfg: LlamaConfig, *, axis_name: str = "pp",
                        n_micro: int, attn_fn: Optional[Callable] = None,
                        n_chunks: int = 1, dp_axis: Optional[str] = None,
                        ep_axis: Optional[str] = None):
    """``step(pp_params, batch) -> (loss, grads)``.

    ``batch``: ``[B, S+1]`` token ids, B divisible by ``n_micro``; every
    process takes the whole batch.  ``grads`` (float32) have the layout of
    ``pp_params`` (a tree of tensors or of ``ShardedTensor`` s from
    :func:`shard_pp_params`): feed them to the optimizer.

    MoE configs (``cfg.n_experts > 0``) pipeline too: each stage owns its
    layers' experts and routes per microbatch, the stages' balance terms
    chain through the schedule like the loss (parallel/pipeline.py
    ``with_aux``), and the step's loss is the mean over microbatches of
    ``loss_fn``'s ``CE + coef * aux / n_layers``.  Without ``ep_axis`` the
    experts are stage-local.  With ``ep_axis`` (pp x ep), each stage's
    expert tables split over ep, the tokens split over ep like a second
    data axis, and the dispatch is the all-to-all of
    :func:`~starway_tpu_torch.models.moe.sharded_switch_moe`, with the
    expert-aware gradient reduction of
    :func:`~starway_tpu_torch.parallel.pipeline.dp_compose`.  Interleaved
    MoE (``n_chunks > 1``) is stage-local.

    ``n_chunks > 1``: the interleaved 1F1B schedule
    (parallel/interleaved.py), ``pp_params`` in :func:`ppv_split_params`'s
    layout.  ``dp_axis``: either schedule composed with data parallelism,
    each microbatch's rows split over dp."""
    from ..parallel.pipeline import make_pipeline_train

    n_stages = mesh.shape[axis_name]
    if cfg.n_layers % (n_stages * n_chunks):
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"{n_stages} stages x {n_chunks} chunks")
    moe = cfg.n_experts > 0
    if moe and n_chunks > 1 and ep_axis is not None:
        raise NotImplementedError(
            "interleaved (n_chunks > 1) MoE is stage-local only; ep "
            "sharding composes with the plain 1F1B schedule")
    if ep_axis is not None and not moe:
        raise ValueError("ep_axis given but cfg.n_experts == 0")
    stage_fn = make_pp_stage_fn(cfg, attn_fn, ep_axis=ep_axis)

    def loss_fn(head, y, target):
        logits = head_logits(y, head["final_norm"], head["lm_head"],
                             cfg.norm_eps)
        return token_ce(logits, target)

    if n_chunks > 1:
        from ..parallel.interleaved import make_interleaved_pipeline_train

        grad_step = make_interleaved_pipeline_train(
            mesh, stage_fn.chunk, loss_fn, axis_name, n_chunks=n_chunks,
            n_micro=n_micro, with_head=True, return_dx=True,
            dp_axis=dp_axis, with_aux=moe)
    else:
        kw = {}
        if moe:
            # Specs for the leaves split beyond the stage dim (expert
            # tables over ep) and the expert mask of the gradient
            # reduction, from a shape-free template of the stage tree.
            template = _moe_stage_template(cfg)
            kw = {"with_aux": True}
            if ep_axis is not None:
                kw.update(
                    ep_axis=ep_axis,
                    expert_spec=_expert_leaf_spec(template),
                    param_specs=pp_stage_specs(template, axis_name, ep_axis))
        grad_step = make_pipeline_train(mesh, stage_fn, loss_fn, axis_name,
                                        with_head=True, return_dx=True,
                                        dp_axis=dp_axis, **kw)
    data = tuple(a for a in (dp_axis, ep_axis) if a is not None)
    data_spec = P(None, data) if data else P()

    def step(pp_params, batch):
        tokens, targets = batch[:, :-1], batch[:, 1:]
        B, S = tokens.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
        mb = B // n_micro
        n_data = 1
        for a in data:
            n_data *= mesh.shape[a]
        if mb % n_data:
            raise ValueError(
                f"microbatch rows ({mb} = {B}/{n_micro}) not divisible by "
                f"the data-sharding size {n_data} (dp x ep)")
        embed = _replicated(pp_params["embed"])
        D = embed.shape[1]
        # This process's box of the batch over the data axes.
        box = process_box(tokens.reshape(n_micro, mb, S), mesh, data_spec)
        h0 = _embed(embed, box, cfg)
        loss, dstages, dhead, dh0 = grad_step(
            pp_params["stages"], pp_params["head"], h0,
            process_box(targets.reshape(n_micro, mb, S), mesh, data_spec))

        # Chain the input cotangent into the embedding table: a float32
        # scatter-add of d h0 over the token ids.  embed_tokens scales h0
        # by sqrt(D) on scaled_embed configs, and the chain rule carries
        # the factor back.
        if cfg.scaled_embed:
            dh0 = dh0 * (D ** 0.5)

        def scatter(tok, dh):
            out = torch.zeros(embed.shape, dtype=torch.float32,
                              device=embed.device)
            return out.index_add_(0, tok.reshape(-1).long(),
                                  dh.reshape(-1, D))

        if not data:
            dembed = scatter(box, dh0)
        else:
            # Each slot adds the rows of its own data block (once a
            # block), and the psum over the data axes sums the blocks: the
            # same sums however the data axes split over processes.
            made, vals = {}, []
            for j, (tok, dh) in enumerate(zip(
                    cut_blocks(box, mesh, data_spec),
                    cut_blocks(dh0, mesh, data_spec))):
                c = mesh.slot_coords(mesh.local_slots[j])
                key = tuple(c[a] for a in data)
                if key not in made:
                    made[key] = scatter(tok, dh)
                vals.append(made[key])
            dembed = col.psum(vals, mesh, data)[0]
        grads = {"embed": trees_from_slots(
            pp_params["embed"], [dembed] * len(mesh.local_slots), mesh, P()),
            "stages": dstages, "head": dhead}
        return loss, grads

    return step
