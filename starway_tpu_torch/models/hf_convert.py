"""HuggingFace Llama-family checkpoints -> the port's parameter tree.

Six families convert into the stacked-layer tree models/llama.py serves
and trains: ``LlamaForCausalLM``; ``MistralForCausalLM`` (its
``sliding_window``); ``Qwen2ForCausalLM`` (q/k/v projection biases ->
``cfg.attn_bias`` and the ``bq``/``bk``/``bv`` leaves);
``MixtralForCausalLM`` (SwiGLU top-k experts -> ``cfg.moe_swiglu`` and a
``moe`` subtree, with a dropless capacity, served by models/moe.py);
``GemmaForCausalLM`` (GeGLU, the
``x * (1 + w)`` RMSNorm folded into the weights, sqrt(d_model)-scaled
embeddings); and ``Phi3ForCausalLM`` (fused ``qkv_proj`` /
``gate_up_proj`` sliced into separate projections).  ``config_from_hf``
derives the :class:`LlamaConfig`, with decoupled ``head_dim`` and the
linear, llama3, yarn and longrope ``rope_scaling`` kinds; every config the
tree cannot represent is refused rather than converted into another model.

HF's rotate-half rope is the convention of ``llama.apply_rope``, so the
q/k projections carry over unpermuted; HF ``nn.Linear`` weights are
``[out, in]`` and this tree's ``[in, out]``, so every projection is
transposed.  A tied head follows the embedding.  ``transformers`` is not
imported here: a model is read through its ``state_dict()`` and config
attributes.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .llama import LlamaConfig


def config_from_hf(hf_config: Any, **overrides) -> LlamaConfig:
    """LlamaConfig from a ``transformers.LlamaConfig``-shaped object.

    Refuses configs this model family cannot represent — silently dropping
    them would produce a numerically wrong model (the failure mode this
    module exists to prevent)."""
    if getattr(hf_config, "mlp_bias", False):
        raise NotImplementedError(
            "MLP biases are not represented in this parameter tree")
    model_type = getattr(hf_config, "model_type", "")
    if model_type in ("gemma2", "gemma3", "gemma3_text"):
        # Must precede the activation check, or these fall into the
        # generic hidden_act error with a misleading message.
        raise NotImplementedError(
            f"{model_type} adds logit soft-capping and pre/post "
            "feed-forward norms this tree does not represent; gemma (v1) "
            "converts")
    act = (getattr(hf_config, "hidden_activation", None)
           or getattr(hf_config, "hidden_act", "silu"))
    if act in ("silu", "swish"):
        mlp_act = "silu"
    elif act in ("gelu_pytorch_tanh", "gelu_tanh") and model_type == "gemma":
        mlp_act = "gelu_tanh"  # Gemma's GeGLU
    else:
        raise NotImplementedError(
            f"hidden_act={act!r} on model_type={model_type!r}; this family "
            "is gated-MLP with silu (Llama) or gelu_tanh (Gemma)")
    # Qwen2-family checkpoints attach q/k/v biases (cfg.attn_bias ->
    # bq/bk/bv leaves; Qwen2's o_proj carries NO bias, so the tree is
    # complete).  A generic attention_bias=True config is a DIFFERENT
    # shape: HF Llama then puts a bias on o_proj too, which this tree
    # does not represent — refuse rather than silently drop it.
    attn_bias = model_type == "qwen2"
    if getattr(hf_config, "attention_bias", False) and not attn_bias:
        raise NotImplementedError(
            "attention_bias=True on a non-Qwen2 config also biases o_proj, "
            "which this parameter tree does not represent; converting "
            "would silently drop it")
    # Qwen2 gates its sliding_window on use_sliding_window (default
    # False), and even then windows only the layers PAST
    # max_window_layers — a mixed pattern cfg.sliding_window (global)
    # cannot express.  Honour the gate; refuse the mixed case.
    sliding = getattr(hf_config, "sliding_window", None)
    if sliding is not None and hasattr(hf_config, "use_sliding_window"):
        mwl = getattr(hf_config, "max_window_layers", 0) or 0
        if not hf_config.use_sliding_window:
            sliding = None
        elif mwl >= hf_config.num_hidden_layers:
            sliding = None  # "first mwl layers full" covers every layer
        elif mwl > 0:
            raise NotImplementedError(
                f"use_sliding_window with max_window_layers={mwl} windows "
                f"only layers past it; this config represents a single "
                "global sliding_window")
    prf = getattr(hf_config, "partial_rotary_factor", None)
    if prf is not None and float(prf) != 1.0:
        raise NotImplementedError(
            f"partial_rotary_factor={prf} rotates only part of each head; "
            "this tree applies rope to the full head dim")
    # Newer HF configs may pin an explicit per-head dim decoupled from
    # hidden_size // num_attention_heads; llama.py keys every
    # projection/reshape off cfg.head_dim, so the override carries it.
    explicit_hd = getattr(hf_config, "head_dim", None)
    derived_hd = (hf_config.hidden_size // hf_config.num_attention_heads
                  if hf_config.hidden_size % hf_config.num_attention_heads == 0
                  else None)
    if explicit_hd is None and derived_hd is None:
        raise NotImplementedError(
            f"hidden_size={hf_config.hidden_size} is not divisible by "
            f"num_attention_heads={hf_config.num_attention_heads} and the "
            "config pins no explicit head_dim")
    kw = dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads",
                           hf_config.num_attention_heads),
        d_ff=hf_config.intermediate_size,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
        # Mistral-family configs carry sliding_window; same architecture
        # otherwise, so the converter serves both families.
        sliding_window=sliding,
        attn_bias=attn_bias,
        head_dim_override=(explicit_hd if explicit_hd is not None
                           and explicit_hd != derived_hd else None),
        rope_scaling=_rope_scaling_from_hf(
            getattr(hf_config, "rope_scaling", None),
            getattr(hf_config, "max_position_embeddings", None),
            getattr(hf_config, "original_max_position_embeddings", None)),
        mlp_act=mlp_act,
        # Gemma scales the embedding OUTPUT by sqrt(d_model); the tied
        # lm_head reads the raw table, so it is a runtime flag, not a
        # weight fold.
        scaled_embed=model_type == "gemma",
    )
    if model_type == "mixtral":
        # Mixtral: SwiGLU experts, top-k routing with softmax-then-topk
        # renormalisation.  HF routes dropless;
        # capacity_factor = n_experts makes our static capacity provably
        # dropless (capacity = T * k) so converted models match
        # transformers token for token.  Lower it for capacity-bound
        # training throughput at the cost of that guarantee.
        kw.update(
            n_experts=hf_config.num_local_experts,
            moe_top_k=hf_config.num_experts_per_tok,
            moe_swiglu=True,
            moe_capacity_factor=float(hf_config.num_local_experts),
            moe_aux_coef=float(getattr(hf_config, "router_aux_loss_coef",
                                       0.001)),
        )
    kw.update(overrides)
    return LlamaConfig(**kw)


def _rope_scaling_from_hf(scaling, max_position_embeddings=None,
                          original_max_position_embeddings=None) -> "tuple | None":
    """HF ``rope_scaling`` dict -> LlamaConfig's hashable tuple.

    Implemented kinds: ``linear`` (position interpolation), ``llama3``
    (the Llama-3.1 banded scheme), ``yarn`` (NTK-by-parts,
    Qwen2.5-long / DeepSeek-family), and ``longrope`` (per-dim factor
    lists, Phi-3.5/128k line; see llama.py:rope_tables).  yarn's
    ``attention_factor`` is resolved HERE, HF-identically — explicit
    value wins, then the mscale/mscale_all_dim ratio (DeepSeek), then
    the paper default ``0.1*ln(factor)+1`` — so the config tuple carries
    one final float.  Anything else (dynamic, ...) still refuses —
    silently dropping a scaling scheme would change the rope
    frequencies vs transformers, the exact failure mode this module
    exists to prevent."""
    if not scaling:
        return None
    kind = scaling.get("rope_type", scaling.get("type"))
    if kind == "linear":
        return ("linear", float(scaling["factor"]))
    if kind == "llama3":
        return ("llama3", float(scaling["factor"]),
                float(scaling["low_freq_factor"]),
                float(scaling["high_freq_factor"]),
                float(scaling["original_max_position_embeddings"]))
    if kind == "yarn":
        factor = float(scaling["factor"])
        att = scaling.get("attention_factor")
        mscale = scaling.get("mscale")
        mscale_all_dim = scaling.get("mscale_all_dim")

        def get_mscale(scale, m=1.0):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

        if att is None:
            if mscale and mscale_all_dim:
                att = get_mscale(factor, mscale) / get_mscale(
                    factor, mscale_all_dim)
            else:
                att = get_mscale(factor)
        orig = (scaling.get("original_max_position_embeddings")
                or max_position_embeddings)
        if orig is None:
            raise ValueError(
                "yarn rope_scaling needs original_max_position_embeddings "
                "(in the scaling dict or the model config)")
        return ("yarn", factor, float(orig),
                float(scaling.get("beta_fast") or 32),
                float(scaling.get("beta_slow") or 1),
                float(att), bool(scaling.get("truncate", True)))
    if kind == "longrope":
        short = tuple(float(x) for x in scaling["short_factor"])
        long = tuple(float(x) for x in scaling["long_factor"])
        # HF: Phi3-style configs carry original_max_position_embeddings
        # at the CONFIG level and derive factor from the max/orig ratio;
        # otherwise the scaling dict's factor applies and orig = max.
        orig = original_max_position_embeddings
        if orig:
            factor = float(max_position_embeddings) / float(orig)
        else:
            orig = max_position_embeddings
            factor = scaling.get("factor")
        if orig is None or factor is None:
            raise ValueError(
                "longrope rope_scaling needs original_max_position_"
                "embeddings (config level) or an explicit factor")
        att = scaling.get("attention_factor")
        if att is None:
            att = (1.0 if factor <= 1.0
                   else math.sqrt(1.0 + math.log(factor) / math.log(orig)))
        # NOTE: the regime (short vs long factors) is chosen per rope
        # table by its seq_len (llama.py rope_tables).  A generation
        # whose horizon crosses orig uses one regime for the whole run;
        # HF switches per step on such runs and diverges there.
        return ("longrope", float(orig), float(att), short, long)
    if kind == "default":
        # transformers normalises "no scaling" configs to
        # {"rope_type": "default"} in some versions.
        return None
    raise NotImplementedError(
        f"rope_scaling={scaling!r} is not implemented here (linear, "
        "llama3, yarn, and longrope are); converting would silently "
        "change the rope frequencies vs transformers")


def params_from_hf(model_or_state: Any, cfg: LlamaConfig, dtype=None, *,
                   quantize: str = "none", norm_plus_one: "bool | None" = None,
                   device="cuda") -> dict:
    """Convert a ``LlamaForCausalLM`` (or another family above), or its
    ``state_dict()`` of torch tensors with or without the ``model.``
    prefix, into the stacked-layer tree on ``device``, cast to ``dtype``
    (a torch dtype or its name; default ``cfg.compute_dtype``).

    Every leaf is made on ``device`` one layer at a time: each source
    tensor goes there, widens to float32 (where a transpose or the Gemma
    fold happens) and is cast into its slot of the stacked leaf, so the
    scratch is one layer's float32 tensor and no second copy of the model
    is made.  The values are those of converting through float32 and
    casting once.

    ``quantize="int8"`` returns the W8A16 serving tree
    (ops/quantize.py ``quantize_params``).  ``norm_plus_one`` folds
    Gemma's ``x * (1 + w)`` RMSNorm into ``w' = 1 + w``; it defaults to
    ``cfg.scaled_embed``, which ``config_from_hf`` sets for Gemma only, so
    state dicts fold too."""
    if quantize not in ("none", "int8"):
        raise ValueError(f"quantize must be 'none' or 'int8', got {quantize!r}")
    if norm_plus_one is None:
        norm_plus_one = cfg.scaled_embed
    if hasattr(model_or_state, "state_dict"):
        state = dict(model_or_state.state_dict())
    else:
        state = dict(model_or_state)
    prefix = "model." if any(k.startswith("model.") for k in state) else ""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    dt = dtype if dtype is not None else cfg.compute_dtype
    dev = torch.device(device)
    L = cfg.n_layers

    def get(name):
        return state[prefix + name]

    def wide(t):
        return torch.as_tensor(t).detach().to(device=dev).float()

    def leaf(x):
        """A float32 tensor as a leaf: ``dt``, contiguous, on ``dev``."""
        return torch.empty(x.shape, dtype=dt, device=dev).copy_(x)

    def stacked(name, fn=lambda w: w.t()):
        """``[L, ...]`` of ``fn(layer i's tensor in float32)``."""
        out = None
        for i in range(L):
            w = fn(wide(get(name.format(i))))
            if out is None:
                out = torch.empty((L, *w.shape), dtype=dt, device=dev)
            out[i].copy_(w)
        return out

    def norm(name):
        return stacked(name, (lambda w: w + 1.0) if norm_plus_one
                       else (lambda w: w))

    fused = prefix + "layers.0.self_attn.qkv_proj.weight" in state
    if fused:
        if (prefix + "layers.0.self_attn.qkv_proj.bias" in state
                or prefix + "layers.0.mlp.gate_up_proj.bias" in state):
            raise NotImplementedError(
                "fused qkv_proj/gate_up_proj biases are not represented "
                "in this parameter tree; converting would silently drop "
                "them")
        # Phi-3: qkv_proj [(Hq + 2 Hkv) * hd, D], q then k then v rows.
        nq = cfg.n_heads * cfg.head_dim
        nkv = cfg.n_kv_heads * cfg.head_dim
        qkv = "layers.{}.self_attn.qkv_proj.weight"
        layers = {
            "wq": stacked(qkv, lambda w: w[:nq].t()),
            "wk": stacked(qkv, lambda w: w[nq:nq + nkv].t()),
            "wv": stacked(qkv, lambda w: w[nq + nkv:nq + 2 * nkv].t()),
        }
    else:
        layers = {name: stacked(f"layers.{{}}.self_attn.{proj}.weight")
                  for name, proj in (("wq", "q_proj"), ("wk", "k_proj"),
                                     ("wv", "v_proj"))}
    layers.update(
        wo=stacked("layers.{}.self_attn.o_proj.weight"),
        attn_norm=norm("layers.{}.input_layernorm.weight"),
        mlp_norm=norm("layers.{}.post_attention_layernorm.weight"))
    if prefix + "layers.0.block_sparse_moe.gate.weight" in state:
        # Mixtral: gate -> router [D, E]; expert w1 -> w_gate, w3 -> w_in,
        # w2 -> w_out, stacked [L, E, in, out].
        def experts(which):
            out = None
            for i in range(L):
                for e in range(cfg.n_experts):
                    w = wide(get(f"layers.{i}.block_sparse_moe.experts.{e}."
                                 f"{which}.weight")).t()
                    if out is None:
                        out = torch.empty((L, cfg.n_experts, *w.shape),
                                          dtype=dt, device=dev)
                    out[i, e].copy_(w)
            return out

        layers["moe"] = {
            "router": stacked("layers.{}.block_sparse_moe.gate.weight"),
            "w_gate": experts("w1"), "w_in": experts("w3"),
            "w_out": experts("w2")}
    elif fused:
        # Phi-3's gate_up_proj [2F, D]: gate rows first, then up.
        F = cfg.d_ff
        gate_up = "layers.{}.mlp.gate_up_proj.weight"
        layers.update(w_gate=stacked(gate_up, lambda w: w[:F].t()),
                      w_up=stacked(gate_up, lambda w: w[F:2 * F].t()),
                      w_down=stacked("layers.{}.mlp.down_proj.weight"))
    else:
        layers.update(w_gate=stacked("layers.{}.mlp.gate_proj.weight"),
                      w_up=stacked("layers.{}.mlp.up_proj.weight"),
                      w_down=stacked("layers.{}.mlp.down_proj.weight"))
    if prefix + "layers.0.self_attn.o_proj.bias" in state:
        # config_from_hf refuses these configs; a state dict can still
        # carry one.
        raise NotImplementedError(
            "o_proj carries a bias, which this parameter tree does not "
            "represent; converting would silently drop it")
    if prefix + "layers.0.self_attn.q_proj.bias" in state:
        # Qwen2: [out] bias vectors, no transpose.
        layers.update({
            b: stacked(f"layers.{{}}.self_attn.{proj}.bias", lambda w: w)
            for b, proj in (("bq", "q_proj"), ("bk", "k_proj"),
                            ("bv", "v_proj"))})
    embed = leaf(wide(get("embed_tokens.weight")))
    if "lm_head.weight" in state:
        lm_head = leaf(wide(state["lm_head.weight"]).t())
    else:  # tied embeddings
        lm_head = embed.t().contiguous()
    final = wide(get("norm.weight"))
    params = {"embed": embed, "layers": layers,
              "final_norm": leaf(final + 1.0 if norm_plus_one else final),
              "lm_head": lm_head}
    if quantize == "int8":
        from ..ops.quantize import quantize_params

        return quantize_params(params)
    return params
