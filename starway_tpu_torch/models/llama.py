"""Llama family (RMSNorm + RoPE + GQA + SwiGLU) in PyTorch: the serving
and training subsets.

Parameters are a dict tree with layer weights *stacked* on a leading
``[n_layers, ...]`` axis, the same layout as the JAX package's tree
(models/convert.py carries one over).  Matmul weights may be raw tensors or
W8A16 ``{"q": int8, "s": f32}`` pairs (ops/quantize.py); every matmul goes
through :func:`matmul_w`.  Functions take and return tensors; devices
follow the tensors, and :func:`init_params` makes the tree on ``cuda``
unless told otherwise.

Kernel dispatch is by tensor device: on CUDA, attention in the prompt pass
runs the flash kernels (ops/flash.py, forward and, under autograd, the two
backward passes) and W8A16 matmuls run the int8 GEMV kernel (ops/gemv.py);
on the CPU the same functions run in plain PyTorch.

Sequence parallelism: :func:`make_sharded_attn` gives ring attention
(parallel/ring_attention.py) as the ``attn_fn``.

Mixture-of-experts models (``cfg.n_experts > 0``) carry a ``moe`` subtree
in place of the dense FFN's leaves and run :func:`~starway_tpu_torch.
models.moe.switch_moe` at the FFN site, or the ``moe_fn`` given to
:func:`forward` (models/moe.py :func:`make_sharded_moe` for the expert
all-to-all over a mesh's ``"ep"`` axis); :func:`loss_fn` adds their
balance term.

A tree sharded over a mesh (:func:`param_specs`, parallel/sharding.py
``shard_array``, parallel/fsdp.py ``shard_tree``) runs through the same
entry points: :func:`forward`, :func:`value_and_grad` and the train step
hand it to models/sharded.py, which runs every slot of the mesh with the
collectives written out.

Training: :func:`loss_fn` (mean next-token cross-entropy), a functional
:func:`value_and_grad`, :func:`apply_updates` and :func:`make_train_step`
(with gradient accumulation).  ``cfg.remat`` checkpoints each layer with
``torch.utils.checkpoint``; ``remat_policy="dots"`` checkpoints only what
the JAX package's "dots" chunks replay (the norms, rope and the gate
activation), so matmul outputs and the attention's (o, lse) are saved and
the flash forward runs once per layer and step.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from ..ops.attention import blockwise_attention
from ..utils.tree import tree_leaves, tree_unflatten

@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = False
    # Sliding-window attention: each position attends to the last
    # `sliding_window` tokens only.  None = full causal.
    sliding_window: Optional[int] = None
    # Mixture-of-experts FFN (0 = dense SwiGLU), models/moe.py.
    n_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_top_k: int = 1
    moe_swiglu: bool = False
    # Gated-MLP activation: "silu" (Llama SwiGLU) or "gelu_tanh" (GeGLU).
    mlp_act: str = "silu"
    # sqrt(d_model) scaling of the token embedding output (Gemma).
    scaled_embed: bool = False
    # KV-cache storage: "none" keeps compute_dtype; "int8" stores int8 with
    # per-token float32 scales (ops/quantize.py).
    kv_quant: str = "none"
    # Per-head dim override; None derives d_model // n_heads.
    head_dim_override: Optional[int] = None
    # Per-head q/k/v projection biases (bq/bk/bv leaves; Qwen2 family).
    attn_bias: bool = False
    remat_policy: Optional[str] = None
    scan_layers: bool = True
    # RoPE frequency scaling tuple, see rope_tables.
    rope_scaling: Optional[tuple] = None

    def __post_init__(self):
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1, got {self.sliding_window}")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"kv_quant must be 'none' or 'int8', got {self.kv_quant!r}")
        if self.head_dim_override is None:
            if self.d_model % self.n_heads:
                raise ValueError(
                    f"d_model={self.d_model} not divisible by "
                    f"n_heads={self.n_heads}; pass head_dim_override")
        elif self.head_dim_override < 2 or self.head_dim_override % 2:
            raise ValueError(f"head_dim_override must be an even int >= 2, "
                             f"got {self.head_dim_override}")
        if self.mlp_act not in ("silu", "gelu_tanh"):
            raise ValueError(
                f"mlp_act must be 'silu' or 'gelu_tanh', got "
                f"{self.mlp_act!r}")
        if self.remat_policy not in (None, "dots"):
            raise ValueError(
                f"remat_policy must be None or 'dots', got "
                f"{self.remat_policy!r}")
        if self.remat_policy is not None and not self.remat:
            raise ValueError(
                "remat_policy is set but remat is False — the policy "
                "would be silently ignored; set remat=True")
        if self.rope_scaling is not None:
            s = tuple(self.rope_scaling)
            if not s or s[0] not in ("linear", "llama3", "yarn",
                                     "longrope", "longrope_fixed") or (
                    s[0] == "linear" and len(s) != 2) or (
                    s[0] == "llama3" and len(s) != 5) or (
                    s[0] == "yarn" and len(s) != 7) or (
                    s[0] == "longrope" and len(s) != 5) or (
                    s[0] == "longrope_fixed" and len(s) != 3):
                raise ValueError(
                    f"rope_scaling must be ('linear', factor), ('llama3', "
                    f"factor, low_freq_factor, high_freq_factor, "
                    f"original_max_position_embeddings), ('yarn', "
                    f"factor, original_max_position_embeddings, beta_fast, "
                    f"beta_slow, attention_factor, truncate), or "
                    f"('longrope', original_max_position_embeddings, "
                    f"attention_factor, short_factors, long_factors), got "
                    f"{self.rope_scaling!r}")
            if s[0] == "longrope":
                short, long = tuple(s[3]), tuple(s[4])
                half = self.head_dim // 2
                if len(short) != half or len(long) != half:
                    raise ValueError(
                        f"longrope factor lists must have head_dim//2="
                        f"{half} entries, got {len(short)}/{len(long)}")
                s = (s[0], s[1], s[2], short, long)
            elif s[0] == "longrope_fixed":
                ext = tuple(s[2])
                if len(ext) != self.head_dim // 2:
                    raise ValueError(
                        f"longrope_fixed factors must have head_dim//2="
                        f"{self.head_dim // 2} entries, got {len(ext)}")
                s = (s[0], s[1], ext)
            object.__setattr__(self, "rope_scaling", s)

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    PRESETS = {
        # Llama-3 8B widths.
        "llama3-8b": dict(vocab_size=128256, d_model=4096, n_layers=32,
                          n_heads=32, n_kv_heads=8, d_ff=14336,
                          rope_theta=500000.0),
        "llama2-7b": dict(vocab_size=32000, d_model=4096, n_layers=32,
                          n_heads=32, n_kv_heads=32, d_ff=11008,
                          rope_theta=10000.0),
        "debug": dict(vocab_size=512, d_model=128, n_layers=2, n_heads=8,
                      n_kv_heads=4, d_ff=256, dtype="float32"),
    }

    @classmethod
    def preset(cls, name: str, **overrides) -> "LlamaConfig":
        kw = dict(cls.PRESETS[name])
        kw.update(overrides)
        return cls(**kw)


# ------------------------------------------------------------------ params


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """Stacked-layer parameter tree with scaled-normal weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  An MoE config
    gets the ``moe`` subtree (models/moe.py :func:`init_moe_params`) in
    place of ``w_gate``/``w_up``/``w_down``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.compute_dtype
    hd = cfg.head_dim

    def norm(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * scale).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    L, D, Ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    embed = norm((cfg.vocab_size, D), 0.02)
    layers = {
        "wq": norm((L, D, Hq * hd), D ** -0.5),
        "wk": norm((L, D, Hkv * hd), D ** -0.5),
        "wv": norm((L, D, Hkv * hd), D ** -0.5),
        "wo": norm((L, Hq * hd, D), (Hq * hd) ** -0.5),
        "attn_norm": ones((L, D)),
        "mlp_norm": ones((L, D)),
    }
    if cfg.n_experts > 0:
        from .moe import init_moe_params

        layers["moe"] = init_moe_params(gen, L, cfg.n_experts, D, Ff, dt,
                                        swiglu=cfg.moe_swiglu)
    else:
        layers.update(w_gate=norm((L, D, Ff), D ** -0.5),
                      w_up=norm((L, D, Ff), D ** -0.5),
                      w_down=norm((L, Ff, D), Ff ** -0.5))
    if cfg.attn_bias:
        layers.update(bq=torch.zeros((L, Hq * hd), dtype=dt, device=dev),
                      bk=torch.zeros((L, Hkv * hd), dtype=dt, device=dev),
                      bv=torch.zeros((L, Hkv * hd), dtype=dt, device=dev))
    return {"embed": embed, "layers": layers, "final_norm": ones((D,)),
            "lm_head": norm((D, cfg.vocab_size), D ** -0.5)}


def param_specs(cfg: LlamaConfig) -> dict:
    """The ``PartitionSpec`` tree of tensor parallelism over axis "tp":
    projection out-dims (heads, ff) split over tp, wo and down on their
    in-dim, the embedding and lm_head on the vocab (models/sharded.py
    writes out the collectives this layout needs)."""
    from ..parallel.sharding import P

    layers = {"wq": P(None, None, "tp"), "wk": P(None, None, "tp"),
              "wv": P(None, None, "tp"), "wo": P(None, "tp", None),
              "attn_norm": P(None, None), "mlp_norm": P(None, None)}
    if cfg.attn_bias:
        # Biases live on the projection out-dim: split with their weight.
        layers.update(bq=P(None, "tp"), bk=P(None, "tp"), bv=P(None, "tp"))
    if cfg.n_experts > 0:
        from .moe import moe_specs

        layers["moe"] = moe_specs(swiglu=cfg.moe_swiglu)
    else:
        layers.update(w_gate=P(None, None, "tp"), w_up=P(None, None, "tp"),
                      w_down=P(None, "tp", None))
    return {"embed": P("tp", None), "layers": layers, "final_norm": P(None),
            "lm_head": P(None, "tp")}


def quantized_param_specs(cfg: LlamaConfig) -> dict:
    """:func:`param_specs` for a W8A16 tree (ops/quantize.py
    ``quantize_params``): each matmul leaf's spec applies to its ``q``,
    and its ``s`` (which drops the contracted axis, -2) keeps the leading
    and output dims of that spec, so tp still splits the output channels
    and the scales follow them."""
    from ..ops.quantize import _MATMUL_LEAVES
    from ..parallel.sharding import P

    specs = param_specs(cfg)

    def split(spec):
        return {"q": spec, "s": P(*spec[:-2], spec[-1])}

    layers = dict(specs["layers"])
    for name in _MATMUL_LEAVES:
        if name in layers:
            layers[name] = split(layers[name])
    return dict(specs, layers=layers, lm_head=split(specs["lm_head"]))


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer tree (views, no copies)."""
    return {name: ({k: t[i] for k, t in w.items()} if isinstance(w, dict)
                   else w[i])
            for name, w in layers.items()}


def unstack_layers(layers: dict, n_layers: int) -> list:
    """Every layer's slice of the stacked tree, from one ``unbind`` per
    leaf: under autograd the gradient of each stacked leaf is then one
    stack of the per-layer gradients, where indexing the leaf once per
    layer would write a zero tensor the size of the whole stack for every
    layer."""
    split = {name: ({k: t.unbind(0) for k, t in w.items()}
                    if isinstance(w, dict) else w.unbind(0))
             for name, w in layers.items()}
    return [layer_params(split, i) for i in range(n_layers)]


def params_device(params: dict) -> torch.device:
    return params["embed"].device


class LlamaModel(torch.nn.Module):
    """A thin module over the stacked parameter tree: the leaves are
    ``nn.Parameter``s (so ``.to()`` moves them and ``.parameters()`` hands
    them to an optimizer) and ``forward`` calls the functional
    :func:`forward`.  Floating leaves train; the int8 codes and float32
    scales of W8A16 pairs do not."""

    def __init__(self, params: dict, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self._paths = []
        for path, leaf in _flatten(params):
            name = "__".join(path)
            trains = leaf.is_floating_point() and path[-1] not in ("q", "s")
            self.register_parameter(
                name, torch.nn.Parameter(leaf, requires_grad=trains))
            self._paths.append((path, name))

    @property
    def params(self) -> dict:
        tree: dict = {}
        for path, name in self._paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, name)
        return tree

    def forward(self, tokens, **kw):
        return forward(self.params, tokens, self.cfg, **kw)


def _flatten(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


# ----------------------------------------------------------------- kernels


def matmul_w(x, w):
    """``x @ w`` where ``w`` is a raw tensor or a W8A16 ``{"q", "s"}`` pair.

    On CUDA a quantized weight streams at one byte per element through the
    int8 GEMV kernel (ops/gemv.py) with the per-column scale folded into
    the product; on the CPU it is dequantized and multiplied in float32.
    Raw weights are ``torch.matmul``."""
    if not (isinstance(w, dict) and "q" in w):
        return x @ w
    wq, s = w["q"], w["s"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        from ..ops.gemv import int8_matmul

        out = int8_matmul(x2.contiguous(), wq, s, static_weight=True)
    else:
        out = (x2.float() @ (wq.float() * s[None, :])).to(x.dtype)
    return out.reshape(*lead, wq.shape[-1])


def rmsnorm(x, w, eps: float):
    """RMSNorm in float32, cast to x's dtype BEFORE the weight multiply."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def rope_tables(seq_len: int, head_dim: int, theta: float, scaling=None,
                device=None):
    """``[S, Dh/2]`` cos/sin tables in float32.

    ``scaling`` is a LlamaConfig.rope_scaling tuple: ``("linear", f)``
    divides every frequency by f; ``("llama3", factor, low, high, orig)``
    is Llama-3.1's banded scheme; ``("yarn", factor, orig, beta_fast,
    beta_slow, attention_factor, truncate)`` is YaRN (NTK-by-parts);
    ``("longrope", orig, attention_factor, short, long)`` picks the factor
    set by this table's length, ``("longrope_fixed", attention_factor,
    factors)`` uses one set (see :func:`resolve_longrope`)."""
    f32 = dict(dtype=torch.float32, device=device)
    half = head_dim // 2
    exps = torch.arange(0, head_dim, 2, **f32) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, **f32), exps)
    att = 1.0
    if scaling is not None:
        kind = scaling[0]
        if kind == "linear":
            inv_freq = inv_freq / scaling[1]
        elif kind == "llama3":
            factor, low, high, orig = scaling[1:]
            wavelen = 2.0 * math.pi / inv_freq
            smooth = (orig / wavelen - low) / (high - low)
            mid = ((1.0 - smooth) / factor + smooth) * inv_freq
            inv_freq = torch.where(
                wavelen > orig / low, inv_freq / factor,
                torch.where(wavelen < orig / high, inv_freq, mid))
        elif kind == "yarn":
            factor, orig, beta_fast, beta_slow, att, truncate = scaling[1:]

            def corr_dim(rot):  # dimension rotating `rot` times over orig
                return (head_dim * math.log(orig / (rot * 2.0 * math.pi))
                        ) / (2.0 * math.log(theta))

            low, high = corr_dim(beta_fast), corr_dim(beta_slow)
            if truncate:
                low, high = math.floor(low), math.ceil(high)
            low, high = max(low, 0), min(high, head_dim - 1)
            if low == high:
                high += 0.001  # ramp singularity guard
            ramp = torch.clamp(
                (torch.arange(half, **f32) - low) / (high - low), 0.0, 1.0)
            extrap = 1.0 - ramp
            inv_freq = (inv_freq / factor) * (1.0 - extrap) + inv_freq * extrap
        elif kind == "longrope":
            orig, att, short, long = scaling[1:]
            ext = torch.tensor(long if seq_len > orig else short, **f32)
            inv_freq = inv_freq / ext
        elif kind == "longrope_fixed":
            att, ext = scaling[1], torch.tensor(scaling[2], **f32)
            inv_freq = inv_freq / ext
        else:  # LlamaConfig.__post_init__ already validated
            raise ValueError(f"unknown rope scaling kind {kind!r}")
    pos = torch.arange(seq_len, **f32)
    ang = pos[:, None] * inv_freq[None, :]
    return torch.cos(ang) * att, torch.sin(ang) * att


def cfg_rope_tables(cfg: LlamaConfig, seq_len: int, device=None):
    """:func:`rope_tables` keyed entirely off a config."""
    return rope_tables(seq_len, cfg.head_dim, cfg.rope_theta,
                       cfg.rope_scaling, device=device)


def resolve_longrope(cfg: LlamaConfig, horizon: int) -> LlamaConfig:
    """Pin a longrope config's factor regime to ``horizon`` (the run's
    maximum total length) for the whole run, so prefill and decode tables
    of different lengths rotate with one frequency set.  Other configs pass
    through unchanged."""
    s = cfg.rope_scaling
    if s is None or s[0] != "longrope":
        return cfg
    orig, att, short, long = s[1:]
    ext = long if horizon > orig else short
    return dataclasses.replace(
        cfg, rope_scaling=("longrope_fixed", att, tuple(ext)))


def apply_rope(x, cos, sin):
    """x: [B, H, S, Dh]; split-half (NeoX) rotation in float32, cast back to
    x's dtype.  ``cos``/``sin`` are [S, Dh/2] tables or broadcastable 4-D
    angles (per-row [B, 1, 1, Dh/2] for ragged decode)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[None, None] if cos.dim() == 2 else cos
    s = sin[None, None] if sin.dim() == 2 else sin
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def head_logits(h, final_norm_w, lm_head_w, eps: float):
    """Model tail: final RMSNorm + lm_head, float32 logits."""
    return matmul_w(rmsnorm(h, final_norm_w, eps), lm_head_w).float()


def final_logits(params: dict, h, cfg: "LlamaConfig"):
    """The tail of the cached decode paths: :func:`head_logits` of the
    tree (the vocab-split head of a tensor-parallel tree gathered)."""
    from .sharded import serving_tree

    tree = serving_tree({"final_norm": params["final_norm"],
                         "lm_head": params["lm_head"]})
    return tree.head([h] * tree.n, cfg)[0]


def token_ce(logits, targets):
    """Mean next-token cross-entropy of ``logits [..., V]`` against int ids
    ``targets [...]``, as ``logsumexp - target_logit``: no log-softmax
    tensor the size of the logits is kept for the backward."""
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - tl).mean()


def top_k_stable(x, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, descending, the lower index first among equal values (the order
    of ``jax.lax.top_k``; ``torch.topk`` fixes none)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def default_attn(q, k, v, window: Optional[int] = None):
    """Causal attention: the flash kernel on CUDA, the blockwise loop on the
    CPU (same algebra, same GQA handling)."""
    if q.is_cuda:
        from ..ops.flash import flash_attention

        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True, window=window)
    return blockwise_attention(q, k, v, causal=True, window=window)


def resolve_attn_fn(cfg: LlamaConfig, attn_fn: Optional[Callable]) -> Callable:
    """None -> :func:`default_attn`, bound to the config's window.  A
    supplied ``attn_fn`` on a windowed config must declare
    ``attn_fn.handles_window = True`` (and a matching ``window`` if it
    names one)."""
    if attn_fn is None:
        if cfg.sliding_window is not None:
            return partial(default_attn, window=cfg.sliding_window)
        return default_attn
    if cfg.sliding_window is not None:
        if not getattr(attn_fn, "handles_window", False):
            raise ValueError(
                "cfg.sliding_window is set but the supplied attn_fn does "
                "not declare window support (attn_fn.handles_window)")
        declared = getattr(attn_fn, "window", None)
        if declared is not None and declared != cfg.sliding_window:
            raise ValueError(
                f"attn_fn was built with window={declared} but "
                f"cfg.sliding_window={cfg.sliding_window}")
    return attn_fn


def make_sharded_attn(mesh, *, seq_axis: str = "sp", dp_axis: str = "dp",
                      tp_axis: str = "tp", layout: str = "ring",
                      window: Optional[int] = None):
    """Sequence-parallel ring attention as the model's ``attn_fn``
    (``forward``, ``value_and_grad``, ``Trainer(attn_fn=...)``): q/k/v
    arrive ``[B, H, S, Dh]`` with grouped kv, batch over ``dp_axis``,
    heads over ``tp_axis`` and sequence over ``seq_axis`` (the JAX
    package's spec ``P(dp, tp, sp, None)``; an axis the mesh lacks is
    whole), and the narrow kv shards rotate around the ring
    (parallel/ring_attention.py).  Requires ``n_kv_heads % tp == 0``.

    The returned fn takes the global q/k/v (this process's box of them on
    a mesh with a process group); its ``slots(qs, ks, vs)`` takes the
    slots' tensors of a sharded tree's forward (models/sharded.py), each
    with the whole sequence, and returns each slot's whole output.

    ``layout="zigzag"`` is the load-balanced causal layout (a sequence
    permutation per call).  ``window``: the sliding band (match
    ``cfg.sliding_window``; the returned fn declares ``handles_window`` so
    :func:`resolve_attn_fn` admits it on windowed configs), ring layout
    only."""
    from ..ops.collectives import all_gather, axis_index
    from ..parallel.ring_attention import (ring_attention_slots,
                                           zigzag_indices,
                                           zigzag_ring_attention_slots)
    from ..parallel.sharding import cut_blocks, join_blocks

    if layout not in ("ring", "zigzag"):
        raise ValueError(f"unknown attention layout {layout!r}; expected "
                         f"'ring' or 'zigzag'")
    if window is not None and layout != "ring":
        raise ValueError(
            "window is supported on the plain ring layout only (zigzag's "
            "interleaved shards break the contiguous band-skip argument)")
    spec = tuple(a if a in mesh.shape else None
                 for a in (dp_axis, tp_axis, seq_axis)) + (None,)
    n = mesh.shape.get(seq_axis, 1)

    def blocks_of(xs, full: bool) -> list:
        """The slots' ring blocks of whole sequences (``full``) or of
        their natural-order sequence blocks."""
        if layout == "ring":
            if not full:
                return xs
            t = xs[0].shape[2] // n
            return [x[:, :, i * t:(i + 1) * t]
                    for x, i in zip(xs, axis_index(mesh, seq_axis))]
        if not full:
            xs = all_gather(xs, mesh, seq_axis, 2)
        s_len = xs[0].shape[2]
        perm = torch.from_numpy(zigzag_indices(s_len, n)).to(xs[0].device)
        t = s_len // n
        return [x.index_select(2, perm[i * t:(i + 1) * t])
                for x, i in zip(xs, axis_index(mesh, seq_axis))]

    def run(qs, ks, vs, full: bool) -> list:
        qs, ks, vs = (blocks_of(x, full) for x in (qs, ks, vs))
        if seq_axis not in mesh.shape:
            return [default_attn(q, k, v, window) for q, k, v in
                    zip(qs, ks, vs)]
        if layout == "zigzag":
            outs = zigzag_ring_attention_slots(qs, ks, vs, mesh, seq_axis)
        else:
            outs = ring_attention_slots(qs, ks, vs, mesh, seq_axis,
                                        causal=True, window=window)
        if layout == "ring" and not full:
            return outs
        whole = all_gather(outs, mesh, seq_axis, 2)
        if layout == "zigzag":
            inv = torch.argsort(torch.from_numpy(
                zigzag_indices(whole[0].shape[2], n)).to(whole[0].device))
            whole = [w.index_select(2, inv) for w in whole]
        if full:
            return whole
        t = whole[0].shape[2] // n
        return [w[:, :, i * t:(i + 1) * t]
                for w, i in zip(whole, axis_index(mesh, seq_axis))]

    def fn(q, k, v):
        outs = run(*(cut_blocks(x, mesh, spec) for x in (q, k, v)),
                   full=False)
        return join_blocks(outs, mesh, spec)

    fn.slots = lambda qs, ks, vs: run(qs, ks, vs, full=True)
    fn.mesh = mesh
    if window is not None:
        fn.handles_window = True
        fn.window = window  # resolve_attn_fn cross-checks the config
    return fn


# ----------------------------------------------------------------- forward


def embed_tokens(params: dict, tokens, cfg: LlamaConfig):
    """Token embedding gather, with sqrt(d_model) output scaling when
    ``cfg.scaled_embed`` (the vocab-parallel lookup of a tp tree,
    models/sharded.py)."""
    from .sharded import serving_tree

    tree = serving_tree({"embed": params["embed"]})
    return tree.embed([tokens] * tree.n, cfg)[0]


def mlp_gate_act(x, cfg: LlamaConfig):
    """The gated-MLP nonlinearity in float32: SiLU or tanh-approximated
    GeLU."""
    xf = x.float()
    if cfg.mlp_act == "gelu_tanh":
        return F.gelu(xf, approximate="tanh")
    return F.silu(xf)


def qkv_proj(x, lp, cfg: LlamaConfig):
    """q/k/v projections of ``x [B, S, D]`` -> ``[B, H, S, hd]`` heads,
    before RoPE, with the optional bq/bk/bv biases.  The head counts are
    the projections' widths over ``cfg.head_dim``: a tensor-parallel
    slot's share of the heads."""
    B, S = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    q = matmul_w(x, lp["wq"])
    k = matmul_w(x, lp["wk"])
    v = matmul_w(x, lp["wv"])
    if "bq" in lp:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (q.reshape(B, S, -1, hd).transpose(1, 2),
            k.reshape(B, S, -1, hd).transpose(1, 2),
            v.reshape(B, S, -1, hd).transpose(1, 2))


def _gated(g, u, cfg: LlamaConfig):
    """The MLP's gate activation times its up projection, in g's dtype."""
    return mlp_gate_act(g, cfg).to(g.dtype) * u


def _replayed(fn, *args):
    """``fn(*args)`` whose intermediates are recomputed in the backward
    (torch.utils.checkpoint) instead of kept."""
    return checkpoint(fn, *args, use_reentrant=False)


def _direct(fn, *args):
    return fn(*args)


def moe_ffn(x, moe: dict, cfg: LlamaConfig,
            moe_fn: Optional[Callable] = None):
    """The MoE FFN of one layer on ``x [B, S, D]`` (the normed hidden
    states): ``moe_fn`` when given (``w_gate`` is passed only when the
    tree has it, so 4-argument Switch-style functions keep working), else
    :func:`~starway_tpu_torch.models.moe.switch_moe` at the config's
    capacity and k.  Returns ``(y, aux, stats or None)``."""
    kw = {"w_gate": moe["w_gate"]} if "w_gate" in moe else {}
    if moe_fn is not None:
        out = moe_fn(x, moe["router"], moe["w_in"], moe["w_out"], **kw)
        return out[0], out[1], out[2] if len(out) > 2 else None
    from .moe import switch_moe

    y, aux = switch_moe(x, moe["router"], moe["w_in"], moe["w_out"],
                        capacity_factor=cfg.moe_capacity_factor,
                        k=cfg.moe_top_k, **kw)
    return y, aux, None


def decoder_block(lps: list, hs: list, cfg: LlamaConfig, cos, sin,
                  attend: Callable, moe: Callable, reduce: Callable):
    """One pre-norm decoder block on a list of shards: ``lps`` each
    shard's layer params, ``hs`` its hidden states ``[B, S, D]`` (one of
    each for a whole tree, one a mesh slot for a sharded one,
    models/sharded.py).  A shard runs the heads and the MLP width its
    projections hold.  The shards meet in three hooks:
    ``attend(qs, ks, vs)`` gives each shard's attention output from its
    post-RoPE grouped heads; ``reduce(ys, name)`` sums the partial
    products of the row-split ``"wo"`` and ``"w_down"`` over the shards
    that hold parts of them (the identity for a whole tree); ``moe(xs,
    [lp["moe"], ...])`` gives an expert layer's ``(ys, auxes, stats)``.

    Returns ``(hs, auxes, ks, vs, stats)``: aux is the MoE balance term (a
    float32 zero for dense layers), k/v the post-RoPE grouped heads (the
    KV-cache prefix), stats the router health when the MoE function
    returns it, else None.

    Under ``remat_policy="dots"`` (with autograd on) the norms, rope and
    the gate activation run in checkpointed regions: the backward replays
    them from the saved matmul outputs, the JAX package's chunked "dots"
    structure.  The attention call and the matmuls stay outside every
    region, so the flash forward never runs again in the backward."""
    chunked = (cfg.remat and cfg.remat_policy == "dots"
               and torch.is_grad_enabled())
    run = _replayed if chunked else _direct
    qs, ks, vs = [], [], []
    for lp, h in zip(lps, hs):
        x = run(rmsnorm, h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = qkv_proj(x, lp, cfg)
        qs.append(run(apply_rope, q, cos, sin))
        ks.append(run(apply_rope, k, cos, sin))
        vs.append(v)
    ys = []
    for o, lp in zip(attend(qs, ks, vs), lps):  # o [B, H, S, Dh]
        B, _, S, _ = o.shape
        ys.append(matmul_w(o.transpose(1, 2).reshape(B, S, -1), lp["wo"]))
    hs = [h + y for h, y in zip(hs, reduce(ys, "wo"))]
    xs = [run(rmsnorm, h, lp["mlp_norm"], cfg.norm_eps)
          for h, lp in zip(hs, lps)]
    if cfg.n_experts > 0:
        ys, auxes, stats = moe(xs, [lp["moe"] for lp in lps])
        return [h + y for h, y in zip(hs, ys)], auxes, ks, vs, stats
    ys = [matmul_w(run(_gated, matmul_w(x, lp["w_gate"]),
                       matmul_w(x, lp["w_up"]), cfg), lp["w_down"])
          for x, lp in zip(xs, lps)]
    zero = torch.zeros((), dtype=torch.float32, device=hs[0].device)
    return ([h + y for h, y in zip(hs, reduce(ys, "w_down"))],
            [zero] * len(hs), ks, vs, None)


def decoder_layer(lp, h, cfg: LlamaConfig, cos, sin, attn_fn: Callable,
                  moe_fn: Optional[Callable] = None):
    """:func:`decoder_block` on one whole shard: ``(h, aux, k, v,
    stats)``, the MoE layer through :func:`moe_ffn`."""
    def moe(xs, ms):
        y, aux, stats = moe_ffn(xs[0], ms[0], cfg, moe_fn)
        return [y], [aux], stats

    hs, auxes, ks, vs, stats = decoder_block(
        [lp], [h], cfg, cos, sin,
        lambda qs, ks_, vs_: [attn_fn(qs[0], ks_[0], vs_[0])], moe,
        lambda ys, name: ys)
    return hs[0], auxes[0], ks[0], vs[0], stats


def forward(params: dict, tokens, cfg: LlamaConfig,
            attn_fn: Optional[Callable] = None, *, return_aux: bool = False,
            moe_fn: Optional[Callable] = None, return_kv: bool = False,
            last_only: bool = False, logit_positions=None,
            return_moe_stats: bool = False):
    """Next-token logits ``[B, S, V]`` (float32) for token ids ``[B, S]``.

    The return value is ``logits``, extended to a tuple ``(logits[, aux][,
    moe_stats][, (k, v)])`` by ``return_aux`` (the MoE balance term summed
    over the layers, float32; zero for a dense model), ``return_moe_stats``
    (the router health of every layer, each leaf stacked on a leading
    ``n_layers`` dim; needs a ``moe_fn`` built ``with_stats=True``) and
    ``return_kv`` (the post-RoPE grouped k/v of every layer, stacked
    ``[n_layers, B, Hkv, S, Dh]``: the KV-cache prefix).  ``last_only``
    computes logits for the last position only (``[B, 1, V]``);
    ``logit_positions`` ([B] ints) for one chosen position per row.
    ``attn_fn(q, k, v)`` takes grouped kv and defaults to
    :func:`default_attn`; ``moe_fn(x, router_w, w_in, w_out[, w_gate]) ->
    (y, aux[, stats])`` replaces the MoE FFN (:func:`moe_ffn`).

    A sharded tree runs on its mesh's slots (models/sharded.py); the
    logits are those of the batch rows this process's slots hold."""
    from .sharded import SlotTree

    if return_moe_stats and cfg.n_experts == 0:
        raise ValueError(
            "return_moe_stats=True but cfg.n_experts == 0: a dense model "
            "has no router to report on")
    if return_moe_stats and moe_fn is None:
        raise ValueError(
            "return_moe_stats needs a stats-producing moe_fn (build one "
            "with make_sharded_moe(..., with_stats=True) or wrap "
            "switch_moe(..., with_stats=True))")
    tree = SlotTree(params, moe_fn=moe_fn)
    pos = None
    if logit_positions is not None:
        pos = tree.cut_batch(torch.as_tensor(logit_positions,
                                             device=tokens.device))
    logits, auxes, stats, kv = _slot_forward(
        tree, tree.cut_batch(tokens), cfg, attn_fn, moe_fn,
        return_kv=return_kv, last_only=last_only, positions=pos)
    if return_moe_stats and stats is None:
        raise ValueError("return_moe_stats=True but moe_fn returned no "
                         "stats (build it with with_stats=True)")
    out = (tree.join_batch(logits),)
    if return_aux:
        out += (auxes[0],)
    if return_moe_stats:
        out += (stats,)
    if return_kv:
        out += (tree.kv(kv),)
    return out if len(out) > 1 else out[0]


def _slot_forward(tree, toks: list, cfg: LlamaConfig, attn_fn, moe_fn, *,
                  return_kv: bool = False, last_only: bool = False,
                  positions=None):
    """The model on the slots of ``tree`` (models/sharded.py
    ``SlotTree``), ``toks`` each slot's token block.  Returns ``(logits,
    auxes, stats, kv)``: per-slot float32 logits, per-slot aux summed over
    the layers, slot 0's router health stacked over the layers (or None),
    and per-slot ``(k, v)`` stacks when ``return_kv``.

    ``cfg.remat`` without a policy checkpoints each whole layer, the
    gather of its sharded leaves included: the attention too is
    recomputed in the backward, so the flash forward runs twice per layer
    and step.  "dots" lives inside :func:`decoder_block` instead."""
    attend = tree.attend(resolve_attn_fn(cfg, attn_fn))
    cos, sin = cfg_rope_tables(cfg, toks[0].shape[1], device=toks[0].device)
    hs = tree.embed(toks, cfg)
    auxes = [torch.zeros((), dtype=torch.float32, device=hs[0].device)
             for _ in hs]
    stats, kvs = [], []

    def moe(xs, ms):
        return tree.moe(xs, ms, cfg, moe_fn)

    def layer(i, *hs):
        return decoder_block(tree.layer(i), list(hs), cfg, cos, sin, attend,
                             moe, tree.reduce)

    whole = (cfg.remat and cfg.remat_policy != "dots"
             and torch.is_grad_enabled())
    for i in range(cfg.n_layers):
        if whole:
            out = checkpoint(layer, i, *hs, use_reentrant=False)
        else:
            out = layer(i, *hs)
        hs, layer_aux, ks, vs, st = out
        auxes = [a + b for a, b in zip(auxes, layer_aux)]
        if return_kv:
            kvs.append((ks, vs))
        if st is not None:
            stats.append(st)
    if last_only:
        hs = [h[:, -1:] for h in hs]
    elif positions is not None:
        hs = [torch.gather(h, 1, p.long()[:, None, None].expand(
            -1, 1, h.shape[-1])) for h, p in zip(hs, positions)]
    st = ({name: torch.stack([s[name] for s in stats]) for name in stats[0]}
          if stats else None)
    kv = None
    if return_kv:
        kv = [(torch.stack([k[j] for k, _ in kvs]),
               torch.stack([v[j] for _, v in kvs])) for j in range(len(hs))]
    return tree.head(hs, cfg), auxes, st, kv


# ---------------------------------------------------------------- training


def loss_fn(params: dict, batch, cfg: LlamaConfig,
            attn_fn: Optional[Callable] = None,
            moe_fn: Optional[Callable] = None, *,
            with_moe_stats: bool = False):
    """Causal LM loss: batch ``[B, S+1]`` token ids -> mean next-token
    cross-entropy (float32 scalar), plus ``moe_aux_coef * aux / n_layers``
    for an MoE model.  ``with_moe_stats``: return ``(loss, stats)`` with
    the layer-stacked router health (needs a ``with_stats=True``
    moe_fn)."""
    tokens, targets = batch[:, :-1], batch[:, 1:]
    out = forward(params, tokens, cfg, attn_fn, return_aux=True,
                  moe_fn=moe_fn, return_moe_stats=with_moe_stats)
    loss = token_ce(out[0], targets)
    if cfg.n_experts > 0:
        loss = loss + cfg.moe_aux_coef * out[1] / cfg.n_layers
    return (loss, out[2]) if with_moe_stats else loss


def value_and_grad(params: dict, batch, cfg: LlamaConfig,
                   attn_fn: Optional[Callable] = None,
                   moe_fn: Optional[Callable] = None, *,
                   with_moe_stats: bool = False):
    """``(loss, grads)`` of :func:`loss_fn` at ``params``, the grads a tree
    like ``params`` in the leaves' dtypes (``jax.value_and_grad``'s
    contract); ``((loss, stats), grads)`` with ``with_moe_stats``
    (``has_aux=True``'s).  Leaves are taken as detached views, so
    ``params`` need not require grad and gains no graph.  A sharded tree
    takes models/sharded.py's step: the global loss, and the gradients
    sharded as ``params``: each slot's loss is its batch block's, weighted
    so that the slots' sum is the global loss."""
    from .sharded import SlotTree

    if with_moe_stats and moe_fn is None:
        raise ValueError(
            "with_moe_stats needs a stats-producing moe_fn (build one with "
            "make_sharded_moe(..., with_stats=True))")
    with torch.enable_grad():
        # Built with autograd on: its layers' unbind must be recorded.
        tree = SlotTree(params, moe_fn=moe_fn, alias=True)
        weight = 1.0 / tree.mesh.size
        rows = tree.cut_batch(batch)
        logits, auxes, stats, _ = _slot_forward(
            tree, [r[:, :-1] for r in rows], cfg, attn_fn, moe_fn)
        losses = []
        for lg, r, aux in zip(logits, rows, auxes):
            loss = token_ce(lg, r[:, 1:])
            if cfg.n_experts > 0:
                loss = loss + cfg.moe_aux_coef * aux / cfg.n_layers
            losses.append(loss)
        if with_moe_stats and stats is None:
            raise ValueError("with_moe_stats=True but moe_fn returned no "
                             "stats (build it with with_stats=True)")
        grads = torch.autograd.grad(
            losses, tree.grad_inputs(),
            grad_outputs=[torch.full_like(l, weight) for l in losses],
            allow_unused=True, materialize_grads=True)
    loss = tree.mean_loss(losses, weight)
    grads = tree.grad_tree(grads, params)
    if with_moe_stats:
        return (loss, {k: v.detach() for k, v in stats.items()}), grads
    return loss, grads


def apply_updates(tx, params: dict, opt_state, grads, *,
                  in_place: bool = True):
    """Optimizer transform + parameter update ``p + u.to(p.dtype)``.
    ``in_place`` adds into the parameter tensors (where the JAX step
    donates its buffers); otherwise the returned tree holds new tensors
    and ``params`` is left as it was."""
    updates, opt_state = tx.update(grads, opt_state, params)
    leaves = tree_leaves(params)
    with torch.no_grad():
        if in_place:
            for p, u in zip(leaves, tree_leaves(updates)):
                p.add_(u.to(p.dtype))
            return params, opt_state
        new = [p + u.to(p.dtype) for p, u in zip(leaves,
                                                 tree_leaves(updates))]
    return tree_unflatten(params, new), opt_state


def make_train_step(cfg: LlamaConfig, tx,
                    attn_fn: Optional[Callable] = None,
                    moe_fn: Optional[Callable] = None, *,
                    accum_steps: int = 1, with_moe_stats: bool = False,
                    in_place: bool = True):
    """One optimizer step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss[, stats])``.

    ``accum_steps > 1`` splits the batch into that many equal microbatches
    and accumulates their gradients in float32 before the one optimizer
    update: activation memory scales with the microbatch while the math
    matches the full-batch step (the mean of equal-size means is the
    global mean; an MoE model's capacity is per microbatch, so its drops
    may differ).  The accumulated gradients are cast back to each
    parameter's dtype, so the optimizer sees the dtypes of the
    ``accum_steps=1`` path.  ``with_moe_stats`` (a ``with_stats=True``
    moe_fn) also returns the layer-stacked router health, averaged over
    the microbatches.  A sharded tree (and its optimizer state, from
    ``tx.init`` of it) steps shard by shard."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def grad(params, batch):
        out = value_and_grad(params, batch, cfg, attn_fn, moe_fn,
                             with_moe_stats=with_moe_stats)
        if with_moe_stats:
            (loss, stats), g = out
            return loss, g, stats
        return out[0], out[1], None

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads, stats = grad(params, batch)
        else:
            B = batch.shape[0]
            if B % accum_steps:
                raise ValueError(
                    f"batch {B} not divisible by accum_steps={accum_steps}")
            chunks = batch.reshape(accum_steps, B // accum_steps,
                                   *batch.shape[1:])
            leaves = tree_leaves(params)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=batch.device)
            stats_sum = None
            for chunk in chunks:
                l, g, st = grad(params, chunk)
                for a, gi in zip(acc, tree_leaves(g)):
                    a.add_(gi.float())
                loss = loss + l
                if st is not None:
                    stats_sum = st if stats_sum is None else {
                        k: stats_sum[k] + v for k, v in st.items()}
                del g  # free this microbatch's grads before the next one
            loss = loss / accum_steps
            stats = (None if stats_sum is None else
                     {k: v / accum_steps for k, v in stats_sum.items()})
            grads = tree_unflatten(params, [
                (a / accum_steps).to(p.dtype) for a, p in zip(acc, leaves)])
        params, opt_state = apply_updates(tx, params, opt_state, grads,
                                          in_place=in_place)
        if with_moe_stats:
            return params, opt_state, loss, stats
        return params, opt_state, loss

    return train_step
