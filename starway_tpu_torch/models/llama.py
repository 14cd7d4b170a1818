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
all-to-all over a mesh's ``"ep"`` axis).  They serve; they do not train
yet (:func:`loss_fn` refuses them).

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

_MOE_TODO = ("training mixture-of-experts models is not ported yet: the "
             "aux term of loss_fn, value_and_grad and the Trainer's moe_fn "
             "and with_moe_stats come with the next MoE slice (ROADMAP.md, "
             "Queue 1 item 6); MoE models serve")


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
    arrive ``[B, H, S, Dh]`` with grouped kv, the sequence is cut into the
    ``seq_axis`` shards of ``mesh`` (parallel/sharding.py) and the narrow
    kv shards rotate around the ring (parallel/ring_attention.py).

    ``layout="zigzag"`` is the load-balanced causal layout (a sequence
    permutation per call).  ``window``: the sliding band (match
    ``cfg.sliding_window``; the returned fn declares ``handles_window`` so
    :func:`resolve_attn_fn` admits it on windowed configs), ring layout
    only.  The model runs whole sequences in one process, so the mesh
    holds every shard here (no process group).  ``dp_axis``/``tp_axis``
    keep the JAX signature; :func:`~starway_tpu_torch.parallel.make_mesh`
    already refuses those axes above size 1, so they are not read."""
    from ..parallel.ring_attention import (make_ring_attention,
                                           make_zigzag_ring_attention)

    if layout not in ("ring", "zigzag"):
        raise ValueError(f"unknown attention layout {layout!r}; expected "
                         f"'ring' or 'zigzag'")
    if window is not None and layout != "ring":
        raise ValueError(
            "window is supported on the plain ring layout only (zigzag's "
            "interleaved shards break the contiguous band-skip argument)")
    if mesh.world > 1:
        raise NotImplementedError(
            "the model is not split over processes: make_sharded_attn "
            "takes a mesh without a process group (ROADMAP.md, Queue 1 "
            "item 6)")
    if layout == "zigzag":
        return make_zigzag_ring_attention(mesh, seq_axis)
    fn = make_ring_attention(mesh, seq_axis, causal=True, window=window)
    if window is not None:
        fn.handles_window = True
        fn.window = window  # resolve_attn_fn cross-checks the config
    return fn


# ----------------------------------------------------------------- forward


def embed_tokens(params: dict, tokens, cfg: LlamaConfig):
    """Token embedding gather, with sqrt(d_model) output scaling when
    ``cfg.scaled_embed``."""
    h = params["embed"][tokens]
    if cfg.scaled_embed:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype,
                             device=h.device)
    return h


def mlp_gate_act(x, cfg: LlamaConfig):
    """The gated-MLP nonlinearity in float32: SiLU or tanh-approximated
    GeLU."""
    xf = x.float()
    if cfg.mlp_act == "gelu_tanh":
        return F.gelu(xf, approximate="tanh")
    return F.silu(xf)


def qkv_proj(x, lp, cfg: LlamaConfig):
    """q/k/v projections of ``x [B, S, D]`` -> ``[B, H, S, hd]`` heads,
    before RoPE, with the optional bq/bk/bv biases."""
    B, S = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    q = matmul_w(x, lp["wq"])
    k = matmul_w(x, lp["wk"])
    v = matmul_w(x, lp["wv"])
    if "bq" in lp:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (q.reshape(B, S, cfg.n_heads, hd).transpose(1, 2),
            k.reshape(B, S, cfg.n_kv_heads, hd).transpose(1, 2),
            v.reshape(B, S, cfg.n_kv_heads, hd).transpose(1, 2))


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


def decoder_layer(lp, h, cfg: LlamaConfig, cos, sin, attn_fn: Callable,
                  moe_fn: Optional[Callable] = None):
    """One pre-norm decoder block on ``h [B, S, D]`` with one layer's
    params.  Returns ``(h, aux, k, v, stats)``: aux is the MoE balance
    term (a float32 zero for dense layers), k/v the post-RoPE grouped heads
    (the KV-cache prefix), stats the router health when ``moe_fn`` returns
    it, else None.  An MoE layer runs :func:`moe_ffn` at the FFN site.

    Under ``remat_policy="dots"`` (with autograd on) the norms, rope and
    the gate activation run in checkpointed regions: the backward replays
    them from the saved matmul outputs, the JAX package's chunked "dots"
    structure.  The attention call and the matmuls stay outside every
    region, so the flash forward never runs again in the backward."""
    B, S, _ = h.shape
    chunked = (cfg.remat and cfg.remat_policy == "dots"
               and torch.is_grad_enabled())
    run = _replayed if chunked else _direct
    x = run(rmsnorm, h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = qkv_proj(x, lp, cfg)
    q = run(apply_rope, q, cos, sin)
    k = run(apply_rope, k, cos, sin)
    o = attn_fn(q, k, v)  # [B, H, S, Dh]
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    h = h + matmul_w(o, lp["wo"])
    x = run(rmsnorm, h, lp["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts > 0:
        y, aux, stats = moe_ffn(x, lp["moe"], cfg, moe_fn)
        return h + y, aux, k, v, stats
    gate = run(_gated, matmul_w(x, lp["w_gate"]), matmul_w(x, lp["w_up"]),
               cfg)
    h = h + matmul_w(gate, lp["w_down"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device), k, v, None


def _remat_wrap(layer: Callable, cfg: LlamaConfig) -> Callable:
    """Full-layer remat (``cfg.remat`` without a policy): the whole layer,
    attention included, is recomputed in the backward, so the flash
    forward runs twice per layer and step.  "dots" lives inside
    :func:`decoder_layer` instead."""
    if not cfg.remat or cfg.remat_policy == "dots":
        return layer

    def wrapped(lp, h, *rest):
        if not torch.is_grad_enabled():
            return layer(lp, h, *rest)
        return checkpoint(layer, lp, h, *rest, use_reentrant=False)

    return wrapped


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
    """
    attn_fn = resolve_attn_fn(cfg, attn_fn)
    if return_moe_stats and cfg.n_experts == 0:
        raise ValueError(
            "return_moe_stats=True but cfg.n_experts == 0: a dense model "
            "has no router to report on")
    if return_moe_stats and moe_fn is None:
        raise ValueError(
            "return_moe_stats needs a stats-producing moe_fn (build one "
            "with make_sharded_moe(..., with_stats=True) or wrap "
            "switch_moe(..., with_stats=True))")
    B, S = tokens.shape
    cos, sin = cfg_rope_tables(cfg, S, device=tokens.device)
    h = embed_tokens(params, tokens, cfg)
    layer = _remat_wrap(decoder_layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs, stats = [], [], []
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        h, layer_aux, k, v, st = layer(lp, h, cfg, cos, sin, attn_fn,
                                       moe_fn)
        aux = aux + layer_aux
        if return_moe_stats:
            if st is None:
                raise ValueError("return_moe_stats=True but moe_fn returned "
                                 "no stats (build it with with_stats=True)")
            stats.append(st)
        if return_kv:
            ks.append(k)
            vs.append(v)
    if last_only:
        h = h[:, -1:]
    elif logit_positions is not None:
        idx = torch.as_tensor(logit_positions, device=h.device).long()
        h = torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[-1]))
    out = (head_logits(h, params["final_norm"], params["lm_head"],
                       cfg.norm_eps),)
    if return_aux:
        out += (aux,)
    if return_moe_stats:
        out += ({name: torch.stack([st[name] for st in stats])
                 for name in stats[0]},)
    if return_kv:
        out += ((torch.stack(ks), torch.stack(vs)),)
    return out if len(out) > 1 else out[0]


# ---------------------------------------------------------------- training


def loss_fn(params: dict, batch, cfg: LlamaConfig,
            attn_fn: Optional[Callable] = None):
    """Causal LM loss: batch ``[B, S+1]`` token ids -> mean next-token
    cross-entropy (float32 scalar).  Dense models only: MoE training (the
    aux term) is not ported yet."""
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_TODO)
    tokens, targets = batch[:, :-1], batch[:, 1:]
    logits, _aux = forward(params, tokens, cfg, attn_fn, return_aux=True)
    return token_ce(logits, targets)


def value_and_grad(params: dict, batch, cfg: LlamaConfig,
                   attn_fn: Optional[Callable] = None):
    """``(loss, grads)`` of :func:`loss_fn` at ``params``, the grads a tree
    like ``params`` in the leaves' dtypes (``jax.value_and_grad``'s
    contract).  Leaves are taken as detached views, so ``params`` need
    not require grad and gains no graph."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch, cfg, attn_fn)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


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
                    attn_fn: Optional[Callable] = None, *,
                    accum_steps: int = 1, in_place: bool = True):
    """One optimizer step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)``.

    ``accum_steps > 1`` splits the batch into that many equal microbatches
    and accumulates their gradients in float32 before the one optimizer
    update: activation memory scales with the microbatch while the math
    matches the full-batch step (the mean of equal-size means is the
    global mean).  The accumulated gradients are cast back to each
    parameter's dtype, so the optimizer sees the dtypes of the
    ``accum_steps=1`` path."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(params, batch, cfg, attn_fn)
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
            for chunk in chunks:
                l, g = value_and_grad(params, chunk, cfg, attn_fn)
                for a, gi in zip(acc, tree_leaves(g)):
                    a.add_(gi.float())
                loss = loss + l
                del g  # free this microbatch's grads before the next one
            loss = loss / accum_steps
            grads = tree_unflatten(params, [
                (a / accum_steps).to(p.dtype) for a, p in zip(acc, leaves)])
        params, opt_state = apply_updates(tx, params, opt_state, grads,
                                          in_place=in_place)
        return params, opt_state, loss

    return train_step
