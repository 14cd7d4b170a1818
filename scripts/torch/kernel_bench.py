"""Kernel benchmarks of the PyTorch/CUDA port on an NVIDIA GPU: one JSON
row per benchmark.

The port's twin of ``scripts/kernel_bench.py``: the same ``--which`` names
(every key of :data:`REHEARSAL_KW`, plus ``check`` and ``all``) and the
same quantities, measured on the port's kernels.  A kernel is timed as
device ms a call: ``n`` calls captured in one CUDA graph and replayed
(``utils/cuda_timing.py`` ``graph_us``), or between CUDA events where a
call cannot be captured (the backward through autograd, ``generate()``
and the servers, whose wall time with the host's work is the quantity).
The "stock" and "lax" rows time the library call that computes the same
function: ``scaled_dot_product_attention`` and ``torch.matmul``.  Every
row names the card and its power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them.

``check`` holds each of the nine kernels (#1-#9 of ``PERF.md``) against
its plain PyTorch version at ``chip_smoke.py`` phase 3's tolerances: bf16
outputs within 2e-2 absolute, bf16 gradients within 1e-2 of their
largest value, the int8 GEMV within its scale-aware tolerance
(``ops/gemv.py`` ``tolerance_share`` at most 1).

The script runs on the card (``cuda:0``) and refuses without one, unless
asked for the CPU: ``--device cpu``, or ``STARWAY_BENCH_REHEARSAL=1``,
which also shrinks every row to its :data:`REHEARSAL_KW` sizes so that
the plain versions run each row's exact code path in seconds (the
pre-flight check that no row has a shape bug).

    python scripts/torch/kernel_bench.py --which check
    python scripts/torch/kernel_bench.py --which matmul,flash,flash_stock
    STARWAY_BENCH_REHEARSAL=1 python scripts/torch/kernel_bench.py --which all
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np
import torch
import torch.nn.functional as F

BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor rate (data sheet)
BF16_TOL = 2e-2         # chip_smoke.py phase 3: bf16 outputs, absolute
GRAD_REL_TOL = 1e-2     # chip_smoke.py phase 3: bf16 gradients, relative
LSE_TOL = 1e-3          # chip_smoke.py phase 3: the forward's lse

DEV = torch.device("cuda:0")
CARD = ""


def _sync() -> None:
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def device_ms(fn, iters: int) -> float:
    """ms of one ``fn()``: on the card ``iters`` calls in one CUDA graph
    (device time, no host enqueue); on the CPU the median wall time."""
    if DEV.type == "cuda":
        from starway_tpu_torch.utils.cuda_timing import graph_us

        return graph_us(lambda _: fn(), [None], n=max(iters, 1)) / 1e3
    return wall_ms(fn, iters)


def wall_ms(fn, iters: int) -> float:
    """Median ms of one ``fn()``, the host's work included: between CUDA
    events on the card, by the host's clock on the CPU."""
    if DEV.type == "cuda":
        from starway_tpu_torch.utils.cuda_timing import event_ms

        return event_ms(fn, iters=max(iters, 1), warmup=1)
    fn()
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _randn(*shape, seed: int = 0, dtype=torch.bfloat16):
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def _row(metric: str, value, unit: str, detail: str, **kw) -> dict:
    return {"metric": metric, "value": value, "unit": unit,
            "detail": detail, "card": CARD, "device": str(DEV), **kw}


def _attn_flops(b, hq, s, d, causal):
    f = 4 * b * hq * s * s * d
    return f // 2 if causal else f


# ------------------------------------------------------------ the kernels


def bench_matmul(n: int = 8192, iters: int = 8):
    """The card's bf16 matmul ceiling: ``torch.matmul`` of two n x n."""
    a, b = _randn(n, n, seed=1), _randn(n, n, seed=2)
    ms = device_ms(lambda: torch.matmul(a, b), iters)
    return _row("matmul_ceiling_tflops", round(2 * n ** 3 / ms / 1e9, 2),
                "TFLOP/s", f"bf16 {n}^3 torch.matmul, {ms:.4f} ms/iter")


def _qkv(b, hq, hkv, s, d):
    return (_randn(b, hq, s, d, seed=3), _randn(b, hkv, s, d, seed=4),
            _randn(b, hkv, s, d, seed=5))


def bench_flash_fwd(b=1, hq=8, hkv=2, s=8192, d=128, causal=True,
                    iters: int = 8, impl="ours"):
    """#3 (csrc/flash_fwd.cu), or SDPA ("stock") on the same inputs."""
    from starway_tpu_torch.ops.flash import flash_forward

    q, k, v = _qkv(b, hq, hkv, s, d)
    if impl == "ours":
        def kern():
            return flash_forward(q, k, v, causal=causal)
    else:
        def kern():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)
    ms = device_ms(kern, iters)
    return _row(f"flash_fwd_{impl}_tflops",
                round(_attn_flops(b, hq, s, d, causal) / ms / 1e9, 2),
                "TFLOP/s", f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
                f"causal={causal} bf16, {ms:.4f} ms/iter")


def bench_flash_window(b=1, hq=8, hkv=2, s=8192, d=128, window=1024,
                       iters: int = 8):
    """#3 with a sliding window: the work scales with S * window."""
    from starway_tpu_torch.ops.flash import flash_forward
    from starway_tpu_torch.utils.cuda_timing import visible_pairs

    q, k, v = _qkv(b, hq, hkv, s, d)
    ms = device_ms(lambda: flash_forward(q, k, v, causal=True,
                                         window=window), iters)
    flops = 4 * b * hq * d * visible_pairs(s, s, window=window)
    return _row("flash_window_tflops", round(flops / ms / 1e9, 2), "TFLOP/s",
                f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} window={window} bf16, "
                f"{ms:.4f} ms/iter (visible pairs' flops)")


def bench_flash_bwd(b=1, hq=8, hkv=2, s=8192, d=128, causal=True,
                    iters: int = 4, impl="ours"):
    """Forward and backward: #3 then #5 and #6 (``flash_attention``
    through autograd), or SDPA's ("stock"); timed between CUDA events."""
    from starway_tpu_torch.ops.flash import flash_attention

    q, k, v = (x.requires_grad_() for x in _qkv(b, hq, hkv, s, d))
    do = _randn(b, hq, s, d, seed=6)

    def kern():
        with torch.enable_grad():
            if impl == "ours":
                o = flash_attention(q, k, v, causal=causal)
            else:
                o = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                   enable_gqa=True)
            return torch.autograd.grad(o, (q, k, v), do)

    ms = wall_ms(kern, iters)
    return _row(f"flash_fwdbwd_{impl}_tflops",
                round(_attn_flops(b, hq, s, d, causal) * 3.5 / ms / 1e9, 2),
                "TFLOP/s", f"B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
                f"causal={causal} bf16, {ms:.4f} ms/iter (fwd+bwd, 3.5x the "
                f"forward's flops)")


def _decode_inputs(b, hq, hkv, t, d):
    q = _randn(b, hq, 1, d, seed=7)
    kc, vc = _randn(b, hkv, t, d, seed=8), _randn(b, hkv, t, d, seed=9)
    return q, kc, vc, 2 * b * hkv * t * d * 2


def bench_decode(b=1, hq=8, hkv=2, t=8192, d=128, iters: int = 64,
                 impl="ours"):
    """#1/#2 (csrc/decode_attention.cu) at the last position of a cache of
    t, bf16 or int8 ("int8"), or SDPA over the grouped cache ("lax")."""
    from starway_tpu_torch.ops.decode import decode_attention
    from starway_tpu_torch.ops.quantize import quantize_kv

    q, kc, vc, n_bytes = _decode_inputs(b, hq, hkv, t, d)
    pos = t - 1
    if impl == "int8":
        kc, ks = quantize_kv(kc)
        vc, vs = quantize_kv(vc)
        n_bytes = n_bytes // 2 + 2 * b * hkv * t * 4

        def kern():
            return decode_attention(q, kc, vc, pos, k_scale=ks, v_scale=vs)
    elif impl == "lax":
        def kern():
            return F.scaled_dot_product_attention(q, kc, vc, enable_gqa=True)
    else:
        def kern():
            return decode_attention(q, kc, vc, pos)
    ms = device_ms(kern, iters)
    return _row(f"decode_{impl}_us_per_token", round(ms * 1e3, 2), "us",
                f"B={b} Hq={hq} Hkv={hkv} T={t} D={d} "
                f"{'int8 cache' if impl == 'int8' else 'bf16'}, streamed "
                f"{n_bytes / 1e6:.1f} MB -> {n_bytes / ms / 1e6:.0f} GB/s "
                f"effective")


def bench_decode_tune(b=1, hq=8, hkv=2, t=8192, d=128, iters: int = 64):
    """#1's split over T swept (ops/decode_bench.py ``split_sweep``: the
    launch plan's split replaced by each count); one row a split and the
    best.  On the CPU the plain version ignores the split."""
    from starway_tpu_torch.ops.decode import decode_attention, max_splits

    q, kc, vc, n_bytes = _decode_inputs(b, hq, hkv, t, d)
    splits = [n for n in (1, 2, 4, 8, 16)
              if n <= max_splits(d) and n * 64 <= t]
    if DEV.type == "cuda":
        from starway_tpu_torch.ops.decode_bench import split_sweep

        by = split_sweep(lambda c: decode_attention(q, c, vc, t - 1),
                         [(kc,)], splits)
    else:
        by = {n: wall_ms(lambda: decode_attention(q, kc, vc, t - 1), iters)
              for n in splits}
    for n, ms in by.items():
        print(json.dumps(_row(f"decode_split{n}_us", round(ms * 1e3, 2),
                              "us", f"{n_bytes / ms / 1e6:.0f} GB/s "
                              f"effective")), flush=True)
    best = min(by, key=by.get)
    return _row("decode_best_config", best, "splits",
                f"{by[best] * 1e3:.2f} us at {best} splits over T "
                f"({n_bytes / by[best] / 1e6:.0f} GB/s)")


def bench_decode_paged(b=1, hq=8, hkv=2, t=8192, d=128, page=512,
                       iters: int = 64):
    """#9 (csrc/paged_attention.cu) over a scrambled page table at the
    decode row's shape: compare with decode_ours_us_per_token."""
    from starway_tpu_torch.ops.paged import paged_decode_attention

    rng = np.random.default_rng(0)
    max_pages = t // page
    n_pages = b * max_pages + 1
    kp = _randn(n_pages, hkv, page, d, seed=10)
    vp = _randn(n_pages, hkv, page, d, seed=11)
    table = torch.from_numpy(rng.permutation(np.arange(1, n_pages))[
        :b * max_pages].reshape(b, max_pages).astype(np.int32)).to(DEV)
    q = _randn(b, hq, 1, d, seed=12)
    pos = torch.full((b,), t - 1, dtype=torch.int32, device=DEV)
    n_bytes = 2 * b * hkv * t * d * 2
    ms = device_ms(lambda: paged_decode_attention(q, kp, vp, table, pos),
                   iters)
    return _row("decode_paged_us_per_token", round(ms * 1e3, 2), "us",
                f"B={b} Hq={hq} Hkv={hkv} T={t} page={page} bf16 scrambled "
                f"tables, streamed {n_bytes / 1e6:.1f} MB -> "
                f"{n_bytes / ms / 1e6:.0f} GB/s effective (compare "
                f"decode_ours_us_per_token)")


def bench_decode_shapes(iters: int = 64, shapes=None):
    """#1 against SDPA at three more (B, Hq, Hkv, T) points; one row each
    and the count of wins."""
    if shapes is None:
        shapes = [(8, 8, 2, 4096), (1, 32, 8, 8192), (4, 8, 1, 16384)]
    wins = 0
    for b, hq, hkv, t in shapes:
        pair = {}
        for impl in ("ours", "lax"):
            row = bench_decode(b=b, hq=hq, hkv=hkv, t=t, iters=iters,
                               impl=impl)
            row["metric"] = f"decode_{impl}_b{b}_hkv{hkv}_t{t}_us"
            pair[impl] = row["value"]
            print(json.dumps(row), flush=True)
        wins += pair["ours"] < pair["lax"]
    return _row("decode_shape_wins", wins, f"of_{len(shapes)}",
                "shapes (B,Hq,Hkv,T): " + "; ".join(
                    f"({b},{hq},{hkv},{t})" for b, hq, hkv, t in shapes))


def bench_gemv_int8(m=1, d=4096, f=14336, iters: int = 32):
    """#4 (csrc/int8_gemv.cu), W8A16 ``x [m, d] @ int8 W [d, f]``, against
    ``torch.matmul`` on the bf16 weight, each call on its own cold copy of
    its weight (utils/cuda_timing.py ``cold_copies``)."""
    from starway_tpu_torch.ops.gemv import int8_matmul
    from starway_tpu_torch.ops.quantize import quantize_weight
    from starway_tpu_torch.utils.cuda_timing import cold_copies, graph_us

    x = _randn(m, d, seed=13)
    w = _randn(d, f, seed=14) * d ** -0.5
    qw = quantize_weight(w)
    wq, s = qw["q"], qw["s"]
    if DEV.type == "cuda":
        ms_q = graph_us(lambda c: int8_matmul(x, c, s, static_weight=True),
                        cold_copies(wq), n=iters) / 1e3
        ms_b = graph_us(lambda c: torch.matmul(x, c), cold_copies(w),
                        n=iters) / 1e3
    else:
        ms_q = wall_ms(lambda: int8_matmul(x, wq, s, static_weight=True),
                       iters)
        ms_b = wall_ms(lambda: torch.matmul(x, w), iters)
    by_q, by_b = d * f, 2 * d * f
    return _row("gemv_int8_speedup", round(ms_b / ms_q, 2), "x_vs_bf16",
                f"m={m} d={d} f={f}: int8 {ms_q * 1e3:.1f} us "
                f"({by_q / ms_q / 1e6:.0f} GB/s) vs bf16 torch.matmul "
                f"{ms_b * 1e3:.1f} us ({by_b / ms_b / 1e6:.0f} GB/s)")


# ------------------------------------------------------------ the models

SERVE_WIDTHS = dict(d_model=1024, n_layers=8, n_heads=8, n_kv_heads=2,
                    d_ff=2816, vocab_size=32000, dtype="bfloat16")


def _serve_model(**overrides):
    from starway_tpu_torch.models import LlamaConfig, init_params

    cfg = LlamaConfig.preset("debug", **{**SERVE_WIDTHS, **overrides})
    return cfg, init_params(cfg, seed=0, device=DEV)


def _train_mfu_row(metric: str, cfg_kw: dict, B: int, S: int, iters: int,
                   compile_only: bool = False):
    """Model FLOP share of the card's bf16 peak of a train step (AdamW,
    the flash kernels forward and backward), timed between CUDA events.
    ``compile_only`` (the rehearsal): one step of the row's exact widths
    at one layer and S = 64, not timed against the peak."""
    from starway_tpu_torch.models import LlamaConfig, init_params
    from starway_tpu_torch.models.llama import make_train_step
    from starway_tpu_torch.utils.optim import adamw
    from starway_tpu_torch.utils.tree import tree_leaves

    if compile_only:
        cfg_kw, S = dict(cfg_kw, n_layers=1), 64
    cfg = LlamaConfig.preset("debug", **cfg_kw)
    params = init_params(cfg, seed=0, device=DEV)
    tx = adamw(1e-4)
    opt = tx.init(params)
    step = make_train_step(cfg, tx)
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1))).to(DEV)
    state = [params, opt]

    def one():
        with torch.enable_grad():
            state[0], state[1], _loss = step(state[0], state[1], batch)

    ms = wall_ms(one, iters)
    n_params = sum(x.numel() for x in tree_leaves(params))
    n_matmul = n_params - params["embed"].numel()
    attn = 6 * cfg.n_layers * cfg.n_heads * S * S * cfg.head_dim * B
    flops = 6 * n_matmul * B * S + attn
    if compile_only:
        return _row(f"{metric}_rehearsal_step", round(ms / 1e3, 3), "s",
                    f"one step of the row's widths at 1 layer, B={B} S={S} "
                    f"(d{cfg.d_model}, remat={cfg.remat}/{cfg.remat_policy})")
    return _row(metric, round(flops / ms / 1e9 / (BF16_PEAK / 1e12), 4),
                "frac_of_989T", f"{flops / ms / 1e9:.1f} TFLOP/s, "
                f"{n_params / 1e6:.1f}M params ({n_matmul / 1e6:.1f}M matmul)"
                f", B={B} S={S} remat={cfg.remat}, {ms:.1f} ms/step")


def bench_train_mfu(iters: int = 4, B: int = 8, S: int = 1024,
                    compile_only: bool = False):
    """A 4-layer d512 Llama's train step."""
    return _train_mfu_row(
        "train_step_mfu",
        dict(d_model=512, n_layers=4, n_heads=8, n_kv_heads=8, d_ff=1536,
             vocab_size=8192, dtype="bfloat16"),
        B=B, S=S, iters=iters, compile_only=compile_only)


def bench_train_mfu_large(iters: int = 2, compile_only: bool = False):
    """A 672M-parameter GQA Llama at S=8192 with "dots" remat."""
    return _train_mfu_row(
        "train_step_mfu_large",
        dict(d_model=2048, n_layers=12, n_heads=16, n_kv_heads=4,
             d_ff=5632, vocab_size=32000, dtype="bfloat16", remat=True,
             remat_policy="dots"),
        B=1, S=8192, iters=iters, compile_only=compile_only)


def bench_serve(batch=1, model="llama", ragged=False, prompt_len=512,
                m_lo=32, m_hi=1056, reps=4, iters=None, kv_quant="none",
                weights="none"):
    """``generate()`` tokens/s on the 8-layer d1024 serving model: the
    same workload at two ``max_new`` counts, wall time between CUDA
    events, differenced, so the prefill and the fixed costs cancel and
    the figure is the decode steps' (host and device).  ``iters`` is
    accepted for the command line's sake and ignored."""
    from starway_tpu_torch.models.generate import generate
    from starway_tpu_torch.ops.quantize import quantize_params

    over = dict(kv_quant=kv_quant)
    if model == "mistral":
        over["sliding_window"] = prompt_len
    elif model == "mixtral":
        over.update(n_experts=8, moe_top_k=2, moe_swiglu=True,
                    moe_capacity_factor=8.0, d_ff=1408)
    cfg, params = _serve_model(**over)
    if weights == "int8":
        params = quantize_params(params)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                           (batch, prompt_len))).to(DEV)
    lengths = None
    if ragged:
        lengths = torch.from_numpy(rng.integers(
            prompt_len // 4, prompt_len + 1, batch)).to(DEV)
    gen = torch.Generator(device=DEV)

    def run(m):
        gen.manual_seed(1)
        generate(params, cfg, prompt, m, temperature=0.8, top_k=64,
                 top_p=0.9, generator=gen, max_len=prompt_len + m_hi,
                 prompt_lengths=lengths)

    t_hi = wall_ms(lambda: run(m_hi), reps)
    t_lo = wall_ms(lambda: run(m_lo), reps)
    name = (f"serve_{model}{'_ragged' if ragged else ''}"
            f"{'_int8' if kv_quant == 'int8' else ''}"
            f"{'_w8' if weights == 'int8' else ''}_b{batch}")
    step_ms = (t_hi - t_lo) / (m_hi - m_lo)
    if step_ms <= 0:
        return {"metric": f"{name}_tokens_per_s", "card": CARD,
                "error": f"the longer run was not slower ({t_hi:.1f} ms vs "
                         f"{t_lo:.1f} ms); rerun"}
    return _row(f"{name}_tokens_per_s", round(batch / step_ms * 1e3, 1),
                "tok/s", f"{step_ms * 1e3 / batch:.1f} us/token (decode "
                f"steps, host included), wall {batch * m_lo / t_lo * 1e3:.1f}"
                f" tok/s at max_new={m_lo} (P={prompt_len}, prefill and fixed"
                f" costs {t_lo - m_lo * step_ms:.1f} ms a call), top_k=64 "
                f"top_p=0.9, {cfg.n_layers}L d{cfg.d_model} GQA "
                f"{cfg.n_heads}/{cfg.n_kv_heads} "
                f"{'W8' if weights == 'int8' else 'bf16'}"
                f"{'+KV8' if kv_quant == 'int8' else ''}")


def bench_spec_verify(gamma=8, t=4096, iters: int = 16):
    """One ``gamma``-wide chunk verify (``chunk_decode_step``) against
    ``gamma`` decode steps on the serving model: the amortisation an
    accepting draft realises, wall time between CUDA events."""
    from starway_tpu_torch.models.generate import decode_step, init_cache
    from starway_tpu_torch.models.llama import cfg_rope_tables
    from starway_tpu_torch.models.speculative import chunk_decode_step

    cfg, params = _serve_model()
    cache = init_cache(cfg, 1, t, device=DEV)
    rope = cfg_rope_tables(cfg, t, device=DEV)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (1, gamma))).to(DEV)
    pos = t - gamma - 1

    def chunk():
        return chunk_decode_step(params, cache, toks, pos, cfg, rope)[0]

    def steps():
        tok = toks[:, 0]
        for j in range(gamma):
            logits = decode_step(params, cache, tok, pos + j, cfg, rope)[0]
            tok = logits.argmax(-1)
        return tok

    ms_c, ms_s = wall_ms(chunk, iters), wall_ms(steps, iters)
    return _row("spec_verify_amortisation", round(ms_s / ms_c, 2),
                f"x_per_{gamma}tok", f"chunk verify {ms_c * 1e3:.0f} us vs "
                f"{gamma} decode steps {ms_s * 1e3:.0f} us (T={t}, 8L d1024 "
                f"GQA 8/2 bf16)")


def bench_serve_prefix(prompt_len=480, suffix_len=32, iters=8):
    """Prefix caching's admission: the full prefill of prefix + suffix
    against the suffix's ingest over the cached prefix."""
    from starway_tpu_torch.models.generate import prefill
    from starway_tpu_torch.models.llama import cfg_rope_tables
    from starway_tpu_torch.models.speculative import chunk_decode_step

    cfg, params = _serve_model()
    P, S = prompt_len, suffix_len
    T = P + S
    full = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (1, T))).to(DEV)
    rope = cfg_rope_tables(cfg, T, device=DEV)
    _, pre = prefill(params, cfg, full[:, :P], T)
    last = torch.tensor([T - 1], device=DEV)
    ms_full = wall_ms(lambda: prefill(params, cfg, full, T,
                                      logit_positions=last), iters)
    ms_pre = wall_ms(lambda: chunk_decode_step(params, pre, full[:, P:], P,
                                               cfg, rope), iters)
    return _row("serve_prefix_admit_speedup", round(ms_full / ms_pre, 2),
                "x", f"P={P} S={S}: full prefill {ms_full:.2f} ms vs suffix "
                f"ingest {ms_pre:.2f} ms")


def bench_serve_continuous(n_slots=8, chunk=16, n_requests=32,
                           prompt_len=192, max_new=96, iters=None):
    """Aggregate tokens/s of ``SlotServer`` under a stream of requests,
    wall clock end to end (admission, decode chunks and the host's
    scheduling).  ``iters`` is accepted and ignored."""
    from starway_tpu_torch.models import SlotServer

    cfg, params = _serve_model()
    rng = np.random.default_rng(0)

    def workload(n):
        srv = SlotServer(params, cfg, n_slots=n_slots,
                         max_len=prompt_len + max_new + 8, chunk=chunk,
                         temperature=0.8, top_k=64, seed=1)
        rids = [srv.submit(rng.integers(1, cfg.vocab_size, prompt_len),
                           max_new) for _ in range(n)]
        done = srv.run()
        return sum(len(done[r]) for r in rids)

    workload(max(2, n_slots // 2))
    _sync()
    t0 = time.perf_counter()
    total = workload(n_requests)
    _sync()
    dt = time.perf_counter() - t0
    return _row("serve_continuous_tokens_per_s", round(total / dt, 1),
                "tok/s", f"{n_requests} reqs (P={prompt_len} N={max_new}) "
                f"through {n_slots} slots, chunk={chunk}, sampled top_k=64, "
                f"{total} tokens in {dt:.2f} s wall, 8L d1024 GQA 8/2 bf16")


# ------------------------------------------------------------ numerics


def check_numerics(scale: int = 1) -> list:
    """Each of the nine kernels against its plain version (the module
    docstring's tolerances); ``scale`` divides the lengths (the
    rehearsal)."""
    from starway_tpu_torch.ops.decode import (decode_attention,
                                              decode_attention_reference)
    from starway_tpu_torch.ops.flash import (flash_backward,
                                             flash_backward_reference,
                                             flash_forward,
                                             flash_forward_reference,
                                             flash_partial,
                                             flash_partial_bwd,
                                             flash_partial_bwd_reference,
                                             flash_partial_reference)
    from starway_tpu_torch.ops.gemv import (int8_matmul,
                                            int8_matmul_reference,
                                            tolerance_share)
    from starway_tpu_torch.ops.paged import (paged_decode_attention,
                                             paged_decode_attention_reference)
    from starway_tpu_torch.ops.quantize import quantize_kv, quantize_weight

    hq, hkv, d = 32, 8, 128
    rows = []

    def add(n, metric, value, unit, tol, kernel):
        rows.append(_row(metric, value, unit, f"#{n} {kernel} against its "
                         f"plain version", ok=bool(value <= tol), tol=tol))

    def abs_err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def rel_err(a, b):
        return abs_err(a, b) / max(b.float().abs().max().item(), 1e-30)

    # #1 and #2: one query a row, then four (bf16 and int8 caches, a
    # window), at the serving shape (B=8, T=2048, ragged cursors).
    b, t = 8, 2048 // scale
    kc, vc = _randn(b, hkv, t, d, seed=20), _randn(b, hkv, t, d, seed=21)
    k8, ks = quantize_kv(kc)
    v8, vs = quantize_kv(vc)
    pos = torch.from_numpy(np.random.default_rng(0).integers(
        t // 4, t - 4, b).astype(np.int32)).to(DEV)
    for n, n_q, name in ((1, 1, "decode_stream"), (2, 4, "decode_rows")):
        q = _randn(b, hq, n_q, d, seed=22 + n_q)
        worst = 0.0
        for kw in (dict(), dict(window=t // 4),
                   dict(k_scale=ks, v_scale=vs)):
            k_, v_ = (k8, v8) if "k_scale" in kw else (kc, vc)
            worst = max(worst, abs_err(
                decode_attention(q, k_, v_, pos, **kw),
                decode_attention_reference(q, k_, v_, pos, **kw)))
        add(n, f"check_{name}_onchip", worst, "max_abs_err", BF16_TOL,
            "decode_attention")
    del kc, vc, k8, v8

    # #3 and #5/#6: the flash forward and backward, B=2 S=2048 causal.
    s = 2048 // scale
    q, k, v = (_randn(2, hq, s, d, seed=30), _randn(2, hkv, s, d, seed=31),
               _randn(2, hkv, s, d, seed=32))
    do = _randn(2, hq, s, d, seed=33)
    o, lse = flash_forward(q, k, v, causal=True)
    o_r, lse_r = flash_forward_reference(q, k, v, causal=True)
    ok_lse = abs_err(lse, lse_r) <= LSE_TOL
    add(3, "check_flash_fwd_onchip",
        abs_err(o, o_r) if ok_lse else float("inf"), "max_abs_err", BF16_TOL,
        "flash_forward")
    # flash_backward launches #5 (dk, dv) then #6 (dq) on the card.
    want = flash_backward_reference(q, k, v, o, lse, do, causal=True)
    dq, dk, dv = flash_backward(q, k, v, o, lse, do, causal=True)
    add(5, "check_flash_bwd_dkv_onchip",
        max(rel_err(dk, want[1]), rel_err(dv, want[2])), "max_rel_err",
        GRAD_REL_TOL, "flash_backward_dkv")
    add(6, "check_flash_bwd_dq_onchip", rel_err(dq, want[0]), "max_rel_err",
        GRAD_REL_TOL, "flash_backward_dq")
    del q, k, v, do, o, o_r

    # #7 and #8: one ring step's past block (q at 1024, kv at 0) and its
    # gradients, at train-ring's shard shape.
    t = 1024 // scale
    q, k, v = (_randn(1, hq, t, d, seed=40), _randn(1, hkv, t, d, seed=41),
               _randn(1, hkv, t, d, seed=42))
    do = _randn(1, hq, t, d, seed=43)
    o, m, l = flash_partial(q, k, v, t, 0, causal=True)
    o_r, m_r, l_r = flash_partial_reference(q, k, v, t, 0, causal=True)
    o_n, o_rn = o / l[..., None], o_r / l_r[..., None]
    ok_ml = abs_err(m, m_r) <= LSE_TOL and rel_err(l, l_r) <= LSE_TOL
    add(7, "check_flash_partial_onchip",
        rel_err(o_n, o_rn) if ok_ml else float("inf"), "max_rel_err",
        GRAD_REL_TOL, "flash_partial")
    lse = m + torch.log(l)
    delta = (do.float() * o_n).sum(-1)
    got = flash_partial_bwd(q, do, k, v, lse, delta, t, 0, causal=True)
    want = flash_partial_bwd_reference(q, do, k, v, lse, delta, t, 0,
                                       causal=True)
    add(8, "check_flash_partial_bwd_onchip",
        max(rel_err(a, b) for a, b in zip(got, want)), "max_rel_err",
        GRAD_REL_TOL, "flash_partial_bwd")

    # #4: the W8A16 GEMV in both regimes (decode M=8, prefill M=512).
    dd, f = 4096 // scale, 14336 // scale
    qw = quantize_weight(_randn(dd, f, seed=50, dtype=torch.float32)
                         * dd ** -0.5)
    share = max(tolerance_share(
        int8_matmul(x, qw["q"], qw["s"], static_weight=True),
        int8_matmul_reference(x, qw["q"], qw["s"]))
        for x in (_randn(8, dd, seed=51), _randn(512, dd, seed=52)))
    add(4, "check_gemv_int8_onchip", share, "tolerance_share", 1.0,
        "int8_matmul")

    # #9: 16 slots, page 64, ragged cursors over a scrambled table whose
    # entries past each cursor are never read.
    b, page, max_pages = 16, 64, 4096 // 64 // scale
    rng = np.random.default_rng(1)
    n_pages = 1 + b * max_pages
    table = rng.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        b, max_pages)
    pos_np = rng.integers(page, (max_pages - 1) * page, b).astype(np.int32)
    for i in range(b):
        table[i, pos_np[i] // page + 1:] = 2 ** 30 + i
    kp = _randn(n_pages, hkv, page, d, seed=60)
    vp = _randn(n_pages, hkv, page, d, seed=61)
    q = _randn(b, hq, 1, d, seed=62)
    table_d = torch.from_numpy(table).to(DEV)
    pos = torch.from_numpy(pos_np).to(DEV)
    ref_table = table_d.clamp(max=n_pages - 1)  # the plain gather reads all
    add(9, "check_paged_onchip", abs_err(
        paged_decode_attention(q, kp, vp, table_d, pos),
        paged_decode_attention_reference(q, kp, vp, ref_table, pos)),
        "max_abs_err", BF16_TOL, "paged_decode_attention")
    _sync()
    return sorted(rows, key=lambda r: int(r["detail"].split()[0][1:]))


# Scaled-down sizes of every row for STARWAY_BENCH_REHEARSAL=1: the exact
# code path of each row on the CPU in seconds.  Only sizes shrink; the
# identity of a row (its batch, model, cache type) stays.
_REHEARSAL_SERVE = dict(prompt_len=32, m_lo=2, m_hi=6, reps=1)
REHEARSAL_KW = {
    "matmul": dict(n=256, iters=2),
    "flash": dict(s=256, iters=2),
    "flash_stock": dict(s=256, iters=2),
    "flash_window": dict(s=512, window=128, iters=2),
    "flash_bwd": dict(s=256, iters=2),
    "flash_bwd_stock": dict(s=256, iters=2),
    "decode": dict(t=512, iters=2),
    "decode_lax": dict(t=512, iters=2),
    "decode_int8": dict(t=512, iters=2),
    "decode_tune": dict(t=512, iters=2),
    "decode_paged": dict(t=512, page=128, iters=2),
    "decode_shapes": dict(
        iters=2, shapes=[(2, 8, 2, 256), (1, 8, 4, 256), (2, 8, 1, 512)]),
    "train_mfu": dict(iters=1, B=2, S=64),
    "train_mfu_large": dict(iters=1, compile_only=True),
    "serve": _REHEARSAL_SERVE,
    "serve_b8": _REHEARSAL_SERVE,
    "serve_int8_b8": _REHEARSAL_SERVE,
    "serve_w8_b1": _REHEARSAL_SERVE,
    "gemv_int8": dict(d=256, f=512, iters=2),
    "serve_ragged_b8": _REHEARSAL_SERVE,
    "serve_mistral": _REHEARSAL_SERVE,
    "serve_mixtral": _REHEARSAL_SERVE,
    "serve_continuous": dict(n_slots=2, chunk=4, n_requests=4, prompt_len=16,
                             max_new=4),
    "serve_prefix": dict(prompt_len=32, suffix_len=8, iters=1),
    "spec_verify": dict(t=64, iters=1),
}

BENCHES = {
    "matmul": bench_matmul,
    "flash": bench_flash_fwd,
    "flash_stock": functools.partial(bench_flash_fwd, impl="stock"),
    "flash_window": bench_flash_window,
    "flash_bwd": bench_flash_bwd,
    "flash_bwd_stock": functools.partial(bench_flash_bwd, impl="stock"),
    "decode": bench_decode,
    "decode_lax": functools.partial(bench_decode, impl="lax"),
    "decode_int8": functools.partial(bench_decode, impl="int8"),
    "decode_tune": bench_decode_tune,
    "decode_paged": bench_decode_paged,
    "decode_shapes": bench_decode_shapes,
    "train_mfu": bench_train_mfu,
    "train_mfu_large": bench_train_mfu_large,
    "serve": bench_serve,
    "serve_b8": functools.partial(bench_serve, batch=8),
    "serve_int8_b8": functools.partial(bench_serve, batch=8,
                                       kv_quant="int8"),
    "serve_w8_b1": functools.partial(bench_serve, kv_quant="int8",
                                     weights="int8"),
    "gemv_int8": bench_gemv_int8,
    "serve_ragged_b8": functools.partial(bench_serve, batch=8, ragged=True),
    "serve_mistral": functools.partial(bench_serve, model="mistral"),
    "serve_mixtral": functools.partial(bench_serve, model="mixtral"),
    "serve_continuous": bench_serve_continuous,
    "serve_prefix": bench_serve_prefix,
    "spec_verify": bench_spec_verify,
}

# The rows "all" leaves out: the sweeps, the end-to-end serving rows and
# the model-scale train step, each run alone by scripts/torch/
# onchip_refresh.sh.
HEAVY = ("serve", "serve_b8", "serve_ragged_b8", "serve_mistral",
         "serve_int8_b8", "serve_w8_b1", "serve_continuous", "serve_mixtral",
         "train_mfu_large", "decode_shapes", "spec_verify", "gemv_int8")


def main(argv=None) -> int:
    global DEV, CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--which", default="all",
                    help="comma list of rows, 'all', or 'check' (the nine "
                         "kernels against their plain versions)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N (default), or cpu for the plain versions")
    args = ap.parse_args(argv)
    rehearsal = os.environ.get("STARWAY_BENCH_REHEARSAL") == "1"
    if rehearsal:
        args.device = "cpu"
    DEV = torch.device(args.device)
    if DEV.type == "cuda":
        if not torch.cuda.is_available():
            print("kernel_bench: no CUDA device; pass --device cpu (or "
                  "STARWAY_BENCH_REHEARSAL=1) to run the plain versions on "
                  "the CPU", file=sys.stderr)
            return 2
        from starway_tpu_torch.utils.cuda_timing import card_name

        torch.backends.cuda.matmul.allow_tf32 = False
        CARD = card_name()
    else:
        CARD = "cpu (plain versions" + (", rehearsal sizes)" if rehearsal
                                        else ")")
    torch.set_grad_enabled(False)
    if args.which == "all":
        names = [n for n in BENCHES
                 if not n.endswith("_tune") and n not in HEAVY]
    else:
        names = args.which.split(",")
    unknown = [n for n in names if n != "check" and n not in BENCHES]
    if unknown:
        ap.error(f"unknown rows {unknown}; choose from check, all, "
                 f"{', '.join(BENCHES)}")
    exit_code = 0
    for name in names:
        if name == "check":
            for row in check_numerics(8 if rehearsal else 1):
                exit_code |= not row["ok"]
                print(json.dumps(row), flush=True)
            continue
        kw = {"iters": args.iters} if args.iters else {}
        if rehearsal:
            kw.update(REHEARSAL_KW.get(name, {}))
        try:
            row = BENCHES[name](**kw)
        except Exception as e:  # keep going; the failure is a row
            row = {"metric": name, "card": CARD,
                   "error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps(row), flush=True)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
