#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (starway_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build   -- compile the CUDA kernels from starway_tpu_torch/csrc with nvcc
2. card    -- print the card's name and power limit (nvidia-smi)
3. kernels -- each kernel against its plain PyTorch version at the serving
              and training paths' shapes: max error, median time (CUDA
              events), the plain version's time, one PyTorch library
              call's time, and the least time the card could take (bytes /
              3.35 TB/s or operations / 989 TFLOP/s, whichever is larger)
4. serve   -- SlotServer on llama3-8b widths (bf16, 32 layers, random
              weights): 12 requests through 8 slots; first-token logits of
              one request against a forward through the plain attention
5. int8    -- phase 4 again with an int8 KV cache and W8A16 weights
6. parity  -- float32, 2 layers at the same widths: SlotServer's greedy
              tokens equal generate()'s for every request
7. train   -- Trainer + adamw on llama3-8b widths cut to 4 layers (bf16,
              remat "dots"), 6 steps on one [2, 2049] batch: loss per
              step, median step ms, tokens/s, model FLOP share, one step
              traced for the device-busy share and the top kernels
8. train-parity -- float32, 2 layers, [1, 513]: loss and every gradient of
              one step through the kernels against the same step through
              the plain attention; the flash forward and each backward
              pass launch once per layer
9. a JSON line of the kernels with their launches on the serving path
   (phases 4 and 5) and the training path (phase 7) and the numbers of
   phase 3
10. the last line: {"ok": true, "device": {...}}

Exits non-zero, printing no result, without a CUDA device.  Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor rate (data sheet)
BF16_TOL = 2e-2             # absolute, bf16 outputs: one rounding of O(1)
LOGIT_REL_TOL = 5e-2        # bf16 logits after 32 layers, vs max |logit|
# Gradients, against their largest value: bf16 one ulp (2^-7 < 1e-2), the
# kernels and the plain version round p and ds at the same points; f32
# 1e-4, sums of up to S products in another order.
GRAD_REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# A float32 train step through 2 layers at full width, kernels against the
# plain attention: the attention gradients differ in summation order, and
# the 4096- and 14336-wide float32 matmuls carry that into every leaf.
TRAIN_GRAD_REL_TOL = 1e-3
LR_TRAIN = 2e-4  # AdamW on bf16 weights of ~0.016: steps above half an ulp
SEED = 0


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev):
    """Phase 3: every kernel against its plain version; returns the rows of
    the kernels line (launch counts filled in later)."""
    import torch
    import torch.nn.functional as F

    from starway_tpu_torch.ops.decode import (decode_attention,
                                              decode_attention_reference)
    from starway_tpu_torch.ops.flash import (flash_forward,
                                             flash_forward_reference)
    from starway_tpu_torch.ops.gemv import (int8_matmul,
                                            int8_matmul_reference)
    from starway_tpu_torch.ops.quantize import quantize_kv, quantize_weight

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = {}

    # -- decode attention: B=8 slots, llama3-8b heads, T = max_len = 2048.
    B, HQ, HKV, D, T = 8, 32, 8, 128, 2048
    k16, v16 = randn(B, HKV, T, D), randn(B, HKV, T, D)
    k8, ks = quantize_kv(k16)
    v8, vs = quantize_kv(v16)
    worst = 0.0
    timed = None
    for n_q in (1, 4):
        q = randn(B, HQ, n_q, D)
        pos = torch.from_numpy(
            rng.integers(50, T - n_q, B).astype(np.int32)).to(dev)
        for quant in (False, True):
            for window in (None, 512):
                kw = dict(window=window)
                kc, vc = (k8, v8) if quant else (k16, v16)
                if quant:
                    kw.update(k_scale=ks, v_scale=vs)
                got = decode_attention(q, kc, vc, pos, **kw)
                want = decode_attention_reference(q, kc, vc, pos, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                worst = max(worst, err)
                log(f"decode_attention C={n_q} int8={quant} window={window}: "
                    f"max_abs_err {err:.3e} (tol {BF16_TOL})")
                if not err <= BF16_TOL:
                    raise AssertionError("decode_attention disagrees with "
                                         "its plain version")
                if n_q == 1 and window is None:
                    ms = cuda_ms(lambda: decode_attention(q, kc, vc, pos,
                                                          **kw))
                    plain = cuda_ms(lambda: decode_attention_reference(
                        q, kc, vc, pos, **kw), iters=5)
                    live = int((pos.long() + n_q).clamp(max=T).sum())
                    elem = 1 if quant else 2
                    n_bytes = (2 * live * HKV * D * elem
                               + (2 * live * HKV * 4 if quant else 0)
                               + 2 * q.numel() * 2 + B * 4)
                    n_flops = 4 * live * HQ * D
                    b_ms, b_by = bound(n_bytes, n_flops)
                    lib = None
                    if not quant:
                        mask = (torch.arange(T, device=dev)[None, :]
                                <= pos[:, None])[:, None, None, :]
                        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                            q, k16, v16, attn_mask=mask, enable_gqa=True))
                    log(f"  timed: {ms:.4f} ms, plain {plain:.4f} ms, "
                        f"library {lib} ms, bound {b_ms:.4f} ms ({b_by})")
                    if not quant:
                        timed = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib,
                                     timed_at=f"B={B} Hq={HQ} Hkv={HKV} "
                                              f"D={D} T={T} C=1 bf16 "
                                              f"ragged pos")
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="starway_tpu_torch/csrc/decode_attention.cu",
        replaces="starway_tpu/ops/pallas_decode.py:150 "
                 "(_decode_stream_kernel; also :107 _decode_kernel)",
        max_abs_err=worst, **timed)
    del k16, v16, k8, v8, ks, vs

    # -- flash forward: admission prefill shapes, causal GQA 4:1, bf16.
    worst = 0.0
    for s in (512, 2048):
        q, k, v = randn(1, HQ, s, D), randn(1, HKV, s, D), randn(1, HKV, s, D)
        o, lse = flash_forward(q, k, v, causal=True)
        o_ref, lse_ref = flash_forward_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        worst = max(worst, err)
        log(f"flash_forward S={s}: max_abs_err {err:.3e} (tol {BF16_TOL}), "
            f"lse {lse_err:.3e} (tol 1e-3)")
        if not (err <= BF16_TOL and lse_err <= 1e-3):
            raise AssertionError("flash_forward disagrees with its plain "
                                 "version")
        ms = cuda_ms(lambda: flash_forward(q, k, v, causal=True))
        plain = cuda_ms(lambda: flash_forward_reference(q, k, v, causal=True),
                        iters=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        pairs = s * (s + 1) // 2
        n_flops = 4 * HQ * D * pairs
        n_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * HQ * s
        b_ms, b_by = bound(n_bytes, n_flops)
        log(f"  timed: {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by})")
        timed = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib,
                     timed_at=f"B=1 Hq={HQ} Hkv={HKV} D={D} S={s} causal "
                              f"bf16")
    rows["flash_forward"] = dict(
        name="flash_attention_fwd", route="cuda",
        source="starway_tpu_torch/csrc/flash_fwd.cu",
        replaces="starway_tpu/ops/pallas_attention.py:124 (_fwd_kernel)",
        max_abs_err=worst, **timed)

    rows.update(flash_backward_rows(dev, randn))

    # -- int8 GEMV: decode (M=8) and prefill (M=512) rows, the llama3-8b
    # projection shapes and the lm_head.
    worst = 0.0
    timed = None
    for d, f in ((4096, 14336), (14336, 4096), (4096, 128256)):
        w = quantize_weight(randn(d, f, dtype=torch.float32) * d ** -0.5)
        wq, sc = w["q"], w["s"]
        w_deq = (wq.float() * sc).to(torch.bfloat16)
        for m in (8, 512):
            x = randn(m, d)
            got = int8_matmul(x, wq, sc)
            want = int8_matmul_reference(x, wq, sc)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            ms = cuda_ms(lambda: int8_matmul(x, wq, sc))
            plain = cuda_ms(lambda: int8_matmul_reference(x, wq, sc), iters=5)
            lib = cuda_ms(lambda: torch.matmul(x, w_deq))
            n_bytes = d * f + 4 * f + 2 * m * d + 2 * m * f
            b_ms, b_by = bound(n_bytes, 2 * m * d * f)
            log(f"int8_matmul M={m} D={d} F={f}: max_abs_err {err:.3e} "
                f"(tol {BF16_TOL}); {ms:.4f} ms, plain {plain:.4f} ms, "
                f"library {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            if not err <= BF16_TOL:
                raise AssertionError("int8_matmul disagrees with its plain "
                                     "version")
            if (m, d, f) == (8, 4096, 14336):
                timed = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib,
                             timed_at=f"M={m} D={d} F={f} bf16")
        del w, wq, sc, w_deq
    rows["int8_matmul"] = dict(
        name="int8_matmul", route="cuda",
        source="starway_tpu_torch/csrc/int8_gemv.cu",
        replaces="starway_tpu/ops/pallas_gemv.py:32 (_gemv_kernel)",
        max_abs_err=worst, **timed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def visible_pairs(s_len: int, causal: bool, window=None) -> int:
    """(q, k) pairs that the attention computes: what this run needs."""
    if not causal:
        return s_len * s_len
    reach = np.minimum(np.arange(1, s_len + 1), window or s_len)
    return int(reach.sum())


def flash_backward_rows(dev, randn):
    """The two backward kernels against flash_backward_reference: the
    training shapes (B=2, S=2048 and B=1, S=4096, causal, GQA 4:1, bf16)
    and small float32 / bfloat16 shapes (non-causal, window, uneven S,
    other head sizes).  Timed at B=2, S=2048."""
    import torch
    import torch.nn.functional as F

    from starway_tpu_torch.ops.flash import (flash_backward,
                                             flash_backward_dkv,
                                             flash_backward_dq,
                                             flash_backward_reference,
                                             flash_forward)

    HQ, HKV = 32, 8
    cases = [(2, HQ, HKV, 2048, 128, True, None, torch.bfloat16),
             (1, HQ, HKV, 4096, 128, True, None, torch.bfloat16),
             (2, 4, 2, 100, 128, True, None, torch.float32),
             (2, 4, 4, 70, 64, False, None, torch.float32),
             (1, 8, 2, 150, 16, True, 17, torch.float32),
             (1, 4, 2, 130, 128, True, 40, torch.bfloat16),
             (2, 4, 1, 256, 32, True, None, torch.bfloat16)]
    worst = {"dkv": 0.0, "dq": 0.0}
    timed = {}
    for b, hq, hkv, s_len, d, causal, window, dt in cases:
        q, do = randn(b, hq, s_len, d, dtype=dt), randn(b, hq, s_len, d,
                                                        dtype=dt)
        k, v = randn(b, hkv, s_len, d, dtype=dt), randn(b, hkv, s_len, d,
                                                        dtype=dt)
        kw = dict(causal=causal, window=window)
        o, lse = flash_forward(q, k, v, **kw)
        got = flash_backward(q, k, v, o, lse, do, **kw)
        want = flash_backward_reference(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        tol = GRAD_REL_TOL[str(dt).removeprefix("torch.")]
        rel = [((g.float() - w.float()).abs().max()
                / w.float().abs().max()).item() for g, w in zip(got, want)]
        abs_err = [(g.float() - w.float()).abs().max().item()
                   for g, w in zip(got, want)]
        worst["dq"] = max(worst["dq"], abs_err[0])
        worst["dkv"] = max(worst["dkv"], abs_err[1], abs_err[2])
        log(f"flash_backward B={b} Hq={hq} Hkv={hkv} S={s_len} D={d} "
            f"causal={causal} window={window} {dt}: max_abs_err dq/dk/dv "
            f"{abs_err[0]:.3e}/{abs_err[1]:.3e}/{abs_err[2]:.3e}, "
            f"relative to max |grad| {max(rel):.3e} (tol {tol})")
        if not max(rel) <= tol:
            raise AssertionError("flash_backward disagrees with its plain "
                                 "version")
        if s_len < 2048:
            continue
        delta = (do.float() * o.float()).sum(dim=-1)
        kkw = dict(kw, sm_scale=d ** -0.5)
        dkv_ms = cuda_ms(lambda: flash_backward_dkv(q, k, v, do, lse, delta,
                                                    **kkw))
        dq_ms = cuda_ms(lambda: flash_backward_dq(q, k, v, do, lse, delta,
                                                  **kkw))
        plain = cuda_ms(lambda: flash_backward_reference(q, k, v, o, lse, do,
                                                         **kw), iters=5)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o_lib = F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=True)
            lib = cuda_ms(lambda: torch.autograd.grad(
                o_lib, leaves, do, retain_graph=True))
            del o_lib, leaves
        # One product: 2 * D flops per visible pair and q head.  Bytes:
        # q, dO, k, v, lse and delta read once, the gradients written once.
        flops = 2 * d * visible_pairs(s_len, causal, window) * hq * b
        es = q.element_size()
        io = es * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * b * hq * s_len
        dkv_b = bound(io + es * 2 * k.numel(), 4 * flops)
        dq_b = bound(io + es * q.numel(), 3 * flops)
        log(f"  timed: dK/dV {dkv_ms:.4f} ms (bound {dkv_b[0]:.4f} ms, "
            f"{dkv_b[1]}), dQ {dq_ms:.4f} ms (bound {dq_b[0]:.4f} ms, "
            f"{dq_b[1]}); plain (both passes) {plain:.4f} ms, library "
            f"(SDPA backward, both passes) {lib:.4f} ms")
        if (b, s_len) == (2, 2048):
            at = (f"B={b} Hq={hq} Hkv={hkv} D={d} S={s_len} causal bf16; "
                  f"plain_ms and library_ms cover both passes")
            timed["dkv"] = dict(ms=dkv_ms, plain_ms=plain,
                                bound_ms=dkv_b[0], bound_by=dkv_b[1],
                                library_ms=lib, timed_at=at)
            timed["dq"] = dict(ms=dq_ms, plain_ms=plain, bound_ms=dq_b[0],
                               bound_by=dq_b[1], library_ms=lib,
                               timed_at=at)
        del q, k, v, do, o, lse, got, want, delta
        torch.cuda.empty_cache()
    src = "starway_tpu_torch/csrc/flash_bwd.cu"
    return {
        "flash_backward_dkv": dict(
            name="flash_attention_bwd_dkv", route="cuda", source=src,
            replaces="starway_tpu/ops/pallas_attention.py:309 "
                     "(_bwd_dkv_kernel)",
            max_abs_err=worst["dkv"], **timed["dkv"]),
        "flash_backward_dq": dict(
            name="flash_attention_bwd_dq", route="cuda", source=src,
            replaces="starway_tpu/ops/pallas_attention.py:364 "
                     "(_bwd_dq_kernel)",
            max_abs_err=worst["dq"], **timed["dq"])}


def make_requests(cfg, n: int = 12):
    rng = np.random.default_rng(SEED + 1)
    return [(rng.integers(1, cfg.vocab_size, int(p)).tolist(), int(m))
            for p, m in zip(rng.integers(50, 1501, n), rng.integers(16, 65, n))]


def serve(params, cfg, reqs, *, n_slots=8, max_len=2048, chunk=8):
    """Drive SlotServer over ``reqs``; returns (finished, stats)."""
    import torch

    from starway_tpu_torch.models import SlotServer

    chunk_ms, traced = [], {}

    class TimedServer(SlotServer):
        def _run_chunk(self):
            torch.cuda.synchronize()
            if len(chunk_ms) == 2 and not traced:  # trace one steady chunk
                return self._traced_chunk()
            t0 = time.perf_counter()
            out = super()._run_chunk()  # ends with a device-to-host copy
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def _traced_chunk(self):
            """One chunk under torch.profiler: its summed kernel time is the
            device's busy time for a chunk.  The tracer's own start-up and
            event processing are timed too, and left out of the run's
            wall time."""
            from torch.profiler import ProfilerActivity, profile

            t_call = time.perf_counter()
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = super()._run_chunk()
                wall_ms = (time.perf_counter() - t0) * 1e3
            busy_us = sum(
                getattr(e, "self_device_time_total", 0)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
            traced.update(
                traced_chunk_ms=wall_ms,
                device_busy_ms=busy_us / 1e3 if busy_us else None,
                tracer_overhead_s=time.perf_counter() - t_call - wall_ms / 1e3)
            return out

    srv = TimedServer(params, cfg, n_slots=n_slots, max_len=max_len,
                      chunk=chunk, seed=SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [srv.submit(p, m) for p, m in reqs]
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - traced.get("tracer_overhead_s", 0.0)
    for rid, (_p, m) in zip(rids, reqs):
        got = done.get(rid)
        if got is None or len(got) != m:
            raise AssertionError(f"request {rid} finished with "
                                 f"{None if got is None else len(got)} "
                                 f"tokens, budget {m}")
        if not ((got >= 0) & (got < cfg.vocab_size)).all():
            raise AssertionError(f"request {rid} emitted out-of-vocab ids")
    n_tok = sum(m for _p, m in reqs)
    stats = dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                 chunks=len(chunk_ms) + bool(traced),
                 median_chunk_ms=statistics.median(chunk_ms), **traced)
    if traced.get("device_busy_ms"):  # else: not measured (no CUDA events)
        # Against an untraced chunk: tracing slows the host, not the device.
        stats["device_idle_share"] = (
            1 - traced["device_busy_ms"] / stats["median_chunk_ms"])
    return dict(zip(rids, (done[r] for r in rids))), stats


def check_first_logits(params, cfg, prompt, max_len):
    """First-token logits of one request as admission computes them (the
    flash kernel) against a forward through the plain attention."""
    import torch

    from starway_tpu_torch.models.generate import prefill
    from starway_tpu_torch.models.llama import forward
    from starway_tpu_torch.models.serving import _bucket, default_buckets
    from starway_tpu_torch.ops.flash import flash_forward_reference

    dev = params["embed"].device
    pb = _bucket(len(prompt), default_buckets(max_len))
    padded = torch.zeros((1, pb), dtype=torch.long, device=dev)
    padded[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    last = torch.tensor([len(prompt) - 1], device=dev)
    got, _ = prefill(params, cfg, padded, pb, logit_positions=last)

    def plain_attn(q, k, v):
        return flash_forward_reference(q, k, v, causal=True)[0]

    want = forward(params, padded, cfg, plain_attn, logit_positions=last)[:, 0]
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    same_top = bool((got.argmax(-1) == want.argmax(-1)).all())
    log(f"  first-token logits: max_abs_err {err:.4e}, max |logit| "
        f"{scale:.4e}, rel {err / scale:.4e} (tol {LOGIT_REL_TOL}), "
        f"same argmax {same_top}")
    if not (np.isfinite(err) and err <= LOGIT_REL_TOL * scale):
        raise AssertionError("first-token logits disagree with the plain "
                             "forward")
    return err / scale


def train_batch(cfg, b: int, s_plus_1: int, seed: int, dev):
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (b, s_plus_1))).to(dev)


def model_flops(cfg, tokens: int, b: int, s_len: int) -> float:
    """Model FLOPs of one training step: 6 * N * tokens over the matmul
    weights (the layers' projections and the lm_head; the embedding is a
    gather) plus the attention's two products, forward and backward
    (3 x 4 * D per visible pair and q head), without remat's recompute."""
    hd, L = cfg.head_dim, cfg.n_layers
    per_layer = (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    n = L * per_layer + cfg.d_model * cfg.vocab_size
    attn = 12 * hd * visible_pairs(s_len, True) * cfg.n_heads * b * L
    return 6.0 * n * tokens + attn


def kernel_family(name: str) -> str:
    for key in ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"):
        if key in name:
            return key
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    return "elementwise, reductions, copies"


def trace_summary(prof, traced_ms: float) -> dict:
    """Device time of one traced step: busy total, by kernel family, of
    the optimizer (the trainer's profiler range "apply") and the top
    kernels by name."""
    import torch

    phase_names = ("grad", "apply")
    events = prof.key_averages()
    # Device-side events, less the profiler ranges' own GPU spans.
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in phase_names]
    busy_us = sum(e.self_device_time_total for e in kern)
    family, by_name = {}, {}
    for e in kern:
        f = kernel_family(e.key)
        family[f] = family.get(f, 0) + e.self_device_time_total / 1e3
        by_name[e.key[:90]] = (by_name.get(e.key[:90], 0)
                               + e.self_device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # A host-side range's device time is that of the kernels its operations
    # launched.  Only "apply" (the optimizer) is whole: autograd launches
    # the backward's kernels from its own device thread, outside "grad".
    optimizer_ms = sum(e.device_time_total / 1e3 for e in events
                       if e.key == "apply"
                       and e.device_type == torch.autograd.DeviceType.CPU)
    return dict(traced_step_ms=traced_ms,
                device_busy_ms=busy_us / 1e3 if busy_us else None,
                device_ms_by_family={k: round(v, 3)
                                     for k, v in family.items()},
                device_ms_optimizer=round(optimizer_ms, 3),
                top_kernels_ms={k: round(v, 3) for k, v in top})


def phase_train(dev):
    """Phase 7: Trainer + adamw, llama3-8b widths cut to 4 layers, bf16,
    remat "dots", 6 steps on one batch.  Returns (stats, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from starway_tpu_torch.models import LlamaConfig, Trainer, init_params
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.utils import adamw

    B, S, STEPS = 2, 2048, 6
    cfg = LlamaConfig.preset("llama3-8b", n_layers=4, remat=True,
                             remat_policy="dots")
    params = init_params(cfg, SEED + 3, device=dev)
    batch = train_batch(cfg, B, S + 1, SEED + 4, dev)
    trainer = Trainer(cfg, adamw(LR_TRAIN), params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"[train] llama3-8b widths, {cfg.n_layers} layers (cut from 32), "
        f"bf16, remat dots, AdamW lr {LR_TRAIN:g}, batch [{B}, {S + 1}], "
        f"{STEPS} steps on one batch")
    losses, step_ms, traced = [], [], {}
    reset_launch_counts()
    for i in range(STEPS):
        if i == STEPS - 1:  # the last step, under the profiler
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                losses.append(trainer.step_sync(batch))
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
            traced = trace_summary(prof, traced_ms)
            continue
        t0 = time.perf_counter()
        losses.append(trainer.step_sync(batch))  # ends in loss.item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  step {i + 1}: loss {losses[-1]:.4f}, {step_ms[-1]:.1f} ms")
    counts = launch_counts()
    log(f"  step {STEPS} (traced): loss {losses[-1]:.4f}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training did not lower the loss: {losses}")
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        if counts[name] != STEPS * cfg.n_layers:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{STEPS} steps of {cfg.n_layers} layers")
    med = statistics.median(step_ms[1:])  # step 1 warms up
    flops = model_flops(cfg, B * S, B, S)
    stats = dict(losses=losses, median_step_ms=med,
                 first_step_ms=step_ms[0], tokens_per_s=B * S / med * 1e3,
                 model_flop_share=flops / (med / 1e3) / BF16_FLOPS,
                 model_tflop_per_step=flops / 1e12,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                 telemetry_p50_us={k: round(v["p50_us"], 1) for k, v in
                                   trainer.telemetry().items()},
                 **traced)
    if traced.get("device_busy_ms"):  # else: not measured (no CUDA events)
        stats["device_idle_share"] = 1 - traced["device_busy_ms"] / med
    del trainer, params
    torch.cuda.empty_cache()
    return stats, counts


def phase_train_parity(dev):
    """Phase 8: one float32 step at llama3-8b widths, 2 layers, through
    the kernels against the same step through the plain attention."""
    import torch

    from starway_tpu_torch.models import LlamaConfig, init_params
    from starway_tpu_torch.models.llama import value_and_grad
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.attention import blockwise_attention
    from starway_tpu_torch.utils.tree import tree_leaves

    cfg = LlamaConfig.preset("llama3-8b", n_layers=2, dtype="float32",
                             remat=True, remat_policy="dots")
    params = init_params(cfg, SEED + 5, device=dev)
    batch = train_batch(cfg, 1, 513, SEED + 6, dev)
    log("[train-parity] float32, 2 layers, [1, 513], remat dots: kernels "
        "against the plain attention")
    reset_launch_counts()
    loss, grads = value_and_grad(params, batch, cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        if counts[name] != cfg.n_layers:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"one step of {cfg.n_layers} layers")

    def plain_attn(q, k, v):
        return blockwise_attention(q, k, v, causal=True)

    want_loss, want = value_and_grad(params, batch, cfg, plain_attn)
    loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    worst = 0.0
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        worst = max(worst, ((g - w).abs().max() / w.abs().max()).item())
    log(f"  loss {loss.item():.6f} vs plain {want_loss.item():.6f} (rel "
        f"{loss_err:.2e}, tol 1e-5); worst gradient leaf error relative to "
        f"its max {worst:.3e} (tol {TRAIN_GRAD_REL_TOL}); launches "
        f"{counts}")
    if not (loss_err <= 1e-5 and worst <= TRAIN_GRAD_REL_TOL):
        raise AssertionError("the kernel train step disagrees with the "
                             "plain-attention step")
    del params, grads, want
    torch.cuda.empty_cache()
    return dict(loss_rel_err=loss_err, worst_grad_rel_err=worst)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    from starway_tpu_torch.models import LlamaConfig, generate, init_params
    from starway_tpu_torch.ops import (_build, launch_counts,
                                       reset_launch_counts)
    from starway_tpu_torch.ops.quantize import quantize_params

    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    # 1. build
    _build.build(force=True)
    log(f"[build] kernels built from {_build.CSRC} in "
        f"{_build.build_seconds:.2f} s")
    _build.library()

    # 2. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # 3. kernels against their plain versions
    log("[kernels]")
    rows = phase_kernels(dev)
    log(f"[kernels] done at {time.perf_counter() - t_start:.1f} s")

    # 4 + 5: the serving path, counted.
    cfg = LlamaConfig.preset("llama3-8b")  # bf16, 32 layers, full widths
    reqs = make_requests(cfg)
    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    log("[serve] llama3-8b bf16, 32 layers, n_slots=8 max_len=2048 chunk=8, "
        f"{len(reqs)} requests, prompts "
        f"{min(len(p) for p, _ in reqs)}-{max(len(p) for p, _ in reqs)}")
    reset_launch_counts()
    _done, st4 = serve(params, cfg, reqs)
    c4 = launch_counts()
    log(f"  {st4}")
    log(f"  launches {c4}")
    if not (c4["decode_attention"] > 0 and c4["flash_forward"] > 0):
        raise AssertionError("the bf16 serving run launched no decode or "
                             "flash kernel")
    check_first_logits(params, cfg, reqs[0][0], 2048)

    cfg8 = LlamaConfig.preset("llama3-8b", kv_quant="int8")
    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log("[int8] int8 KV cache + W8A16 weights, same requests")
    reset_launch_counts()
    _done, st5 = serve(qparams, cfg8, reqs)
    c5 = launch_counts()
    main_counts = {k: c4[k] + c5[k] for k in c4}
    log(f"  {st5}")
    log(f"  launches {c5}")
    if not all(c5[k] > 0 for k in ("decode_attention", "flash_forward",
                                    "int8_matmul")):
        raise AssertionError("the int8 serving run missed a kernel")
    check_first_logits(qparams, cfg8, reqs[0][0], 2048)
    del qparams
    torch.cuda.empty_cache()

    # 6. parity: float32, 2 layers, same widths.
    cfg32 = LlamaConfig.preset("llama3-8b", n_layers=2, dtype="float32")
    params32 = init_params(cfg32, SEED + 2, device=dev)
    log("[parity] float32, 2 layers: SlotServer vs generate(), greedy")
    done, st6 = serve(params32, cfg32, reqs)
    for rid, (prompt, m) in zip(done, reqs):
        want = generate(params32, cfg32, torch.tensor([prompt]), m,
                        max_len=2048)[0, len(prompt):].cpu().numpy()
        if not np.array_equal(done[rid], want):
            raise AssertionError(f"request {rid}: SlotServer {done[rid]} != "
                                 f"generate {want}")
    log(f"  {len(done)} requests token-for-token equal; {st6}")
    del params32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 7 + 8: the training path, counted, then its parity step.
    st7, c7 = phase_train(dev)
    log(f"  {st7}")
    log(f"  launches {c7}")
    st8 = phase_train_parity(dev)

    # 9. kernels line: launches are the serving path's (phases 4 and 5)
    # and the training path's (phase 7), each counted from 0 just before
    # its run and read just after.
    main_counts = {k: main_counts[k] + c7[k] for k in main_counts}
    kernels = []
    for key, row in rows.items():
        row = dict(row)
        row["launches"] = main_counts[key]
        kernels.append(row)
    steps, admits = 8 * st4["chunks"], len(reqs)  # per serving run
    log(f"[summary] launches per serving step: decode_attention "
        f"{c4['decode_attention'] / steps:g} per decode step, "
        f"flash_attention_fwd {c4['flash_forward'] / admits:g} per "
        f"admission, int8_matmul (W8A16 run) "
        f"{c5['int8_matmul'] / (8 * st5['chunks'] + admits):g} per decode "
        f"step or admission")
    log(f"[summary] launches per training step (4 layers): "
        f"flash_attention_fwd {c7['flash_forward'] / 6:g}, dK/dV "
        f"{c7['flash_backward_dkv'] / 6:g}, dQ {c7['flash_backward_dq'] / 6:g}")
    log(f"[summary] decode chunks {st4['chunks']} bf16 + {st5['chunks']} "
        f"int8 of 8 steps each, serve wall {st4['wall_s']:.2f} s bf16 / "
        f"{st5['wall_s']:.2f} s int8; train median step "
        f"{st7['median_step_ms']:.1f} ms, {st7['tokens_per_s']:.0f} tokens/s, "
        f"model FLOP share {st7['model_flop_share']:.4f}; train-parity "
        f"{st8}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)

    # 10. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
