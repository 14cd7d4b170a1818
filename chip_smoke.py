#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (starway_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. build   -- compile the CUDA kernels from starway_tpu_torch/csrc with nvcc
              (and the tensor-core kernels' sources once more with
              -Xptxas -v: their registers and spills, logged at the end)
2. card    -- print the card's name and power limit (nvidia-smi)
3. kernels -- each kernel against its plain PyTorch version at the serving
              and training paths' shapes (the decode kernel also at C=128,
              its ingest regime; the paged kernel at 16 slots and at the
              prefix-ingest shape): max error, median time (CUDA
              events), the plain version's time, one PyTorch library
              call's time, and the least time the card could take (bytes /
              3.35 TB/s or operations / 989 TFLOP/s, whichever is larger);
              the decode and paged kernels at the serving shapes
              (ops/decode_bench.py: C=1, 4 and 128, bf16 and int8 KV) as
              device ms a call in a CUDA graph and by CUDA events, SDPA
              both ways, with the host's enqueue us a call and the share
              of the bound;
              the flash forward at B=1 S=512 and 2048, B=2 S=2048 and
              B=1 S=4096 beside SDPA with its achieved TFLOP/s, and at
              each admission bucket of phase 4 (their sum over the 12
              admissions and 32 layers, a model);
              the ring-step kernels at train-ring's shapes and offsets
              and at zigzag's half shards, beside SDPA where the block
              is all visible or a diagonal;
              the flash backward's achieved TFLOP/s (on its 7 products
              and the function's 5) and its ratio to SDPA's backward;
              pass A's split over query heads against none at zigzag's
              and the ring's shard shapes; the int8 GEMV at every shape
              of the W8A16 serving path (decode M=8; the admission
              buckets and M=512, 2048), device ms a call with the weight
              cold beside torch.matmul on the dequantized weight (and
              by CUDA events around one call), the decode step's q, k, v
              projections as one chain, and the rows' sums over one
              decode step and phase 4's 12 admissions (a model: the
              decode step's is measured in phase 6)
4. serve   -- SlotServer on llama3-8b widths (bf16, 32 layers, random
              weights): 12 requests through 8 slots; the 12 admissions
              again (budgets of one token) under torch.profiler, for the
              flash forward's device ms over them; first-token logits of
              one request against a forward through the plain attention
5. paged   -- PagedSlotServer on the same weights: 16 slots, max_len
              4096, page 64, a 529-page pool, a 1000-token system prompt
              registered once and 24 requests (12 continue the prompt);
              the paged kernel launches 32 times per decode step and per
              prefixed admission; first-token logits of a prefixed request
              against a forward of prefix + suffix through the plain
              attention
6. int8    -- phase 4 again with an int8 KV cache and W8A16 weights; the
              GEMV launches in both regimes (decode and prefill), and its
              device ms in the traced chunk is logged.  Phases 4-6 log
              admission seconds (wall - the decode chunks) and the
              decode-attention kernels' device ms in the traced chunk
7. parity  -- float32, 2 layers at the same widths: SlotServer's greedy
              tokens equal generate()'s for every request
8. paged-parity -- the same weights: PagedSlotServer without and with a
              registered prefix, and SlotServer with it, give the greedy
              tokens of generate(prefix + suffix)
9. train   -- Trainer + adamw on llama3-8b widths cut to 4 layers (bf16,
              remat "dots"), 6 steps on one [2, 2049] batch: loss per
              step, median step ms, tokens/s, model FLOP share, one step
              traced for the device-busy share and the top kernels
10. train-parity -- float32, 2 layers, [1, 513]: loss and every gradient of
              one step through the kernels against the same step through
              the plain attention; the flash forward and each backward
              pass launch once per layer
11. train-ring -- the Trainer with sequence-parallel ring attention
              (make_sharded_attn on make_mesh({"sp": 4}): four shards of
              1024 tokens in this process) at llama3-8b widths cut to 4
              layers, bf16, remat "dots", one [1, 4097] batch: 6 steps
              with the ring layout, 6 with zigzag, then 6 with the flash
              attention as the yardstick; losses, step ms, tokens/s, model
              FLOP share, idle share of a traced step, peak memory, the
              ring/flash and zigzag/flash step ratios and each ring-step
              kernel's device ms in the traced step; the ring-step kernels
              launch exactly n^2 (zigzag 2 n^2 + n) times a layer, forward
              and backward
12. train-ring-parity -- float32, 2 layers, [1, 513], sp = 4: ring and
              zigzag through the kernels against the plain attention
13. transport -- Server/Client asend/arecv on CUDA tensors: the 1 MiB
              headline pingpong (starway_tpu_torch/headline.py, host <->
              cuda:0); on each transport (inproc, tcp, sm, native,
              native-sm) a cuda:0 <-> cuda:0 and a host <-> cuda:0
              pingpong at 4 KiB to 64 MiB against the raw copy (and a
              host <-> host one, the engine alone, as a yardstick), the
              chunks staged and placed per send, stream order on both
              sides, overwrite after send, a bf16 payload; a 256 MiB
              one-way send in process and over tcp; a pingpong with the
              server in a spawned child on each engine.  Every received
              tensor must equal what was sent, in the same memory, and no
              fallback may be logged
14. a JSON line of the kernels with their launches on the serving paths
   (phases 4, 5 and 6) and the training paths (phases 9 and 11) and the
   numbers of phase 3
15. the last line: {"ok": true, "device": {...}}

Exits non-zero, printing no result, without a CUDA device.  Imports
nothing of JAX.
"""

from __future__ import annotations

import gc
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
# The design of the kernels that dispatch by dtype, for the kernels line
# (csrc/flash_bwd.cu, csrc/decode_attention.cu, csrc/paged_attention.cu).
MMA_ROUTE = "cuda (mma.sync bf16; FMA float32)"
# A float32 train step through 2 layers at full width, kernels against the
# plain attention: the attention gradients differ in summation order, and
# the 4096- and 14336-wide float32 matmuls carry that into every leaf.
TRAIN_GRAD_REL_TOL = 1e-3
LR_TRAIN = 2e-4  # AdamW on bf16 weights of ~0.016: steps above half an ulp
SEED = 0


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events:
    utils/cuda_timing.py event_ms)."""
    from starway_tpu_torch.utils.cuda_timing import event_ms

    return event_ms(fn, iters, warmup)


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev):
    """Phase 3: every kernel against its plain version; returns the rows of
    the kernels line (launch counts filled in later)."""
    import torch

    from starway_tpu_torch.ops.decode import (decode_attention,
                                              decode_attention_reference)
    from starway_tpu_torch.ops.quantize import quantize_kv

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
                if n_q == 1 and window is None and not quant:
                    plain = cuda_ms(lambda: decode_attention_reference(
                        q, kc, vc, pos, **kw), iters=5)
    del k16, v16, k8, v8, ks, vs
    worst = max(worst, row_tiled_decode(dev, randn))
    paged_err, paged_plain = paged_rows(dev, randn, rng)
    timed = decode_timings(dev)
    rows["decode_attention"] = dict(
        name="decode_attention", route=MMA_ROUTE,
        source="starway_tpu_torch/csrc/decode_attention.cu",
        replaces="starway_tpu/ops/pallas_decode.py:150 "
                 "(_decode_stream_kernel; also :107 _decode_kernel)",
        max_abs_err=worst, plain_ms=plain, **timed["decode_attention"])
    rows["paged_decode_attention"] = dict(
        name="paged_decode_attention", route=MMA_ROUTE,
        source="starway_tpu_torch/csrc/paged_attention.cu",
        replaces="starway_tpu/ops/pallas_paged.py:46 (_paged_stream_kernel)",
        max_abs_err=paged_err, plain_ms=paged_plain,
        **timed["paged_decode_attention"])

    rows["flash_forward"] = flash_forward_rows(dev, randn)

    rows.update(flash_backward_rows(dev, randn))
    rows.update(ring_kernel_rows(dev, randn))
    rows["flash_partial_bwd"]["split_effect"] = split_effect(dev)

    rows["int8_matmul"] = gemv_rows(dev, randn)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def flash_forward_rows(dev, randn) -> dict:
    """#3, the flash forward, bf16, causal, GQA 4:1 (llama3-8b heads),
    against its plain version (o to BF16_TOL, lse to 1e-3) and timed
    beside SDPA on the same inputs, with its achieved TFLOP/s on the
    function's 4 * Hq * D flops per visible pair, by CUDA events around
    one call (the method of earlier runs: the wrapper's host enqueue
    included) and as device ms a call (utils/cuda_timing.py graph_us: 20
    calls in one CUDA graph), each beside SDPA timed the same way: at B=1,
    S=512 and 2048
    (admission prefills; drawn from phase 3's shared generator, as
    before), B=2, S=2048 (train-bf16's batch) and B=1, S=4096 (train-ring's
    flash run); then at B=1 and every admission bucket of phase 4's 12
    requests, whose times summed over the requests and 32 layers are
    logged as a model of the forward's share of the 12 admissions (a sum
    of these timings, not a measurement on the path: phase 4 measures
    that, :func:`traced_admissions`).  The kernels line's row is timed at
    B=1, S=2048, as in earlier runs; ``by_shape`` has every shape and
    ``admission_buckets`` the buckets' times."""
    import torch
    import torch.nn.functional as F

    from starway_tpu_torch.ops.flash import (_n_sms, flash_forward,
                                             flash_forward_reference,
                                             fwd_q_rows)
    from starway_tpu_torch.utils.cuda_timing import graph_us, visible_pairs

    HQ, HKV, D = 32, 8, 128
    n_sms = _n_sms(dev.index or 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def own_randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def one(b, s, draw, plain: bool):
        q, k, v = draw(b, HQ, s, D), draw(b, HKV, s, D), draw(b, HKV, s, D)
        o, lse = flash_forward(q, k, v, causal=True)
        o_ref, lse_ref = flash_forward_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        if not (err <= BF16_TOL and lse_err <= 1e-3):
            raise AssertionError(f"flash_forward disagrees with its plain "
                                 f"version at B={b} S={s}: o {err:.3e}, lse "
                                 f"{lse_err:.3e}")
        def ours(_=None):
            return flash_forward(q, k, v, causal=True)

        def library(_=None):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

        ms, lib = cuda_ms(ours), cuda_ms(library)
        graph_ms = graph_us(ours, [None]) / 1e3
        lib_graph = graph_us(library, [None]) / 1e3
        pairs = b * visible_pairs(s, s)
        n_flops = 4 * HQ * D * pairs
        n_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * HQ * s
        b_ms, b_by = bound(n_bytes, n_flops)
        row = dict(b=b, s=s, q_rows=fwd_q_rows(b, HQ, s, s, True,
                                                n_sms=n_sms),
                   ms=ms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                   tflops=n_flops / ms / 1e9, vs_library=ms / lib,
                   graph_ms=graph_ms, library_graph_ms=lib_graph,
                   graph_tflops=n_flops / graph_ms / 1e9,
                   max_abs_err=err, lse_err=lse_err)
        if plain:
            row["plain_ms"] = cuda_ms(
                lambda: flash_forward_reference(q, k, v, causal=True),
                iters=5)
        log(f"flash_forward B={b} S={s} ({row['q_rows']}-row q tiles): "
            f"max_abs_err {err:.3e} (tol "
            f"{BF16_TOL}), lse {lse_err:.3e} (tol 1e-3); {ms:.4f} ms "
            f"({row['tflops']:.1f} TFLOP/s, {b_ms / ms:.3f} of the bound "
            f"{b_ms:.4f} ms, {b_by}), library (SDPA causal, GQA) {lib:.4f} "
            f"ms ({ms / lib:.2f}x), plain {row.get('plain_ms')} ms; device "
            f"ms a call in a CUDA graph {graph_ms:.4f} "
            f"({row['graph_tflops']:.1f} TFLOP/s), SDPA {lib_graph:.4f} "
            f"({graph_ms / lib_graph:.2f}x)")
        del q, k, v, o, lse, o_ref, lse_ref
        return row

    by_shape = [one(1, s, randn, True) for s in (512, 2048)]
    by_shape += [one(b, s, own_randn, True) for b, s in ((2, 2048),
                                                         (1, 4096))]
    torch.cuda.empty_cache()
    buckets = admission_buckets()
    per_bucket = {s: one(1, s, own_randn, False) for s in sorted(set(buckets))}
    admit = {key: N_LAYERS * sum(per_bucket[s][key] for s in buckets)
             for key in ("ms", "library_ms", "bound_ms")}
    log(f"[flash] the forward's share of phase 4's 12 admissions, modelled "
        f"(a sum of the per-bucket times above over the requests' buckets "
        f"{buckets} and {N_LAYERS} layers, not measured on the path): "
        f"{admit['ms']:.4f} ms, SDPA {admit['library_ms']:.4f} ms, bound "
        f"{admit['bound_ms']:.4f} ms")
    timed = by_shape[1]
    return dict(
        name="flash_attention_fwd", route="cuda",
        source="starway_tpu_torch/csrc/flash_fwd.cu",
        replaces="starway_tpu/ops/pallas_attention.py:124 (_fwd_kernel)",
        max_abs_err=max(r["max_abs_err"] for r in by_shape
                        + list(per_bucket.values())),
        **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "graph_ms",
                                  "library_graph_ms")},
        timed_at=f"B=1 Hq={HQ} Hkv={HKV} D={D} S=2048 causal bf16 "
                 f"(flash_fwd_mma_kernel), by events around one call; "
                 f"graph_ms is device ms a call in a CUDA graph; by_shape "
                 f"has every shape",
        by_shape=by_shape,
        admission_buckets={s: {k: r[k] for k in ("ms", "library_ms")}
                           for s, r in per_bucket.items()})


# The W8A16 serving path's projections: (name, D, F, launches a layer);
# the lm_head runs once a step, and at admission on the last row only.
GEMV_LAYER = (("wq/wo", 4096, 4096, 2), ("wk/wv", 4096, 1024, 2),
              ("gate/up", 4096, 14336, 2), ("down", 14336, 4096, 1))
GEMV_HEAD = ("lm_head", 4096, 128256)
N_LAYERS = 32


def admission_buckets(max_len: int = 2048) -> list:
    """The prefill M of each of phase 4's requests (its bucket)."""
    from starway_tpu_torch.models import LlamaConfig
    from starway_tpu_torch.models.serving import _bucket, default_buckets

    reqs = make_requests(LlamaConfig.preset("llama3-8b"))
    return [_bucket(len(p), default_buckets(max_len)) for p, _m, _w in reqs]


def gemv_rows(dev, randn) -> dict:
    """Phase 3's int8 GEMV: every shape of the W8A16 serving path at
    decode M=8, the layer shapes at every admission bucket of phase 4's
    requests and at M=512 and 2048, the lm_head at M=1 (admission's last
    row) and M=512; each held against its plain version (ops/gemv.py
    tolerance_share: max(2e-2, 2 bf16 ulps of |want|) per element) and
    timed as device ms a call (utils/cuda_timing.py graph_us: 20 calls in
    one CUDA graph, each on its own copy of the weight, cold as in a
    decode step) beside torch.matmul on the dequantized bf16 weight timed
    the same way, the plain version (CUDA events) and the bound; the
    host's enqueue us of a call beside torch.matmul's.  Logs the sums of
    these per-shape times over one decode step and over the 12
    admissions (a model of the path's GEMV time, not a measurement of
    it).  Returns the kernels line's row, timed at M=8, D=4096, F=14336
    as in earlier runs, with every row.  Every call passes
    static_weight=True, as the model's matmul_w does."""
    import torch

    from starway_tpu_torch.ops.gemv import (BF16_ATOL, BF16_ULPS, _n_sms,
                                            early_launch, gemv_plan,
                                            int8_matmul,
                                            int8_matmul_reference,
                                            tolerance_share)
    from starway_tpu_torch.ops.quantize import quantize_weight
    from starway_tpu_torch.utils.cuda_timing import cold_copies, graph_us

    buckets = admission_buckets()
    n_sms = _n_sms(dev.index or 0)
    table, worst, worst_excess = {}, 0.0, 0.0
    for name, d, f in [g[:3] for g in GEMV_LAYER] + [GEMV_HEAD]:
        w = quantize_weight(randn(d, f, dtype=torch.float32) * d ** -0.5)
        wq, sc = w["q"], w["s"]
        del w
        w_deq = (wq.float() * sc).to(torch.bfloat16)
        wqs, w_deqs = cold_copies(wq), cold_copies(w_deq)
        ms_list = ((1, 8, 512) if name == "lm_head"
                   else sorted({8, 512, 2048, *buckets}))
        for m in ms_list:
            x = randn(m, d)
            got = int8_matmul(x, wq, sc, static_weight=True)
            want = int8_matmul_reference(x, wq, sc)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            excess = tolerance_share(got, want)
            worst, worst_excess = max(worst, err), max(worst_excess, excess)
            ms = graph_us(lambda c: int8_matmul(x, c, sc, static_weight=True),
                          wqs) / 1e3
            lib = graph_us(lambda c: torch.matmul(x, c), w_deqs) / 1e3
            # The first version's method beside it: CUDA events around
            # one call, the weight hot in L2 where it fits.
            ev = cuda_ms(lambda: int8_matmul(x, wq, sc, static_weight=True))
            lib_ev = cuda_ms(lambda: torch.matmul(x, w_deq))
            plain = cuda_ms(lambda: int8_matmul_reference(x, wq, sc),
                            iters=3, warmup=1)
            host_us = back_to_back(
                lambda: int8_matmul(x, wq, sc, static_weight=True), 50)[1]
            lib_host_us = back_to_back(lambda: torch.matmul(x, w_deq), 50)[1]
            n_bytes = d * f + 4 * f + 2 * m * d + 2 * m * f
            flops = 2 * m * d * f
            b_ms, b_by = bound(n_bytes, flops)
            regime, splits = gemv_plan(m, d, f, n_sms)
            early = early_launch(regime, m, f, splits, n_sms)
            rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if b_by == "operations"
                    else f"{n_bytes / ms / 1e6:.1f} GB/s")
            how = f"{regime}, {splits} splits" + (", early launch" if early
                                                  else "")
            log(f"int8_matmul {name} M={m} D={d} F={f} ({how}): max_abs_err "
                f"{err:.3e}, {excess:.3f} of the tolerance (max({BF16_ATOL}, "
                f"{BF16_ULPS} bf16 ulps of |want|)); {ms:.4f} ms ({rate}, "
                f"{b_ms / ms:.3f} of the bound {b_ms:.4f} ms, {b_by}), "
                f"torch.matmul {lib:.4f} ms ({ms / lib:.2f}x), plain "
                f"{plain:.4f} ms; by events around one call {ev:.4f} ms, "
                f"torch.matmul {lib_ev:.4f}; host enqueue {host_us:.1f} us a "
                f"call (torch.matmul {lib_host_us:.1f})")
            if not excess <= 1:
                raise AssertionError(f"int8_matmul disagrees with its plain "
                                     f"version at M={m} D={d} F={f}")
            table[(m, d, f)] = dict(
                shape=name, m=m, d=d, f=f, regime=regime, splits=splits,
                early_launch=early,
                ms=ms, library_ms=lib, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, bound_share=b_ms / ms, max_abs_err=err,
                tol_share=excess, host_us=host_us, library_host_us=lib_host_us,
                events_ms=ev, library_events_ms=lib_ev)
            del x, got, want
        del wq, sc, w_deq, wqs, w_deqs
        torch.cuda.empty_cache()

    def step_ms(m, key):
        return N_LAYERS * sum(k * table[(m, d, f)][key]
                              for _n, d, f, k in GEMV_LAYER)

    head = (GEMV_HEAD[1], GEMV_HEAD[2])
    decode = {key: step_ms(8, key) + table[(8, *head)][key]
              for key in ("ms", "library_ms", "bound_ms")}
    admit = {key: sum(step_ms(b, key) + table[(1, *head)][key]
                      for b in buckets)
             for key in ("ms", "library_ms", "bound_ms")}
    log(f"[gemv] sums of the per-shape times above, modelled, not "
        f"measured on the path: one decode step (M=8: 32 x (2 wq/wo + 2 "
        f"wk/wv + 2 gate/up + down) + lm_head, 225 launches) "
        f"{decode['ms']:.4f} ms against its bound {decode['bound_ms']:.4f} "
        f"ms (torch.matmul {decode['library_ms']:.4f}); the 12 admissions "
        f"(M = buckets {buckets}, 224 launches each + the lm_head at M=1) "
        f"{admit['ms']:.4f} ms (bound {admit['bound_ms']:.4f}, torch.matmul "
        f"{admit['library_ms']:.4f})")
    for m in (512, 2048):
        worst_x = max(r["ms"] / r["library_ms"] for r in table.values()
                      if r["m"] == m)
        log(f"[gemv] M={m}: slowest row {worst_x:.2f}x torch.matmul")
    worst_x = max(r["ms"] / r["library_ms"] for r in table.values()
                  if r["m"] == 8)
    log(f"[gemv] M=8: slowest row {worst_x:.2f}x torch.matmul")
    chain = gemv_chain(randn)
    log(f"[gemv] the decode step's q, k, v projections back to back (M=8, "
        f"weights cold): {chain['ms']:.4f} ms, torch.matmul "
        f"{chain['library_ms']:.4f} ms "
        f"({chain['ms'] / chain['library_ms']:.2f}x)")
    timed = table[(8, 4096, 14336)]
    return dict(
        name="int8_matmul", route="cuda",
        source="starway_tpu_torch/csrc/int8_gemv.cu",
        replaces="starway_tpu/ops/pallas_gemv.py:32 (_gemv_kernel)",
        max_abs_err=worst, tol_share=worst_excess,
        **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        timed_at="M=8 D=4096 F=14336 bf16 (decode regime), device ms a "
                 "call, weight cold",
        rows=[dict(r) for r in table.values()], qkv_chain=chain)


def gemv_chain(randn) -> dict:
    """Device ms of the decode step's q, k and v projections (M=8: wq
    4096 x 4096, then wk and wv 4096 x 1024, one x) as one chain, 20
    chains in a CUDA graph on cold weight copies: the int8 GEMV, whose
    early launch lets each call start behind the one before, against
    torch.matmul on the dequantized weights the same way."""
    import torch

    from starway_tpu_torch.ops.gemv import int8_matmul
    from starway_tpu_torch.ops.quantize import quantize_weight
    from starway_tpu_torch.utils.cuda_timing import graph_us

    x = randn(8, 4096)
    ws = {}
    for name, f in (("q", 4096), ("kv", 1024)):
        w = quantize_weight(randn(4096, f, dtype=torch.float32) * 4096 ** -0.5)
        ws[name] = (w["q"], w["s"],
                    (w["q"].float() * w["s"]).to(torch.bfloat16))
    n = 8  # chains of copies: 8 x (16 + 8) MB int8 read between reuses
    q = [ws["q"][0].clone() for _ in range(n)]
    kv = [ws["kv"][0].clone() for _ in range(2 * n)]
    q_deq = [ws["q"][2].clone() for _ in range(n)]
    kv_deq = [ws["kv"][2].clone() for _ in range(2 * n)]
    sq, skv = ws["q"][1], ws["kv"][1]

    def ours(i):
        int8_matmul(x, q[i], sq, static_weight=True)
        int8_matmul(x, kv[2 * i], skv, static_weight=True)
        int8_matmul(x, kv[2 * i + 1], skv, static_weight=True)

    def library(i):
        torch.matmul(x, q_deq[i])
        torch.matmul(x, kv_deq[2 * i])
        torch.matmul(x, kv_deq[2 * i + 1])

    return dict(ms=graph_us(ours, list(range(n))) / 1e3,
                library_ms=graph_us(library, list(range(n))) / 1e3)


def decode_timings(dev) -> dict:
    """#1 and #9 timed at the serving paths' shapes (ops/decode_bench.py
    kernel_rows: dense B=8 T=2048 at C=1 with bf16 and int8 KV and at C=4,
    ragged positions; C=128 at pos 1000; paged 16 slots at C=1 and one
    slot at C=128, page 64): device ms a call in a CUDA graph with the
    caches cold and by CUDA events around one call, SDPA both ways, the
    host's enqueue us a call, and the share of the bound.  Each shape is
    held against its plain version first.  Returns each kernel's fields
    of the kernels line: its first shape's numbers and every shape."""
    from starway_tpu_torch.ops.decode_bench import kernel_rows

    out = {}
    for r in kernel_rows(SEED):
        log(f"{r['kernel']} {r['shape']}: max_abs_err {r['max_abs_err']:.3e} "
            f"(tol {BF16_TOL}); device {r['ms']:.4f} ms ({r['bound_share']:.3f}"
            f" of the bound {r['bound_ms']:.4f} ms, {r['bound_by']}), SDPA "
            f"{r['library_ms']:.4f} ({r['library_ratio']:.2f}x); by events "
            f"{r['events_ms']:.4f} ms, SDPA {r['library_events_ms']:.4f}; host "
            f"enqueue {r['host_us']:.1f} us a call (SDPA "
            f"{r['library_host_us']:.1f})")
        out.setdefault(r["kernel"], []).append(r)
    rows = {}
    for name, shapes in out.items():
        first = shapes[0]
        rows[name] = dict(
            {k: first[k] for k in ("ms", "bound_ms", "bound_by",
                                   "bound_share", "library_ms", "events_ms",
                                   "library_events_ms", "host_us")},
            timed_at=f"{first['shape']}, Hq=32 Hkv=8 D=128 bf16 q; device "
                     f"ms a call in a CUDA graph, caches cold; library_ms "
                     f"is SDPA with the rows' mask timed the same way"
                     + (" over the pre-gathered dense view" if
                        name.startswith("paged") else ""),
            shapes=shapes)
    return rows


def row_tiled_decode(dev, randn) -> float:
    """The decode kernel at C=128 (a suffix ingest: 512 query rows per kv
    head, the ingest regime's eight row tiles), dense and int8, against
    its plain version.  Returns the worst error."""
    import torch

    from starway_tpu_torch.ops.decode import (decode_attention,
                                              decode_attention_reference)
    from starway_tpu_torch.ops.quantize import quantize_kv

    B, HQ, HKV, D, T, C, POS = 1, 32, 8, 128, 4096, 128, 1000
    q = randn(B, HQ, C, D)
    k16, v16 = randn(B, HKV, T, D), randn(B, HKV, T, D)
    pos = torch.full((B,), POS, dtype=torch.int32, device=dev)
    worst = 0.0
    for quant in (False, True):
        kw = {}
        kc, vc = k16, v16
        if quant:
            kc, kw["k_scale"] = quantize_kv(k16)
            vc, kw["v_scale"] = quantize_kv(v16)
        got = decode_attention(q, kc, vc, pos, **kw)
        want = decode_attention_reference(q, kc, vc, pos, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        log(f"decode_attention C={C} (row tiles) int8={quant}: max_abs_err "
            f"{err:.3e} (tol {BF16_TOL})")
        if not err <= BF16_TOL:
            raise AssertionError("the row-tiled decode kernel disagrees "
                                 "with its plain version")
    return worst


def paged_rows(dev, randn, rng):
    """The paged kernel against its plain version at the serving shape (16
    slots, page 64, ragged cursors over a scrambled table whose entries
    past each cursor point far outside the pool) at C=1, and at the
    prefix-ingest shape (one slot at position 1000, C=128).  Returns the
    worst error and the plain version's ms at C=1 (CUDA events)."""
    import torch

    from starway_tpu_torch.ops.paged import (paged_decode_attention,
                                             paged_decode_attention_reference)

    HQ, HKV, D, PAGE, MAX_LEN = 32, 8, 128, 64, 4096
    max_pages = MAX_LEN // PAGE
    worst, plain = 0.0, None
    for b, n_q in ((16, 1), (1, 128)):
        pos_np = (rng.integers(100, 2001, b) if n_q == 1
                  else np.full(b, 1000)).astype(np.int32)
        n_pages = 1 + b * max_pages
        table = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
        table = table.reshape(b, max_pages)
        last = (pos_np + n_q - 1) // PAGE
        for i in range(b):
            table[i, last[i] + 1:] = 2 ** 30 + i  # never read
        kp, vp = randn(n_pages, HKV, PAGE, D), randn(n_pages, HKV, PAGE, D)
        q = randn(b, HQ, n_q, D)
        table_d = torch.from_numpy(table).to(dev)
        pos = torch.from_numpy(pos_np).to(dev)
        got = paged_decode_attention(q, kp, vp, table_d, pos)
        want = paged_decode_attention_reference(q, kp, vp, table_d, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        log(f"paged_decode_attention B={b} C={n_q} page={PAGE} pos "
            f"{pos_np.min()}-{pos_np.max()}: max_abs_err {err:.3e} (tol "
            f"{BF16_TOL})")
        if not err <= BF16_TOL:
            raise AssertionError("paged_decode_attention disagrees with its "
                                 "plain version")
        if n_q == 1:
            plain = cuda_ms(lambda: paged_decode_attention_reference(
                q, kp, vp, table_d, pos), iters=5)
        del kp, vp
        torch.cuda.empty_cache()
    return worst, plain


def flash_backward_rows(dev, randn):
    """The two backward kernels against flash_backward_reference: the
    training shapes (B=2, S=2048 and B=1, S=4096, causal, GQA 4:1, bf16)
    and small float32 / bfloat16 shapes (non-causal, window, uneven S,
    other head sizes).  Timed at B=2, S=2048 (the kernels line) and at
    B=1, S=4096 (``at_b1_s4096``), each with its achieved TFLOP/s and its
    ratio to SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from starway_tpu_torch.ops.flash import (flash_backward,
                                             flash_backward_dkv,
                                             flash_backward_dq,
                                             flash_backward_reference,
                                             flash_forward)
    from starway_tpu_torch.utils.cuda_timing import visible_pairs

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
        # Each pass is bound by its own outputs: dK/dV needs s, dp, dv and
        # dk (4 products), dQ needs s, dp and dq (3).  The backward as one
        # function needs 5, so the two bounds sum past the pair's own.
        flops = 2 * d * visible_pairs(s_len, s_len, causal=causal,
                                      window=window) * hq * b
        es = q.element_size()
        io = es * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * b * hq * s_len
        dkv_b = bound(io + es * 2 * k.numel(), 4 * flops)
        dq_b = bound(io + es * q.numel(), 3 * flops)
        pair_b = bound(io + es * (q.numel() + 2 * k.numel()), 5 * flops)
        rates = bwd_rates(dkv_ms + dq_ms, flops, lib)
        log(f"  timed: dK/dV {dkv_ms:.4f} ms (bound {dkv_b[0]:.4f} ms, "
            f"{dkv_b[1]}, {4 * flops / dkv_ms / 1e9:.1f} TFLOP/s), dQ "
            f"{dq_ms:.4f} ms (bound {dq_b[0]:.4f} ms, {dq_b[1]}, "
            f"{3 * flops / dq_ms / 1e9:.1f} TFLOP/s); both passes "
            f"{dkv_ms + dq_ms:.4f} ms, {rates['tflops_7']:.1f} TFLOP/s on "
            f"the kernels' 7 products, {rates['tflops_5']:.1f} on the "
            f"function's 5, {rates['vs_library']:.2f}x the library's time; "
            f"as one function: bound {pair_b[0]:.4f} ms ({pair_b[1]}), "
            f"plain {plain:.4f} ms, library (SDPA backward) {lib:.4f} ms")
        at = (f"B={b} Hq={hq} Hkv={hkv} D={d} S={s_len} causal bf16; "
              f"plain_ms and library_ms cover both passes")
        row = dict(timed_at=at, both_passes_ms=dkv_ms + dq_ms,
                   both_passes_bound_ms=pair_b[0], plain_ms=plain,
                   library_ms=lib, **rates)
        if (b, s_len) == (2, 2048):
            timed["dkv"] = dict(row, ms=dkv_ms, bound_ms=dkv_b[0],
                                bound_by=dkv_b[1])
            timed["dq"] = dict(row, ms=dq_ms, bound_ms=dq_b[0],
                               bound_by=dq_b[1])
        else:
            timed["long"] = dict(row, dkv_ms=dkv_ms, dq_ms=dq_ms)
        del q, k, v, do, o, lse, got, want, delta
        torch.cuda.empty_cache()
    src = "starway_tpu_torch/csrc/flash_bwd.cu"
    return {
        "flash_backward_dkv": dict(
            name="flash_attention_bwd_dkv", route=MMA_ROUTE, source=src,
            replaces="starway_tpu/ops/pallas_attention.py:309 "
                     "(_bwd_dkv_kernel)",
            max_abs_err=worst["dkv"], **timed["dkv"],
            at_b1_s4096=timed["long"]),
        "flash_backward_dq": dict(
            name="flash_attention_bwd_dq", route=MMA_ROUTE, source=src,
            replaces="starway_tpu/ops/pallas_attention.py:364 "
                     "(_bwd_dq_kernel)",
            max_abs_err=worst["dq"], **timed["dq"])}


def bwd_rates(ms: float, flops: float, library_ms: float) -> dict:
    """Achieved rates of both backward passes from ``flops`` = 2 * D per
    visible pair and q head (one product): on the kernels' own 7 products
    (both passes recompute s and dp) and on the function's 5, and the
    time against the library call's on the same inputs."""
    return dict(tflops_7=7 * flops / ms / 1e9, tflops_5=5 * flops / ms / 1e9,
                vs_library=ms / library_ms)


def ring_kernel_rows(dev, randn):
    """The ring-step kernels (#7 flash_partial, #8 flash_partial_bwd)
    against their plain versions at train-ring's shard shape (q [1, 32,
    1024, 128] bf16, k/v [1, 8, 1024, 128]) and offsets: a whole past
    block, the diagonal, a dead block, a band edge (window 700) and a
    block whose first 512 rows see no key; then at zigzag's half shards
    (T = 512): a hi-lo pair with no mask (q at 2048, kv at 0) and a
    diagonal half (512 / 512).  Rows that see nothing must be exactly the
    identity (o = 0, m = NEG_BIG, l = 0) and their gradients exactly 0.
    The backward runs from the step's own lse and delta.  Timed at every
    offset (the forward by events around one call and as device ms a call
    in a CUDA graph), beside SDPA's forward timed the same ways where the
    block is all visible (no mask) or a diagonal (causal); the kernels
    line carries the past block's numbers, the library calls are SDPA's
    forward and backward over the same block (which return o and lse, not
    (o, m, l))."""
    import torch
    import torch.nn.functional as F

    from starway_tpu_torch.ops.attention import NEG_BIG
    from starway_tpu_torch.ops.flash import (_n_sms, flash_partial,
                                             flash_partial_bwd,
                                             flash_partial_bwd_reference,
                                             flash_partial_reference,
                                             fwd_q_rows)
    from starway_tpu_torch.utils.cuda_timing import graph_us, visible_pairs

    HQ, HKV, T, D = 32, 8, 1024, 128
    full = (randn(1, HQ, T, D), randn(1, HQ, T, D), randn(1, HKV, T, D),
            randn(1, HKV, T, D))
    # (name, T, q_offset, kv_offset, window, causal)
    cases = (("past", T, 1024, 0, None, True),
             ("diagonal", T, 1024, 1024, None, True),
             ("dead", T, 0, 1024, None, True),
             ("band edge", T, 1024, 0, 700, True),
             ("first rows dead", T, 0, 512, None, True),
             ("zigzag hi-lo", 512, 2048, 0, None, False),
             ("zigzag diagonal", 512, 512, 512, None, True))
    worst = {"fwd": 0.0, "bwd": 0.0}
    by_case = {}
    for name, t, q_off, kv_off, window, causal in cases:
        q, do, k, v = (x[:, :, :t].contiguous() for x in full)
        kw = dict(causal=causal, window=window)
        o, m, l = flash_partial(q, k, v, q_off, kv_off, **kw)
        o_r, m_r, l_r = flash_partial_reference(q, k, v, q_off, kv_off, **kw)
        torch.cuda.synchronize()
        dead = l_r == 0
        exact = bool((o[dead] == 0).all() and (l[dead] == 0).all()
                     and (m[dead] == NEG_BIG).all())
        live = ~dead
        o_rel = o_err = 0.0
        if live.any():
            # o / l is a softmax average of ~N(0, 1) values: ~0.05 on rows
            # that see the whole block, O(1) on rows that see a few keys.
            # Held against its largest value, so a dropped or misplaced
            # tile shows on the whole-block rows too.
            o_n = (o / l.clamp(min=1e-30)[..., None])[live]
            o_rn = (o_r / l_r.clamp(min=1e-30)[..., None])[live]
            o_err = (o_n - o_rn).abs().max().item()
            o_rel = o_err / o_rn.abs().max().item()
            m_err = (m[live] - m_r[live]).abs().max().item()
            l_rel = ((l[live] - l_r[live]) / l_r[live]).abs().max().item()
        else:
            m_err = l_rel = 0.0
        worst["fwd"] = max(worst["fwd"], o_err, m_err)
        lse = torch.where(live, m + torch.log(l.clamp(min=1e-30)),
                          torch.zeros_like(m))
        delta = (do.float() * o / l.clamp(min=1e-30)[..., None]).sum(-1)
        g = flash_partial_bwd(q, do, k, v, lse, delta, q_off, kv_off, **kw)
        g_r = flash_partial_bwd_reference(q, do, k, v, lse, delta, q_off,
                                          kv_off, **kw)
        torch.cuda.synchronize()
        rel = []
        for a, b in zip(g, g_r):
            scale = b.abs().max().item()
            if scale == 0:
                exact = exact and bool((a == 0).all())
                rel.append(0.0)
            else:
                rel.append((a - b).abs().max().item() / scale)
        worst["bwd"] = max(worst["bwd"], max(rel))
        def ours(_=None):
            return flash_partial(q, k, v, q_off, kv_off, **kw)

        fwd_ms = cuda_ms(ours)
        fwd_graph = graph_us(ours, [None]) / 1e3
        bwd_ms = cuda_ms(lambda: flash_partial_bwd(q, do, k, v, lse, delta,
                                                   q_off, kv_off, **kw))
        pairs = visible_pairs(t, t, q_off, kv_off, causal, window)
        # Forward: 2 products of 2 * D flops per visible pair and q head;
        # q, k, v read, o, m, l (float32) written.  Backward: the function
        # (dq, dk, dv) needs 5 products (s, dp, dv, dk, dq); q, dO, k, v,
        # lse, delta read once, the float32 gradients written once.  The
        # kernel's two passes recompute s and dp (7 products): that is its
        # design, not the function's need.
        fwd_b = bound(2 * (q.numel() + 2 * k.numel()) + 4 * (q.numel()
                                                             + 2 * HQ * t),
                      4 * D * pairs * HQ)
        bwd_b = bound(2 * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * HQ * t
                      + 4 * (q.numel() + 2 * k.numel()), 10 * D * pairs * HQ)
        by_case[name] = dict(
            t=t, q_offset=q_off, kv_offset=kv_off, window=window,
            causal=causal,
            q_rows=fwd_q_rows(1, HQ, t, t, causal, window, q_off, kv_off,
                              _n_sms(dev.index or 0)),
            visible_pairs=pairs, ms=fwd_ms, graph_ms=fwd_graph,
            bwd_ms=bwd_ms,
            bound_ms=fwd_b[0], bwd_bound_ms=bwd_b[0],
            bwd_tflops_7=14 * D * pairs * HQ / bwd_ms / 1e9,
            bwd_tflops_5=10 * D * pairs * HQ / bwd_ms / 1e9,
            identity_exact=exact)
        tol = GRAD_REL_TOL["bfloat16"]
        log(f"flash_partial {name} (T {t}, q_off {q_off}, kv_off {kv_off}, "
            f"window {window}, causal {causal}): o/l max_abs_err "
            f"{o_err:.3e}, relative to max |o/l| "
            f"{o_rel:.3e} (tol {tol}), m {m_err:.3e} (tol 1e-3), l rel "
            f"{l_rel:.3e} (tol 1e-3); identity rows exact {exact}; "
            f"{fwd_ms:.4f} ms, device {fwd_graph:.4f} ms a call in a CUDA "
            f"graph ({by_case[name]['q_rows']}-row q tiles, bound "
            f"{fwd_b[0]:.4f} ms, {fwd_b[1]}); "
            f"flash_partial_bwd rel err dq/dk/dv {rel[0]:.3e}/{rel[1]:.3e}/"
            f"{rel[2]:.3e} (tol {tol}), {bwd_ms:.4f} ms (bound "
            f"{bwd_b[0]:.4f} ms, {bwd_b[1]}; "
            f"{by_case[name]['bwd_tflops_7']:.1f} TFLOP/s on the kernels' 7 "
            f"products, {by_case[name]['bwd_tflops_5']:.1f} on the "
            f"function's 5)")
        if not (o_rel <= tol and m_err <= 1e-3 and l_rel <= 1e-3
                and exact and max(rel) <= tol):
            raise AssertionError(f"the ring-step kernels disagree with their "
                                 f"plain versions ({name})")
        if pairs in (t * t, t * (t + 1) // 2):  # all visible, or a diagonal
            def library(_=None, diagonal=pairs < t * t):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=diagonal, enable_gqa=True)

            lib_ms, lib_graph = cuda_ms(library), graph_us(library,
                                                           [None]) / 1e3
            by_case[name].update(library_ms=lib_ms, library_graph_ms=lib_graph)
            log(f"  SDPA ({'causal' if pairs < t * t else 'no mask'}, GQA) "
                f"{lib_ms:.4f} ms ({fwd_ms / lib_ms:.2f}x), device "
                f"{lib_graph:.4f} ms ({fwd_graph / lib_graph:.2f}x)")
        if name == "past":
            timed = dict(
                fwd_plain=cuda_ms(lambda: flash_partial_reference(
                    q, k, v, q_off, kv_off, **kw), iters=5),
                bwd_plain=cuda_ms(lambda: flash_partial_bwd_reference(
                    q, do, k, v, lse, delta, q_off, kv_off, **kw), iters=5),
                fwd_lib=lib_ms, fwd_lib_graph=lib_graph,
                fwd_b=fwd_b, bwd_b=bwd_b)
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                o_lib = F.scaled_dot_product_attention(*leaves,
                                                       enable_gqa=True)
                timed["bwd_lib"] = cuda_ms(lambda: torch.autograd.grad(
                    o_lib, leaves, do, retain_graph=True))
                del o_lib, leaves
        del q, do, k, v, o, m, l, o_r, m_r, l_r, g, g_r
    past = by_case["past"]
    past["bwd_vs_library"] = past["bwd_ms"] / timed["bwd_lib"]
    log(f"  past block: flash_partial {past['ms']:.4f} ms (device "
        f"{past['graph_ms']:.4f} in a CUDA graph), plain "
        f"{timed['fwd_plain']:.4f} ms, library (SDPA, no mask) "
        f"{timed['fwd_lib']:.4f} ms (device {timed['fwd_lib_graph']:.4f}); "
        f"flash_partial_bwd "
        f"{past['bwd_ms']:.4f} ms ({past['bwd_tflops_7']:.1f} / "
        f"{past['bwd_tflops_5']:.1f} TFLOP/s on 7 / 5 products, "
        f"{past['bwd_vs_library']:.2f}x the library's time), plain "
        f"{timed['bwd_plain']:.4f} ms, library (SDPA backward) "
        f"{timed['bwd_lib']:.4f} ms")
    torch.cuda.empty_cache()
    del full
    at = (f"B=1 Hq={HQ} Hkv={HKV} D={D} T=Tkv={T} bf16, past block (q_off "
          f"1024, kv_off 0); by_offset has every offset, zigzag's half "
          f"shards too")
    src = "starway_tpu_torch/csrc/"
    return {
        "flash_partial": dict(
            name="flash_partial", route="cuda", source=src + "flash_fwd.cu",
            replaces="starway_tpu/ops/pallas_attention.py:580 "
                     "(_partial_kernel, entry flash_partial :640)",
            max_abs_err=worst["fwd"], ms=by_case["past"]["ms"],
            plain_ms=timed["fwd_plain"], bound_ms=timed["fwd_b"][0],
            bound_by=timed["fwd_b"][1], library_ms=timed["fwd_lib"],
            graph_ms=past["graph_ms"], library_graph_ms=timed["fwd_lib_graph"],
            timed_at=at + "; ms by events around one call, graph_ms device "
                          "ms a call in a CUDA graph",
            by_offset=by_case),
        "flash_partial_bwd": dict(
            name="flash_partial_bwd", route=MMA_ROUTE,
            source=src + "flash_bwd.cu",
            replaces="starway_tpu/ops/pallas_attention.py:734 "
                     "(flash_partial_bwd, through _run_bwd_passes :406)",
            max_abs_err=worst["bwd"], ms=by_case["past"]["bwd_ms"],
            plain_ms=timed["bwd_plain"], bound_ms=timed["bwd_b"][0],
            bound_by=timed["bwd_b"][1], library_ms=timed["bwd_lib"],
            tflops_7=past["bwd_tflops_7"], tflops_5=past["bwd_tflops_5"],
            vs_library=past["bwd_vs_library"],
            timed_at=at + "; both passes, float32 outputs; max_abs_err is "
                          "relative to max |grad|")}


def back_to_back(fn, n: int = 100):
    """(device us, host enqueue us) a call of ``n`` calls in a row: CUDA
    events around the run, and the host clock before any synchronize."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    host_us = (time.perf_counter() - t0) / n * 1e6
    end.synchronize()
    return start.elapsed_time(end) / n * 1e3, host_us


def split_effect(dev) -> dict:
    """Pass A's split over query heads (ops/flash.py dkv_splits) against
    no split, in this call: flash_partial_bwd at zigzag's half shard (T =
    512, an unmasked hi-lo pair) and at the ring's past block (T = 1024),
    llama3-8b heads, bf16.  Device us a call over back-to-back calls (the
    host's enqueue is the limit where it is the larger), the host's
    enqueue us a call, and the two results held against each other (1e-5
    of max |grad|: float32 partials summed in another order).  Its inputs
    come from a generator of its own, so the checks after it in phase 3
    see the inputs they saw before it was added."""
    import torch

    from starway_tpu_torch.ops import flash

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    chosen = flash.dkv_splits
    out = {}
    for name, t, q_off, causal in (("zigzag half shard", 512, 2048, False),
                                   ("ring past block", 1024, 1024, True)):
        q, do = randn(1, 32, t, 128), randn(1, 32, t, 128)
        k, v = randn(1, 8, t, 128), randn(1, 8, t, 128)
        lse = 4.0 + torch.rand(1, 32, t, generator=gen, device=dev)
        delta = torch.randn(1, 32, t, generator=gen, device=dev)

        def call():
            return flash.flash_partial_bwd(q, do, k, v, lse, delta, q_off, 0,
                                           causal=causal)

        row, grads = {"splits": chosen(1, 8, t, 4)}, []
        for label, fn in (("split", chosen), ("no split", lambda *a: 1)):
            flash.dkv_splits = fn
            try:
                grads.append(call())
                row[label] = dict(zip(("device_us", "host_us"),
                                      back_to_back(call)))
            finally:
                flash.dkv_splits = chosen
        err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(*grads))
        log(f"  pass A's split at the {name} (T={t}, {row['splits']} ways): "
            f"{row['split']['device_us']:.1f} us a call (host "
            f"{row['split']['host_us']:.1f}), without it "
            f"{row['no split']['device_us']:.1f} us (host "
            f"{row['no split']['host_us']:.1f}); gradients agree to "
            f"{err:.2e} of max |grad| (tol 1e-5)")
        if not err <= 1e-5:
            raise AssertionError(f"the split pass A disagrees with the "
                                 f"unsplit one at the {name}")
        out[name] = dict(row, rel_err=err)
        del q, do, k, v, lse, delta, grads
    torch.cuda.empty_cache()
    return out


def make_requests(cfg, n: int = 12):
    """(tokens, budget, prefixed) with no prefix: prompts of 50-1500
    tokens, budgets of 16-64."""
    rng = np.random.default_rng(SEED + 1)
    return [(rng.integers(1, cfg.vocab_size, int(p)).tolist(), int(m), False)
            for p, m in zip(rng.integers(50, 1501, n), rng.integers(16, 65, n))]


def make_paged_requests(cfg):
    """A 1000-token system prompt and 24 requests: 12 plain (prompts of
    100-1500 tokens) and 12 that continue the prompt (suffixes of 20-300
    tokens), budgets of 16-64, interleaved."""
    rng = np.random.default_rng(SEED + 7)
    prefix = rng.integers(1, cfg.vocab_size, 1000).tolist()
    reqs = []
    for i in range(24):
        lo, hi = (20, 301) if i % 2 else (100, 1501)
        n = int(rng.integers(lo, hi))
        reqs.append((rng.integers(1, cfg.vocab_size, n).tolist(),
                     int(rng.integers(16, 65)), bool(i % 2)))
    return prefix, reqs


class TimedChunks:
    """Mixin for SlotServer and PagedSlotServer: host time of every decode
    chunk, one steady chunk traced (its kernels' device ms, the GEMV's and
    the decode-attention kernels'), and the peak of the paged pool's pages
    in use."""

    def __init__(self, *args, **kwargs):
        self.chunk_ms, self.traced, self.peak_pages = [], {}, 0
        super().__init__(*args, **kwargs)

    def _run_chunk(self):
        import torch

        torch.cuda.synchronize()
        if len(self.chunk_ms) == 2 and not self.traced:  # a steady chunk
            out = self._traced_chunk()
        else:
            t0 = time.perf_counter()
            out = super()._run_chunk()  # ends with a device-to-host copy
            self.chunk_ms.append((time.perf_counter() - t0) * 1e3)
        self.peak_pages = max(self.peak_pages,
                              getattr(self, "pages_in_use", 0))
        return out

    def _traced_chunk(self):
        """One chunk under torch.profiler: its summed kernel time is the
        device's busy time for a chunk.  The tracer's own start-up and
        event processing are timed too, and left out of the run's wall
        time."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from starway_tpu_torch.ops.decode_bench import attention_device_ms

        t_call = time.perf_counter()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = super()._run_chunk()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(getattr(e, "self_device_time_total", 0)
                      for e in kernels)
        gemv_us = sum(getattr(e, "self_device_time_total", 0)
                      for e in kernels if "gemv_" in e.key)
        attn_ms = attention_device_ms(prof)[0]
        self.traced.update(
            traced_chunk_ms=wall_ms,
            device_busy_ms=busy_us / 1e3 if busy_us else None,
            gemv_device_ms=gemv_us / 1e3 if busy_us else None,
            attention_device_ms=attn_ms if busy_us else None,
            tracer_overhead_s=time.perf_counter() - t_call - wall_ms / 1e3)
        return out


def serve(params, cfg, reqs, *, server=None, prefix=None, n_slots=8,
          max_len=2048, chunk=8, **kw):
    """Drive ``server`` (SlotServer by default) over ``reqs`` of (tokens,
    budget, prefixed); with ``prefix`` registered first, a prefixed
    request's tokens are its suffix.  Returns (finished, stats, server)."""
    import torch

    from starway_tpu_torch.models import SlotServer

    timed = type("Timed", (TimedChunks, server or SlotServer), {})
    srv = timed(params, cfg, n_slots=n_slots, max_len=max_len, chunk=chunk,
                seed=SEED, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pid = None if prefix is None else srv.register_prefix(prefix)
    rids = [srv.submit(p, m, prefix=pid if w else None) for p, m, w in reqs]
    done = srv.run()
    torch.cuda.synchronize()
    traced = srv.traced
    wall = time.perf_counter() - t0 - traced.get("tracer_overhead_s", 0.0)
    chunk_ms = srv.chunk_ms
    for rid, (_p, m, _w) in zip(rids, reqs):
        got = done.get(rid)
        if got is None or len(got) != m:
            raise AssertionError(f"request {rid} finished with "
                                 f"{None if got is None else len(got)} "
                                 f"tokens, budget {m}")
        if not ((got >= 0) & (got < cfg.vocab_size)).all():
            raise AssertionError(f"request {rid} emitted out-of-vocab ids")
    n_tok = sum(m for _p, m, _w in reqs)
    # Admission (prefills, slot writes, the first tokens) is the wall time
    # outside the decode chunks.
    decode_s = (sum(chunk_ms) + traced.get("traced_chunk_ms", 0.0)) / 1e3
    stats = dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                 chunks=len(chunk_ms) + bool(traced),
                 median_chunk_ms=statistics.median(chunk_ms),
                 admission_s=wall - decode_s, **traced)
    if traced.get("device_busy_ms"):  # else: not measured (no CUDA events)
        # Against an untraced chunk: tracing slows the host, not the device.
        stats["device_idle_share"] = (
            1 - traced["device_busy_ms"] / stats["median_chunk_ms"])
    if srv.peak_pages:
        stats["peak_pages_in_use"] = srv.peak_pages
    return dict(zip(rids, (done[r] for r in rids))), stats, srv


def traced_admissions(srv, reqs) -> dict:
    """Phase 4's admissions once more, on the server that has just served
    them: each request again with a budget of one token (admission only:
    the prefill at its bucket and the first token, no decode chunk),
    under torch.profiler.  Returns the flash forward's device ms summed
    over its kernels in the trace (its share of the 12 admissions,
    measured on the path), their count, and the device's busy ms over
    the admissions; None where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for tokens, _m, _w in reqs:
            srv.submit(tokens, 1)
        srv.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in kernels)
    fwd = [e for e in kernels if "flash_fwd" in e.key]
    fwd_us = sum(getattr(e, "self_device_time_total", 0) for e in fwd)
    return dict(traced_wall_ms=wall_ms,
                device_busy_ms=busy_us / 1e3 if busy_us else None,
                flash_fwd_device_ms=fwd_us / 1e3 if busy_us else None,
                flash_fwd_kernels=sum(e.count for e in fwd))


def plain_attn(q, k, v):
    from starway_tpu_torch.ops.flash import flash_forward_reference

    return flash_forward_reference(q, k, v, causal=True)[0]


def check_first_logits(params, cfg, prompt, max_len):
    """First-token logits of one request as admission computes them (the
    flash kernel) against a forward through the plain attention."""
    import torch

    from starway_tpu_torch.models.generate import prefill
    from starway_tpu_torch.models.llama import forward
    from starway_tpu_torch.models.serving import _bucket, default_buckets

    dev = params["embed"].device
    pb = _bucket(len(prompt), default_buckets(max_len))
    padded = torch.zeros((1, pb), dtype=torch.long, device=dev)
    padded[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    last = torch.tensor([len(prompt) - 1], device=dev)
    got, _ = prefill(params, cfg, padded, pb, logit_positions=last)
    want = forward(params, padded, cfg, plain_attn, logit_positions=last)[:, 0]
    return compare_logits(got, want)


def check_prefixed_logits(srv, params, cfg, prefix, suffix):
    """First-token logits of a request that continues the server's
    registered prefix, as a prefixed admission computes them (the prefix
    pages from the flash prefill, the tail page copied, the suffix through
    the paged kernel at C = its bucket) into free pool pages, against a
    forward of prefix + suffix through the plain attention."""
    import torch

    from starway_tpu_torch.models.llama import forward

    pid = next(iter(srv._prefixes))
    shared = srv._prefixes[pid][0][0]
    n_own = srv._own_pages(len(suffix), pid)
    row = np.zeros(srv.max_pages, np.int32)
    row[:len(shared)] = shared
    row[len(shared):len(shared) + n_own] = srv._peek_free(n_own)
    got = srv._ingest_prefixed(row, np.asarray(suffix, np.int64), pid)
    dev = params["embed"].device
    full = torch.tensor([list(prefix) + list(suffix)], device=dev)
    last = torch.tensor([full.shape[1] - 1], device=dev)
    want = forward(params, full, cfg, plain_attn, logit_positions=last)[:, 0]
    return compare_logits(got, want)


def compare_logits(got, want):
    """Logits of the kernels' path against the plain path's, within
    LOGIT_REL_TOL of max |logit|."""
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


def phase_paged(params, cfg):
    """Phase 5: PagedSlotServer on llama3-8b widths (bf16, 32 layers) with
    a shared 1000-token system prompt.  Returns (stats, launches)."""
    from starway_tpu_torch.models import PagedSlotServer
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts

    n_slots, max_len, page, chunk = 16, 4096, 64, 8
    # 33 pages a slot is this traffic's worst case: a 2048 bucket and its
    # budget, or the prompt's 1000 tokens, a 512 bucket and its budget.
    n_pages = n_slots * 33 + 1
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    prefix, reqs = make_paged_requests(cfg)
    n_prefixed = sum(w for _p, _m, w in reqs)
    log(f"[paged] llama3-8b bf16, 32 layers, PagedSlotServer n_slots="
        f"{n_slots} max_len={max_len} page={page} chunk={chunk} n_pages="
        f"{n_pages}: pool {n_pages * page * kv_bytes / 1e9:.2f} GB for "
        f"{n_pages * page} tokens, where a dense cache of {n_slots} x "
        f"{max_len} would take {n_slots * max_len * kv_bytes / 1e9:.2f} GB; "
        f"a {len(prefix)}-token system prompt, {len(reqs) - n_prefixed} "
        f"plain requests and {n_prefixed} that continue the prompt")
    reset_launch_counts()
    done, stats, srv = serve(params, cfg, reqs, server=PagedSlotServer,
                             prefix=prefix, n_slots=n_slots, max_len=max_len,
                             chunk=chunk, page=page, n_pages=n_pages)
    counts = launch_counts()
    log(f"  {stats}")
    log(f"  launches {counts}")
    want = cfg.n_layers * (chunk * stats["chunks"] + n_prefixed)
    if counts["paged_decode_attention"] != want:
        raise AssertionError(
            f"paged_decode_attention launched {counts['paged_decode_attention']}"
            f" times, not {cfg.n_layers} per decode step and per prefixed "
            f"admission ({want})")
    if counts["decode_attention"] or not counts["flash_forward"]:
        raise AssertionError("the paged run must decode through the paged "
                             "kernel only and prefill through flash")
    if srv.pages_in_use != len(prefix) // page:
        raise AssertionError(f"{srv.pages_in_use} pages in use after the run;"
                             f" the prompt's {len(prefix) // page} expected")
    suffix = next(p for p, _m, w in reqs if w)
    stats["prefixed_logit_rel_err"] = check_prefixed_logits(
        srv, params, cfg, prefix, suffix)
    del srv, done
    return stats, counts


def phase_paged_parity(params, cfg):
    """Phase 8: float32, 2 layers, full widths.  PagedSlotServer without
    and with a registered prefix, and SlotServer with it: greedy tokens
    equal generate(prefix + suffix) for every request."""
    import torch

    from starway_tpu_torch.models import PagedSlotServer, SlotServer, generate

    rng = np.random.default_rng(SEED + 8)
    prefix = rng.integers(1, cfg.vocab_size, 300).tolist()
    reqs = []
    for i in range(6):
        lo, hi = (10, 101) if i % 2 else (50, 401)
        reqs.append((rng.integers(1, cfg.vocab_size, int(rng.integers(lo, hi)))
                     .tolist(), int(rng.integers(8, 25)), bool(i % 2)))
    full = [(prefix if w else []) + p for p, _m, w in reqs]
    want = [generate(params, cfg, torch.tensor([f]), m, max_len=2048)
            [0, len(f):].cpu().numpy() for f, (_p, m, _w) in zip(full, reqs)]
    runs = (("PagedSlotServer, prompts in full", PagedSlotServer, None,
             [(f, m, False) for f, (_p, m, _w) in zip(full, reqs)]),
            ("PagedSlotServer, prefix registered", PagedSlotServer, prefix,
             reqs),
            ("SlotServer, prefix registered", SlotServer, prefix, reqs))
    out = {}
    for name, server, pre, rq in runs:
        kw = dict(page=64) if server is PagedSlotServer else {}
        done, stats = serve(params, cfg, rq, server=server, prefix=pre,
                            n_slots=4, max_len=2048, **kw)[:2]
        for rid, w in zip(done, want):
            if not np.array_equal(done[rid], w):
                raise AssertionError(f"{name}, request {rid}: {done[rid]} "
                                     f"!= generate {w}")
        log(f"  {name}: {len(done)} requests token-for-token equal to "
            f"generate(prefix + suffix); median chunk "
            f"{stats['median_chunk_ms']:.1f} ms")
        out[name] = stats["median_chunk_ms"]
    return out


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
    from starway_tpu_torch.utils.cuda_timing import visible_pairs

    hd, L = cfg.head_dim, cfg.n_layers
    per_layer = (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff)
    n = L * per_layer + cfg.d_model * cfg.vocab_size
    attn = 12 * hd * visible_pairs(s_len, s_len) * cfg.n_heads * b * L
    return 6.0 * n * tokens + attn


def kernel_family(name: str) -> str:
    for key in ("flash_partial", "flash_bwd_dkv", "flash_bwd_dq",
                "flash_fwd"):
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


def fresh_peak() -> dict:
    """Reset the peak; return the memory allocated now and what the cycle
    collector freed first.  That is device memory an earlier phase left in
    a reference cycle past its last name, which a user pays for until the
    collector runs: 0 expected (the servers held their weights and cache
    in one until their chunk step stopped being kept on the server)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    freed = before - torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"  device memory freed by the cycle collector: {freed / 1e9:.3f} GB")
    return dict(memory_at_start_gb=torch.cuda.memory_allocated() / 1e9,
                memory_in_cycles_gb=freed / 1e9)


def train_steps(trainer, batch, steps: int):
    """``steps`` Trainer steps on one batch, the last under the profiler.
    Returns (losses, host ms of the untraced steps, trace summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    losses, step_ms, traced = [], [], {}
    for i in range(steps):
        if i == steps - 1:  # the last step, under the profiler
            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                losses.append(trainer.step_sync(batch))
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
            traced = trace_summary(prof, traced_ms)
            log(f"  step {steps} (traced): loss {losses[-1]:.4f}")
            continue
        t0 = time.perf_counter()
        losses.append(trainer.step_sync(batch))  # ends in loss.item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  step {i + 1}: loss {losses[-1]:.4f}, {step_ms[-1]:.1f} ms")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"training did not lower the loss: {losses}")
    return losses, step_ms, traced


def train_stats(cfg, trainer, losses, step_ms, traced, b: int, s_len: int,
                mem: dict):
    """The training metrics of one run (PERF.md section 2); ``mem`` is
    :func:`fresh_peak`'s reading when the run started (weights, optimizer
    state and whatever an earlier phase still holds)."""
    import torch

    med = statistics.median(step_ms[1:])  # step 1 warms up
    flops = model_flops(cfg, b * s_len, b, s_len)
    stats = dict(losses=losses, median_step_ms=med,
                 **mem,
                 first_step_ms=step_ms[0], tokens_per_s=b * s_len / med * 1e3,
                 model_flop_share=flops / (med / 1e3) / BF16_FLOPS,
                 model_tflop_per_step=flops / 1e12,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                 telemetry_p50_us={k: round(v["p50_us"], 1) for k, v in
                                   trainer.telemetry().items()},
                 **traced)
    if traced.get("device_busy_ms"):  # else: not measured (no CUDA events)
        stats["device_idle_share"] = 1 - traced["device_busy_ms"] / med
    return stats


def phase_train(dev):
    """Phase 9: Trainer + adamw, llama3-8b widths cut to 4 layers, bf16,
    remat "dots", 6 steps on one batch.  Returns (stats, launches)."""
    import torch

    from starway_tpu_torch.models import LlamaConfig, Trainer, init_params
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.utils import adamw

    B, S, STEPS = 2, 2048, 6
    cfg = LlamaConfig.preset("llama3-8b", n_layers=4, remat=True,
                             remat_policy="dots")
    params = init_params(cfg, SEED + 3, device=dev)
    batch = train_batch(cfg, B, S + 1, SEED + 4, dev)
    trainer = Trainer(cfg, adamw(LR_TRAIN), params)
    mem = fresh_peak()
    log(f"[train] llama3-8b widths, {cfg.n_layers} layers (cut from 32), "
        f"bf16, remat dots, AdamW lr {LR_TRAIN:g}, batch [{B}, {S + 1}], "
        f"{STEPS} steps on one batch")
    reset_launch_counts()
    losses, step_ms, traced = train_steps(trainer, batch, STEPS)
    counts = launch_counts()
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        if counts[name] != STEPS * cfg.n_layers:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{STEPS} steps of {cfg.n_layers} layers")
    stats = train_stats(cfg, trainer, losses, step_ms, traced, B, S, mem)
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


def block_rel_err(got, want, block: int = 512) -> float:
    """The largest ``||got - want|| / ||want||`` over blocks of ``block``
    sequence rows (dim 2): a row that sees a few keys has outputs of O(1)
    and one that sees thousands of ~0.02, so each block is held to its
    own size."""
    err = 0.0
    for g, w in zip(got.float().split(block, 2), want.float().split(block, 2)):
        err = max(err, ((g - w).norm() / w.norm()).item())
    return err


def ring_attention_check(mesh, dev, s_len: int = 4096) -> dict:
    """One layer's attention at train-ring's shapes (q [1, 32, 4096, 128]
    bf16, k/v [1, 8, 4096, 128]): the ring and zigzag attn_fns' output and
    (dq, dk, dv) against the flash kernel's on the same inputs, each
    within GRAD_REL_TOL in every 512-row block.  This holds zigzag's half
    blocks (T 512) and its hi-lo pairs (causal=False) at bf16."""
    import torch

    from starway_tpu_torch.models import make_sharded_attn
    from starway_tpu_torch.ops.flash import flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, do = randn(1, 32, s_len, 128), randn(1, 32, s_len, 128)
    k, v = randn(1, 8, s_len, 128), randn(1, 8, s_len, 128)

    def run(fn):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o = fn(*leaves)
            return [o.detach(), *torch.autograd.grad(o, leaves, do)]

    want = run(lambda a, b, c: flash_attention(a, b, c, causal=True))
    tol = GRAD_REL_TOL["bfloat16"]
    out = {}
    for layout in ("ring", "zigzag"):
        got = run(make_sharded_attn(mesh, layout=layout))
        errs = [block_rel_err(g, w) for g, w in zip(got, want)]
        log(f"  {layout} attention vs flash_attention, [1, 32, {s_len}, 128] "
            f"bf16: worst 512-row block error relative to its norm o/dq/dk/"
            f"dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}/{errs[3]:.3e} "
            f"(tol {tol})")
        if not max(errs) <= tol:
            raise AssertionError(f"{layout} ring attention disagrees with "
                                 f"the flash attention at bf16")
        out[layout] = max(errs)
    del q, k, v, do, want, got
    torch.cuda.empty_cache()
    return out


def phase_train_ring(dev):
    """Phase 11: the Trainer with ring attention over make_mesh({"sp": 4})
    on this card, ring then zigzag, then the flash attention on the same
    batch as the yardstick; each run from the same initial weights, freed
    before the next.  Returns (stats by run, launches summed over the
    runs)."""
    import torch

    from starway_tpu_torch.models import (LlamaConfig, Trainer, init_params,
                                          make_sharded_attn)
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.parallel import make_mesh
    from starway_tpu_torch.utils import adamw

    B, S, STEPS, SP = 1, 4096, 6, 4
    cfg = LlamaConfig.preset("llama3-8b", n_layers=4, remat=True,
                             remat_policy="dots")
    batch = train_batch(cfg, B, S + 1, SEED + 9, dev)
    mesh = make_mesh({"sp": SP}, device=dev)
    per_layer = {"ring": SP * SP, "zigzag": 2 * SP * SP + SP}
    log(f"[train-ring] one layer's attention, ring and zigzag on {mesh}")
    attn_err = ring_attention_check(mesh, dev)
    runs = (("ring", make_sharded_attn(mesh)),
            ("zigzag", make_sharded_attn(mesh, layout="zigzag")),
            ("flash", None))
    out, total = {}, {}
    for name, attn in runs:
        log(f"[train-ring] {name}: llama3-8b widths, {cfg.n_layers} layers, "
            f"bf16, remat dots, AdamW lr {LR_TRAIN:g}, batch [{B}, {S + 1}], "
            f"{STEPS} steps; {mesh}, shards of {S // SP} tokens")
        params = init_params(cfg, SEED + 3, device=dev)
        trainer = Trainer(cfg, adamw(LR_TRAIN), params, attn_fn=attn)
        mem = fresh_peak()
        reset_launch_counts()
        losses, step_ms, traced = train_steps(trainer, batch, STEPS)
        counts = launch_counts()
        stats = train_stats(cfg, trainer, losses, step_ms, traced, B, S,
                            mem)
        stats["launches"] = {k: c for k, c in counts.items() if c}
        log(f"  {stats}")
        if name in per_layer:
            want = STEPS * cfg.n_layers * per_layer[name]
            got = (counts["flash_partial"], counts["flash_partial_bwd"])
            if got != (want, want) or counts["flash_forward"] or counts[
                    "flash_backward_dkv"] or counts["flash_backward_dq"]:
                raise AssertionError(
                    f"{name}: flash_partial / flash_partial_bwd launched "
                    f"{got}, not {want} each ({STEPS} steps x "
                    f"{cfg.n_layers} layers x {per_layer[name]}), or a plain "
                    f"flash kernel ran: {counts}")
        elif counts["flash_partial"] or counts["flash_forward"] != (
                STEPS * cfg.n_layers):
            raise AssertionError(f"the flash run's launches: {counts}")
        total = {k: total.get(k, 0) + c for k, c in counts.items()}
        out[name] = stats
        del trainer, params
        torch.cuda.empty_cache()
    flash_ms = out["flash"]["median_step_ms"]
    for name in per_layer:
        gap = (abs(out[name]["losses"][0] - out["flash"]["losses"][0])
               / abs(out["flash"]["losses"][0]))
        out[name]["first_loss_rel_gap"] = gap
        out[name]["attention_block_rel_err"] = attn_err[name]
        out[name]["step_vs_flash"] = out[name]["median_step_ms"] / flash_ms
        fam = out[name].get("device_ms_by_family", {})
        ff = out["flash"].get("device_ms_by_family", {})
        log(f"  {name}/flash step ratio {out[name]['step_vs_flash']:.3f}; "
            f"device ms in the traced step: flash_partial "
            f"{fam.get('flash_partial')}, dK/dV pass "
            f"{fam.get('flash_bwd_dkv')}, dQ pass {fam.get('flash_bwd_dq')} "
            f"(flash run: forward {ff.get('flash_fwd')}, dK/dV "
            f"{ff.get('flash_bwd_dkv')}, dQ {ff.get('flash_bwd_dq')})")
        log(f"  {name}: first-step loss {out[name]['losses'][0]:.6f} vs flash "
            f"{out['flash']['losses'][0]:.6f}, relative gap {gap:.3e} (tol "
            f"1e-2); median step {out[name]['median_step_ms']:.1f} ms vs "
            f"flash {out['flash']['median_step_ms']:.1f} ms")
        if not gap <= 1e-2:
            raise AssertionError(f"{name}: the first-step loss is {gap:.3e} "
                                 f"from the flash run's")
    return out, total


def phase_train_ring_parity(dev):
    """Phase 12: one float32 step, llama3-8b widths, 2 layers, [1, 513],
    sp = 4: ring and zigzag through the kernels against the same step
    through the plain attention."""
    import torch

    from starway_tpu_torch.models import (LlamaConfig, init_params,
                                          make_sharded_attn)
    from starway_tpu_torch.models.llama import value_and_grad
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.attention import blockwise_attention
    from starway_tpu_torch.parallel import make_mesh
    from starway_tpu_torch.utils.tree import tree_leaves

    SP = 4
    cfg = LlamaConfig.preset("llama3-8b", n_layers=2, dtype="float32",
                             remat=True, remat_policy="dots")
    params = init_params(cfg, SEED + 5, device=dev)
    batch = train_batch(cfg, 1, 513, SEED + 6, dev)
    mesh = make_mesh({"sp": SP}, device=dev)
    log(f"[train-ring-parity] float32, 2 layers, [1, 513], remat dots, "
        f"{mesh}: ring and zigzag kernels against the plain attention")

    def plain_attn(q, k, v):
        return blockwise_attention(q, k, v, causal=True)

    want_loss, want = value_and_grad(params, batch, cfg, plain_attn)
    out = {}
    for layout, per_layer in (("ring", SP * SP), ("zigzag", 2 * SP * SP + SP)):
        reset_launch_counts()
        loss, grads = value_and_grad(params, batch, cfg,
                                     make_sharded_attn(mesh, layout=layout))
        torch.cuda.synchronize()
        counts = launch_counts()
        n = cfg.n_layers * per_layer
        if (counts["flash_partial"], counts["flash_partial_bwd"]) != (n, n):
            raise AssertionError(f"{layout}: launches {counts}, want {n} "
                                 f"flash_partial and flash_partial_bwd")
        loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
        worst = 0.0
        for g, w in zip(tree_leaves(grads), tree_leaves(want)):
            worst = max(worst, ((g - w).abs().max() / w.abs().max()).item())
        log(f"  {layout}: loss {loss.item():.6f} vs plain "
            f"{want_loss.item():.6f} (rel {loss_err:.2e}, tol 1e-5); worst "
            f"gradient leaf error relative to its max {worst:.3e} (tol "
            f"{TRAIN_GRAD_REL_TOL}); {n} launches of each ring-step kernel")
        if not (loss_err <= 1e-5 and worst <= TRAIN_GRAD_REL_TOL):
            raise AssertionError(f"the {layout} ring step disagrees with the "
                                 f"plain-attention step")
        out[layout] = dict(loss_rel_err=loss_err, worst_grad_rel_err=worst)
        del grads
    del params, want
    torch.cuda.empty_cache()
    return out


PTXAS_SOURCES = ("flash_bwd.cu", "flash_fwd.cu", "int8_gemv.cu",
                 "decode_attention.cu", "paged_attention.cu")


def start_ptxas_report(build):
    """Compile the sources of the tensor-core kernels (PTXAS_SOURCES) once
    more with ``-Xptxas -v`` (into scratch objects, beside the build)
    for their registers and spills;
    :func:`finish_ptxas_report` reads them."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return [subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(build.CSRC), "-c", str(build.CSRC / src), "-o",
         str(build.BUILD_DIR / f"{src}.ptxas_report.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PTXAS_SOURCES]


def ptxas_kernel(mangled: str):
    """A short name for a tensor-core kernel of the report, else None."""
    import re

    k = re.search(r"flash_bwd_(dkv|dq)_mma_kernelI(\w+?)Li(\d+)E", mangled)
    if k:
        to = "f32" if k.group(2) == "f" else "bf16"
        return f"{k.group(1)} {to} D={k.group(3)}"
    k = re.search(r"flash_(fwd|partial)_mma_kernelILi(\d+)ELi(\d+)E",
                  mangled)
    if k:
        return (f"{k.group(1)} bf16 D={k.group(2)} "
                f"rows={64 * int(k.group(3))}")
    k = re.search(r"gemv_(decode|prefill)_kernelILi(\d+)E(?:Li(\d+)E)?"
                  r"Lb([01])E(?:Lb([01])E)?", mangled)
    if k:
        size = (f"NT={k.group(2)}" if k.group(1) == "decode"
                else f"{k.group(2)}x{k.group(3)}")
        vec = "vec" if k.group(4) == "1" else "elementwise"
        early = " early" if k.group(5) == "1" else ""
        return f"gemv {k.group(1)} {size} {vec}{early}"
    k = re.search(r"(decode|paged)_mma_kernelI(13__nv_bfloat16|a)?Li(\d+)E"
                  r"Lb([01])E", mangled)
    if k:
        kv = "int8" if k.group(2) == "a" else "bf16"
        regime = "decode" if k.group(4) == "1" else "ingest"
        return f"{k.group(1)} {kv} KV D={k.group(3)} {regime}"
    return None


def finish_ptxas_report(procs) -> dict:
    """{source: {kernel: (registers, spill store bytes, spill load
    bytes)}} of the tensor-core kernels, from ptxas."""
    import re

    out = {}
    for src, proc in zip(PTXAS_SOURCES, procs):
        text, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v failed on {src}:\n"
                               f"{text[-3000:]}")
        regs, name = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = ptxas_kernel(m.group(1))
                spill = (None, None)  # read from the lines that follow
                continue
            if name is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs[name] = (int(m.group(1)), *spill)
                name = None
        out[src] = regs
        log(f"[registers] {src} (ptxas, sm_90a): (registers a thread, spill "
            f"store bytes, spill load bytes) {regs}")
    return out


# ------------------------------------------------------------- transport
#
# The transport's main path: Server/Client asend/arecv on CUDA tensors
# through every transport, host <-> cuda:0 and cuda:0 <-> cuda:0 (one
# card).  name -> (STARWAY_TLS, STARWAY_NATIVE).
TRANSPORTS = {
    "inproc": ("inproc,sm,tcp", "0"),
    "tcp": ("tcp", "0"),
    "sm": ("tcp,sm", "0"),
    "native": ("tcp", "1"),
    "native-sm": ("tcp,sm", "1"),
}
# examples/pingpong.py --max-size 16M, and 64 MiB past the 8 MiB
# rendezvous threshold (config.py rndv_threshold).
SWEEP_SIZES = [4 << 10, 64 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20]
THROUGHPUT_BYTES = 256 << 20  # examples/throughput.py --size 256M
CHUNK_BYTES = 256 << 10       # config.py chunk_bytes default
RNDV_BYTES = 8 << 20          # config.py rndv_threshold default
MASK = (1 << 64) - 1


def sweep_iters(nbytes: int) -> tuple:
    """(warmup, timed) passes of a sweep pingpong of ``nbytes``."""
    if nbytes <= 1 << 20:
        return 5, 30
    return (2, 10) if nbytes <= 16 << 20 else (1, 5)


def use_transport(name: str) -> None:
    import os

    tls, native = TRANSPORTS[name]
    os.environ["STARWAY_TLS"] = tls
    os.environ["STARWAY_NATIVE"] = native


def expected_chunks(name: str, nbytes: int) -> tuple:
    """(chunks staged by the sender, chunks placed by the receiver) of one
    cuda:0 -> cuda:0 send of ``nbytes``.  In process the snapshot is
    copied on the card: neither is counted.  The C++ engine stages and
    places the whole payload once.  The Python engine stages chunk by
    chunk up to the rendezvous threshold and places chunk by chunk from
    two chunks up."""
    if name == "inproc":
        return 0, 0
    if name.startswith("native"):
        return 1, 1
    chunks = -(-nbytes // CHUNK_BYTES)
    armed = nbytes >= 2 * CHUNK_BYTES
    return (chunks if armed and nbytes <= RNDV_BYTES else 1,
            chunks if armed else 1)


async def one_way(client, server, payload, sink, tag: int) -> float:
    """One client -> server send into ``sink``; checks (tag, length) and
    returns the seconds from send to receive completion."""
    t0 = time.perf_counter()
    fut = server.arecv(sink, tag, MASK)
    await client.asend(payload, tag)
    got = await fut
    dt = time.perf_counter() - t0
    want = (tag, payload.numel() * payload.element_size())
    if tuple(got) != want:
        raise AssertionError(f"received (tag, length) {got}, sent {want}")
    return dt


async def host_pingpong(server, client, ep, nbytes: int, warmup: int,
                        iters: int) -> list:
    """Round-trip seconds of a host buffer to a host buffer and back: the
    engine alone, with no device plane, as the sweep's yardstick."""
    payload = np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                     dtype=np.uint8)
    sink = np.zeros(nbytes, dtype=np.uint8)
    ret = np.zeros(nbytes, dtype=np.uint8)
    rtts = []
    for i in range(warmup + iters):
        t0 = time.perf_counter()
        srv_fut = server.arecv(sink, 0x53, MASK)
        cli_fut = client.arecv(ret, 0x54, MASK)
        await client.asend(payload, 0x53)
        await srv_fut
        await server.asend(ep, sink, 0x54)
        await cli_fut
        if i >= warmup:
            rtts.append(time.perf_counter() - t0)
    if not np.array_equal(ret, payload):
        raise AssertionError(f"{nbytes} B host pingpong: bytes differ")
    return rtts


async def transport_checks(name: str, dev) -> dict:
    """Every check of one transport: the sweep (device <-> device and host
    <-> device), the chunk counts, stream order on both sides, overwrite
    after send, a bf16 payload; raises on a failed check."""
    import torch

    from starway_tpu_torch import DeviceBuffer, headline

    use_transport(name)
    server, client, ep = await headline.connect_pair()
    out = {"sweep": []}
    wire = "device" if name == "inproc" else "staged"
    try:
        for nbytes in SWEEP_SIZES:
            warm, iters = sweep_iters(nbytes)
            for host in (False, True):
                fw, raw = await headline.pingpong(
                    server, client, ep, nbytes, dev, dev, host, warm, iters,
                    seed=nbytes)
                row = headline.summary(fw, raw, nbytes)
                row["mode"] = "host<->device" if host else "device<->device"
                out["sweep"].append(row)
            rtts = await host_pingpong(server, client, ep, nbytes, warm, iters)
            out.setdefault("host_p50_us", {})[nbytes] = (
                statistics.median(rtts) * 1e6)

        # chunk counts: one cuda:0 -> cuda:0 send per size
        counts = {}
        for nbytes in (64 << 10, 1 << 20, 16 << 20, 64 << 20):
            src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                                device=dev)
            sink = DeviceBuffer((nbytes,), torch.uint8, device=dev)
            client._client.stage_scope.reset()
            server._server.stage_scope.reset()
            await one_way(client, server, src, sink, 0x61)
            staged = client._client.stage_scope.snapshot().get(
                "stage", {}).get("count", 0)
            placed = server._server.stage_scope.snapshot().get(
                "place", {}).get("count", 0)
            if (staged, placed) != expected_chunks(name, nbytes):
                raise AssertionError(
                    f"{name} {nbytes} B: chunks staged/placed "
                    f"{(staged, placed)}, expected "
                    f"{expected_chunks(name, nbytes)}")
            if not torch.equal(sink.array, src):
                raise AssertionError(f"{name} {nbytes} B: bytes differ")
            if sink.last_transport != wire:
                raise AssertionError(f"{name}: last_transport "
                                     f"{sink.last_transport!r}, not {wire!r}")
            counts[nbytes] = (staged, placed)
        out["chunks"] = counts

        # stream order: the payload is written by a kernel queued behind a
        # ~20 ms spin on the current stream, and sent with no synchronize;
        # the sink is written by such a kernel just before the receive is
        # posted.  Both must come out as the receive's bytes.
        nbytes = 4 << 20
        payload = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
        sink = DeviceBuffer((nbytes // 4,), torch.float32, device=dev)
        torch.cuda.synchronize()
        torch.cuda._sleep(40_000_000)
        sink.array.fill_(-1.0)
        fut = server.arecv(sink, 0x62, MASK)
        torch.cuda._sleep(40_000_000)
        payload.fill_(3.0)
        await client.asend(payload, 0x62)
        await fut
        if not bool((sink.array == 3.0).all()):
            raise AssertionError(f"{name}: the send or the receive ran ahead "
                                 f"of the work queued on the caller's stream")

        # overwrite after send: the send completes before any receive is
        # posted; the sender then overwrites its tensor
        for nbytes in (1 << 20, 16 << 20):
            src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                                device=dev)
            want = src.clone()
            await client.asend(src, 0x63)
            src.zero_()
            sink = DeviceBuffer((nbytes,), torch.uint8, device=dev)
            got = await server.arecv(sink, 0x63, MASK)
            if tuple(got) != (0x63, nbytes) or not torch.equal(sink.array,
                                                              want):
                raise AssertionError(f"{name} {nbytes} B: overwriting the "
                                     f"source after send completion changed "
                                     f"the delivered bytes")

        # bf16, both ways, into bf16 sinks on the card
        x = torch.randn(3, 1000, device=dev).to(torch.bfloat16)
        sink = DeviceBuffer((3, 1000), torch.bfloat16, device=dev)
        await one_way(client, server, x, sink, 0x64)
        back = DeviceBuffer.like(x)
        fut = client.arecv(back, 0x65, MASK)
        await server.asend(ep, sink, 0x65)
        await fut
        if not (torch.equal(sink.array, x) and torch.equal(back.array, x)):
            raise AssertionError(f"{name}: bf16 payload differs")
        out["stages"] = {
            "client": client._client.stage_scope.snapshot(),
            "server": server._server.stage_scope.snapshot()}
    finally:
        await client.aclose()
        await server.aclose()
    return out


async def throughput(name: str, dev) -> dict:
    """One 256 MiB cuda:0 -> cuda:0 send, timed from send to receive
    completion, against one raw copy on the card."""
    import torch

    from starway_tpu_torch import DeviceBuffer, headline

    use_transport(name)
    server, client, _ep = await headline.connect_pair()
    try:
        src = torch.randint(0, 256, (THROUGHPUT_BYTES,), dtype=torch.uint8,
                            device=dev)
        sink = DeviceBuffer((THROUGHPUT_BYTES,), torch.uint8, device=dev)
        await one_way(client, server, src, sink, 0x70)  # warm
        sink.array.zero_()
        torch.cuda.synchronize()
        dt = await one_way(client, server, src, sink, 0x71)
        if not torch.equal(sink.array, src):
            raise AssertionError(f"{name}: 256 MiB payload differs")
        t0 = time.perf_counter()
        src.to(dev, copy=True)
        torch.cuda.synchronize()
        raw = time.perf_counter() - t0
    finally:
        await client.aclose()
        await server.aclose()
    return {"seconds": dt, "gbps": THROUGHPUT_BYTES / dt / 1e9,
            "raw_gbps": THROUGHPUT_BYTES / raw / 1e9}


def echo_server_child(port: int, native: str, device: str, nbytes: int,
                      iters: int, result) -> None:
    """Spawned child: a Server over tcp that receives ``iters + 1``
    payloads into one DeviceBuffer on ``device`` and sends each back from
    it."""
    import asyncio
    import os

    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_NATIVE"] = native

    async def serve():
        import torch

        from starway_tpu_torch import DeviceBuffer, Server

        server = Server()
        server.listen("127.0.0.1", port)
        sink = DeviceBuffer((nbytes,), torch.uint8, device=device)
        ptr = sink.array.data_ptr()
        for _ in range(4000):
            if server.list_clients():
                break
            await asyncio.sleep(0.005)
        ep = server.list_clients().pop()
        for _ in range(iters + 1):
            tag, length = await server.arecv(sink, 0x81, MASK)
            await server.asend(ep, sink, 0x82)
        await server.aflush()
        ok = (sink.array.data_ptr() == ptr and sink.last_transport == "staged"
              and (tag, length) == (0x81, nbytes))
        await server.aclose()
        return ok

    result.put(asyncio.run(serve()))


async def cross_process(native: str, dev, nbytes: int = 1 << 20,
                        iters: int = 30) -> dict:
    """A pingpong of ``nbytes`` with the echo server in a spawned child on
    the same card, over tcp: CUDA tensors on both sides, staged on the
    wire."""
    import asyncio
    import multiprocessing as mp
    import socket

    import torch

    from starway_tpu_torch import Client, DeviceBuffer

    use_transport("native" if native == "1" else "tcp")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    child = ctx.Process(target=echo_server_child,
                        args=(port, native, str(dev), nbytes, iters,
                              result))
    child.start()
    try:
        for _ in range(240):
            client = Client()
            try:
                await client.aconnect("127.0.0.1", port)
                break
            except Exception:
                await asyncio.sleep(0.25)
        else:
            raise AssertionError("the echo server never came up")
        src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev)
        ret = DeviceBuffer((nbytes,), torch.uint8, device=dev)
        rtts = []
        for i in range(iters + 1):
            ret.array.zero_()
            t0 = time.perf_counter()
            fut = client.arecv(ret, 0x82, MASK)
            await client.asend(src, 0x81)
            got = await fut
            rtts.append(time.perf_counter() - t0)
        if tuple(got) != (0x82, nbytes) or not torch.equal(ret.array, src):
            raise AssertionError("cross-process pingpong: bytes differ")
        if ret.last_transport != "staged":
            raise AssertionError("cross-process receive was not staged")
        await client.aclose()
        if not result.get(timeout=120):
            raise AssertionError("the echo server's checks failed")
        child.join(60)
    finally:
        if child.is_alive():
            child.kill()
            child.join()
    rtts = sorted(rtts[1:])
    return {"p50_us": statistics.median(rtts) * 1e6,
            "gbps": 2 * nbytes / statistics.median(rtts) / 1e9}


def phase_transport(dev, card: str) -> dict:
    """The transport phase: the headline, the sweep and checks on every
    transport, the 256 MiB throughput, the cross-process pingpong on both
    engines; fails if a check fails or a fallback warning was logged."""
    import asyncio
    import logging
    import os

    from starway_tpu_torch import headline
    from starway_tpu_torch.core import native

    if not native.available():
        raise AssertionError("the C++ engine did not build")
    warnings = []

    class Catch(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    port_logger = logging.getLogger("starway_tpu_torch")
    catch = Catch()
    port_logger.addHandler(catch)
    saved = {k: os.environ.get(k) for k in ("STARWAY_TLS", "STARWAY_NATIVE")}
    t0 = time.perf_counter()
    try:
        use_transport("inproc")
        head = asyncio.run(headline.run())
        if head["fallback"]:
            raise AssertionError("the headline fell back to the CPU")
        log(f"[transport] headline {json.dumps(head)}")
        st = {"headline": {k: head[k] for k in ("value", "vs_baseline")}}
        for name in TRANSPORTS:
            res = asyncio.run(transport_checks(name, dev))
            st[name] = res
            for row in res["sweep"]:
                log(f"[transport] {name:9s} {row['mode']:15s} "
                    f"{row['bytes']:>9d} B  fw p50 {row['fw_p50_us']:9.1f} us "
                    f"p99 {row['fw_p99_us']:9.1f} us  raw p50 "
                    f"{row['raw_p50_us']:8.1f} us  {row['fw_gbps']:7.3f} GB/s "
                    f"(raw {row['raw_gbps']:7.3f})  vs_baseline "
                    f"{row['vs_baseline']:.3f}")
            log(f"[transport] {name:9s} host<->host p50 us by size (the "
                f"engine alone): {res['host_p50_us']}")
            log(f"[transport] {name} chunks staged/placed {res['chunks']}; "
                f"stages {res['stages']}")
        for name in ("inproc", "tcp"):
            st[f"throughput-{name}"] = asyncio.run(throughput(name, dev))
            log(f"[transport] 256 MiB one way {name}: "
                f"{st[f'throughput-{name}']}")
        for native_flag, label in (("0", "python"), ("1", "native")):
            st[f"cross-process-{label}"] = asyncio.run(
                cross_process(native_flag, dev))
            log(f"[transport] cross-process tcp {label} engine, 1 MiB "
                f"device<->device: {st[f'cross-process-{label}']}")
    finally:
        port_logger.removeHandler(catch)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fallbacks = [w for w in warnings if "falling back" in w]
    if fallbacks:
        raise AssertionError(f"fallback warnings in the transport phase: "
                             f"{fallbacks}")
    log(f"[transport] done in {time.perf_counter() - t0:.1f} s on {card}; "
        f"warnings {warnings}")
    return st


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
    from starway_tpu_torch.ops.gemv import int8_matmul
    from starway_tpu_torch.ops.quantize import quantize_params

    dev = torch.device("cuda:0")
    t_start = time.perf_counter()

    # 1. build; the backward's register report compiles beside the rest
    ptxas = start_ptxas_report(_build)
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

    # 4 + 5 + 6: the serving paths, counted.
    cfg = LlamaConfig.preset("llama3-8b")  # bf16, 32 layers, full widths
    reqs = make_requests(cfg)
    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    log("[serve] llama3-8b bf16, 32 layers, n_slots=8 max_len=2048 chunk=8, "
        f"{len(reqs)} requests, prompts "
        f"{min(len(r[0]) for r in reqs)}-{max(len(r[0]) for r in reqs)}")
    reset_launch_counts()
    st4, srv4 = serve(params, cfg, reqs)[1:]
    c4 = launch_counts()
    log(f"  {st4}")
    log(f"  launches {c4}")
    if not (c4["decode_attention"] > 0 and c4["flash_forward"] > 0):
        raise AssertionError("the bf16 serving run launched no decode or "
                             "flash kernel")
    admits = traced_admissions(srv4, reqs)
    del srv4
    log(f"  the 12 admissions again, traced: {admits}")
    if admits["device_busy_ms"] is not None:
        if admits["flash_fwd_kernels"] != N_LAYERS * len(reqs):
            raise AssertionError(f"the traced admissions ran "
                                 f"{admits['flash_fwd_kernels']} flash "
                                 f"forward kernels, not {N_LAYERS} a layer "
                                 f"and request")
        log(f"[flash] the forward's device ms over the 12 admissions, "
            f"measured in the trace: {admits['flash_fwd_device_ms']:.4f} ms "
            f"of {admits['device_busy_ms']:.4f} ms busy")
    rows["flash_forward"]["admissions_device_ms"] = admits[
        "flash_fwd_device_ms"]
    check_first_logits(params, cfg, reqs[0][0], 2048)
    torch.cuda.empty_cache()

    st_paged, c_paged = phase_paged(params, cfg)
    torch.cuda.empty_cache()

    cfg8 = LlamaConfig.preset("llama3-8b", kv_quant="int8")
    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log("[int8] int8 KV cache + W8A16 weights, same requests")
    reset_launch_counts()
    st5 = serve(qparams, cfg8, reqs)[1]
    c5 = launch_counts()
    by_regime = dict(int8_matmul.regime_launches)
    main_counts = {k: c4[k] + c_paged[k] + c5[k] for k in c4}
    log(f"  {st5}")
    log(f"  launches {c5}")
    log(f"  int8_matmul launches by regime {by_regime}")
    if st5.get("gemv_device_ms") is not None:
        log(f"  GEMV device ms of the traced chunk (8 decode steps, "
            f"measured): {st5['gemv_device_ms']:.4f}, "
            f"{st5['gemv_device_ms'] / 8:.4f} a decode step")
    if not all(c5[k] > 0 for k in ("decode_attention", "flash_forward",
                                    "int8_matmul")):
        raise AssertionError("the int8 serving run missed a kernel")
    if not (by_regime["decode"] > 0 and by_regime["prefill"] > 0):
        raise AssertionError("the W8A16 run did not launch the GEMV in both "
                             "regimes")
    check_first_logits(qparams, cfg8, reqs[0][0], 2048)
    del qparams
    torch.cuda.empty_cache()

    # 7 + 8. parity: float32, 2 layers, same widths.
    cfg32 = LlamaConfig.preset("llama3-8b", n_layers=2, dtype="float32")
    params32 = init_params(cfg32, SEED + 2, device=dev)
    log("[parity] float32, 2 layers: SlotServer vs generate(), greedy")
    done, st6 = serve(params32, cfg32, reqs)[:2]
    for rid, (prompt, m, _w) in zip(done, reqs):
        want = generate(params32, cfg32, torch.tensor([prompt]), m,
                        max_len=2048)[0, len(prompt):].cpu().numpy()
        if not np.array_equal(done[rid], want):
            raise AssertionError(f"request {rid}: SlotServer {done[rid]} != "
                                 f"generate {want}")
    log(f"  {len(done)} requests token-for-token equal; {st6}")
    log("[paged-parity] float32, 2 layers: PagedSlotServer and prefix "
        "caching vs generate(prefix + suffix), greedy")
    st_pp = phase_paged_parity(params32, cfg32)
    del params32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 9 + 10: the training path, counted, then its parity step.
    st7, c7 = phase_train(dev)
    log(f"  {st7}")
    log(f"  launches {c7}")
    st8 = phase_train_parity(dev)

    # 11 + 12: the training path with ring attention, then its parity.
    st_ring, c_ring = phase_train_ring(dev)
    st_rp = phase_train_ring_parity(dev)

    # 13: the transport's main path on the card.
    st_tr = phase_transport(dev, card)

    regs = finish_ptxas_report(ptxas)
    rows["flash_backward_dkv"]["registers"] = regs["flash_bwd.cu"]
    rows["flash_backward_dq"]["registers"] = regs["flash_bwd.cu"]
    for key, kind in (("flash_forward", "fwd"), ("flash_partial", "partial")):
        rows[key]["registers"] = {k: r for k, r in regs["flash_fwd.cu"].items()
                                  if k.startswith(kind + " ")}
    rows["int8_matmul"]["registers"] = regs["int8_gemv.cu"]
    rows["decode_attention"]["registers"] = regs["decode_attention.cu"]
    rows["paged_decode_attention"]["registers"] = regs["paged_attention.cu"]

    traced = {"serve-bf16": st4, "serve-paged": st_paged, "serve-int8": st5}
    for label, st in traced.items():
        if st.get("attention_device_ms") is not None:
            log(f"[summary] {label}: decode-attention device ms of the traced "
                f"chunk (8 decode steps x 32 layers, measured) "
                f"{st['attention_device_ms']:.4f}, "
                f"{st['attention_device_ms'] / 8:.4f} a step, of "
                f"{st['device_busy_ms']:.4f} ms busy")
    for key, labels in (("decode_attention", ("serve-bf16", "serve-int8")),
                        ("paged_decode_attention", ("serve-paged",))):
        rows[key]["traced_chunk_device_ms"] = {
            label: traced[label].get("attention_device_ms")
            for label in labels}

    # 14. kernels line: launches are the serving paths' (phases 4, 5 and
    # 6) and the training paths' (phases 9 and 11), each counted from 0
    # just before its run and read just after.
    main_counts = {k: main_counts[k] + c7[k] + c_ring[k]
                   for k in main_counts}
    kernels = []
    for key, row in rows.items():
        row = dict(row)
        row["launches"] = main_counts[key]
        kernels.append(row)
    # Only the W8A16 run (phase 6) launches the GEMV; the others' counts
    # of it are 0 and in main_counts.
    kernels[list(rows).index("int8_matmul")]["launches_by_regime"] = by_regime
    steps, admits = 8 * st4["chunks"], len(reqs)  # per serving run
    log(f"[summary] launches per serving step: decode_attention "
        f"{c4['decode_attention'] / steps:g} per decode step, "
        f"flash_attention_fwd {c4['flash_forward'] / admits:g} per "
        f"admission, int8_matmul (W8A16 run) "
        f"{c5['int8_matmul'] / (8 * st5['chunks'] + admits):g} per decode "
        f"step or admission")
    paged_steps = 8 * st_paged["chunks"]
    log(f"[summary] paged run: paged_decode_attention "
        f"{c_paged['paged_decode_attention']} launches = 32 x ({paged_steps} "
        f"decode steps + 12 prefixed admissions); "
        f"{st_paged['tokens_per_s']:.1f} tokens/s, median chunk "
        f"{st_paged['median_chunk_ms']:.1f} ms, idle share "
        f"{st_paged.get('device_idle_share')}, peak pages in use "
        f"{st_paged.get('peak_pages_in_use')}; paged-parity chunk ms "
        f"{st_pp}")
    log(f"[summary] launches per training step (4 layers): "
        f"flash_attention_fwd {c7['flash_forward'] / 6:g}, dK/dV "
        f"{c7['flash_backward_dkv'] / 6:g}, dQ {c7['flash_backward_dq'] / 6:g}")
    log(f"[summary] decode chunks {st4['chunks']} bf16 + {st5['chunks']} "
        f"int8 of 8 steps each, serve wall {st4['wall_s']:.2f} s bf16 / "
        f"{st5['wall_s']:.2f} s int8 (admission {st4['admission_s']:.2f} / "
        f"{st5['admission_s']:.2f} s, paged {st_paged['admission_s']:.2f} s), "
        f"{st4['tokens_per_s']:.1f} / {st5['tokens_per_s']:.1f} tokens/s, "
        f"idle share {st4.get('device_idle_share')} / "
        f"{st5.get('device_idle_share')}; train median step "
        f"{st7['median_step_ms']:.1f} ms, {st7['tokens_per_s']:.0f} tokens/s, "
        f"model FLOP share {st7['model_flop_share']:.4f}; train-parity "
        f"{st8}; total {time.perf_counter() - t_start:.1f} s")
    for name, st in st_ring.items():
        log(f"[summary] train-ring {name}: median step "
            f"{st['median_step_ms']:.1f} ms, {st['tokens_per_s']:.0f} "
            f"tokens/s, model FLOP share {st['model_flop_share']:.4f}, idle "
            f"share {st.get('device_idle_share')}, peak memory "
            f"{st['peak_memory_gb']:.2f} GB, first-step loss gap "
            f"{st.get('first_loss_rel_gap')}, one layer's attention vs flash "
            f"{st.get('attention_block_rel_err')}, launches {st['launches']}")
    log(f"[summary] train-ring-parity {st_rp}")
    log(f"[summary] transport (1 MiB pingpong vs_baseline by transport, "
        f"device<->device / host<->device; {card}): " + ", ".join(
            f"{name} " + " / ".join(
                f"{row['vs_baseline']:.3f}" for row in st_tr[name]["sweep"]
                if row["bytes"] == 1 << 20) for name in TRANSPORTS)
        + f"; headline {st_tr['headline']}")
    print(json.dumps({"kernels": kernels}), flush=True)

    # 15. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
