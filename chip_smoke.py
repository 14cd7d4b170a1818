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
              the decode and flash kernels at phase 18's shapes under a
              limit scaled to the output (ops/attention.py SCALED_TOL):
              the decode kernel on a 4096-slot circular cache with
              clamped positions (bf16, int8 KV), at the windowed verify's
              C = 3, 4, 5 and at beam search's 8 rows; the flash forward
              with the window at S = 6000;
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
              buckets, the rolling admission's M=64, and M=512, 2048),
              device ms a call with the weight cold beside torch.matmul
              on the dequantized weight (and by CUDA events around one
              call), the decode step's q, k, v
              projections as one chain, and the rows' sums over one
              decode step and phase 4's 12 admissions (a model: the
              decode step's is measured in phase 7)
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
6. remote-serve -- phase 4's model served over the transport:
              RemoteSlotServer over a SlotServer (n_slots 8, max_len 2048,
              chunk 8) in this process, listening on tcp; a spawned client
              process (RemoteGenerateSession) sends phase 4's 12 requests
              concurrently and a 13th that it cancels after its first
              chunk.  Every stream ends done with its budget of tokens, the
              cancelled one aborted with its slot free again, the decode
              and flash kernels launch, no failed send or fallback is
              logged; tokens/s over the bridge beside phase 4's, the
              client's time to first token, and how many streams equal
              phase 4's (bf16 slot placement may differ) are logged
7. int8    -- phase 4 again with an int8 KV cache and W8A16 weights; the
              GEMV launches in both regimes (decode and prefill), and its
              device ms in the traced chunk is logged.  Phases 4, 5 and 7
              log admission seconds (wall - the decode chunks) and the
              decode-attention kernels' device ms in the traced chunk
8. parity  -- float32, 2 layers at the same widths: SlotServer's greedy
              tokens equal generate()'s for every request
9. paged-parity -- the same weights: PagedSlotServer without and with a
              registered prefix, and SlotServer with it, give the greedy
              tokens of generate(prefix + suffix)
10. remote-parity -- the same weights behind the bridge, an in-process
              client over tcp: every stream as the client receives it
              equals generate()'s tokens
11. train  -- Trainer + adamw on llama3-8b widths cut to 4 layers (bf16,
              remat "dots"), 6 steps on one [2, 2049] batch: loss per
              step, median step ms, tokens/s, model FLOP share, one step
              traced for the device-busy share and the top kernels
12. train-parity -- float32, 2 layers, [1, 513]: loss and every gradient of
              one step through the kernels against the same step through
              the plain attention; the flash forward and each backward
              pass launch once per layer
13. train-ring -- the Trainer with sequence-parallel ring attention
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
14. train-ring-parity -- float32, 2 layers, [1, 513], sp = 4: ring and
              zigzag through the kernels against the plain attention
15. transport -- Server/Client asend/arecv on CUDA tensors: the 1 MiB
              headline pingpong (starway_tpu_torch/headline.py, host <->
              cuda:0); on each transport (inproc, tcp, sm, native,
              native-sm) a cuda:0 <-> cuda:0 and a host <-> cuda:0
              pingpong at 4 KiB to 64 MiB against the raw copy (and a
              host <-> host one, the engine alone, as a yardstick), the
              chunks staged and placed per send, stream order on both
              sides, overwrite after send, a bf16 payload; a 256 MiB
              one-way send in process and over tcp (these with
              STARWAY_DEVPULL=0: the staged device plane); across
              processes, a cuda:0 <-> cuda:0 pingpong with the server in a
              spawned child at 64 KiB to 64 MiB against the raw copy: the
              CUDA IPC pull on the Python engine ("device" on both sides,
              one IPC pull a message each), the same with the pull off,
              the C++ engine's pull and its staged frames, and the C++
              engine against the Python engine at 1 and 64 MiB; on each
              engine a sender that flushes, closes and exits before the
              receive is posted, and the sender's memory back at its
              baseline after a truncated receive and after a close with
              an unpulled offer; the bench CLI (python -m
              starway_tpu_torch.bench) in loopback over every scenario and
              as a server and a client process, with device payloads, its
              JSON reports logged; a 1 MiB round trip over tcp, staged and
              pulled on the Python engine and pulled on the C++ engine,
              under STARWAY_MONITOR=1 (no protocol violation, the data arm
              witnessed).  Every received tensor must equal what
              was sent, in the same memory, and no fallback or failed
              pull may be logged
16. dp     -- two training ranks, each a spawned process on the card
              (rank 0 a Server with a ServerPort, rank 1 a Client with a
              ClientPort, tcp, the CUDA IPC pull for every leaf): Trainer +
              adamw at llama3-8b widths cut to 2 layers, bf16, remat
              "dots", one [1, 2049] batch a rank from its own seed, 3
              step_dp steps; after every step both ranks' parameters are
              bit-for-bit equal (a checksum of each leaf's bytes), every
              loss is finite, every leaf lands on the card by one IPC pull
              a side, the exchange's memory is released; then float32, 2
              layers, [1, 513], one step, against one in-process step on
              both ranks' averaged gradients (1e-5 of each leaf's largest
              value).  Step ms, the dp_exchange span and its GB/s, the
              grad and apply spans, each rank's peak memory and launches
              are logged.  Then the bf16 run again for 2 steps with both
              ranks on the C++ engine, with the same checks, its
              dp_exchange span beside the Python engine's
17. reshard -- redistribute() sized as users move weights: llama3-8b's
              lm_head [128256, 4096] bf16 (1.05 GB) over 8 slots of
              cuda:0, rows -> columns, via device; then two spawned ranks
              on the card move it rows over 2 -> columns over 2 (263 MB
              each way) via device on the Python engine, via device on
              the C++ engine and via host, and one layer's w1 [4096,
              14336] from replicated on rank 0 to columns over 2.  Every
              destination shard equals its box of the source byte for
              byte; the rounds, tx/rx bytes, IPC pulls and peak staging
              against its bound are checked, and the device memory is
              back at its baseline after each move; wall ms and GB/s
              logged.  No kernel of the port runs here
18. mistral -- Mistral-7B-v0.1 widths (its published config.json through
              config_from_hf), 32 layers, bf16, random HF-named weights
              made on the card from a seed and converted by
              params_from_hf (seconds and peak memory logged; phase 3
              holds the kernels against their plain versions at this
              phase's shapes).  The rolling SlotServer (n_slots 8, rope
              horizon 16384, chunk 8) with 8 requests of 128 tokens,
              prompts 512-9000 cycled:
              every budget met, the cache [32, 8, 8, 4096, 128], the
              9000-token request's first logits against a one-pass
              windowed forward (the flash kernel); aligned rolling
              generate() at B=2, P=6000; generate_speculative with a
              4-layer truncation draft at gamma 3, 4, 5 and
              generate_lookup on a repetitive prompt (P=4600, tokens/s,
              acceptance and tokens equal to generate()'s logged); beam
              search (K=4, B=2, P=512, 32 tokens; the reorder's bytes a
              step); then W8A16 weights with an int8 KV cache serving 2
              requests (prompts 2048 and 4000; 4000 + 128 wraps the int8
              window; untraced), the GEMV in both regimes.  The decode, flash and
              GEMV kernels must launch
19. mistral-parity -- float32, 2 layers, window 4096: the rolling
              SlotServer (prompts 4000, 4500 and 700; 4000 + 160 wraps the
              cache) equals a single-request loop over prefill_rolling +
              rolling decode_step + argmax token for token;
              prefill_rolling's last logits within 1e-3 of max |logit| of
              the one-pass windowed prefill; generate_speculative (gamma 3,
              4), generate_lookup and generate_beam(beams=1) equal
              generate() at P=4500; the four beams' scores within 1e-4
              (relative) of their teacher-forced sums
20. mixtral -- Mixtral-8x7B-v0.1 widths (its published config.json
              through config_from_hf: 8 experts, top-2, SwiGLU, dropless
              at capacity factor 8), cut to 16 of 32 layers (all 32
              would hold 93.4 GB of bf16 weights), random weights from
              init_params on the card.  First 4 layers of random HF-named
              weights converted by params_from_hf (seconds, peak memory,
              the tree against its source), freed; then phase 4's
              SlotServer traffic (n_slots 8, max_len 2048, chunk 8, 12
              requests): every budget met, the decode and flash kernels
              launch, one traced chunk's idle share and the MoE FFN's
              device ms (expert bmm apart from routing, dispatch and
              combine); one request's first logits against the plain
              attention with the routing pinned to the kernel path's
              (the free run's error and routing flips logged); the router's drop fraction (0) and expert load
              on one admission; ragged generate() (B=2, P=1024, 32 new);
              generate_speculative (4-layer truncation draft, gamma 4)
              and generate_lookup at P=1024, 32 new; beam search (K=4,
              B=2, P=512, 16 new); make_sharded_moe over
              make_mesh({"ep": 4}) on cuda:0 against switch_moe on one
              layer at x [1, 2048, 4096] within 2e-2 of max |y|, both
              timed
21. mixtral-parity -- float32, 2 layers at the same widths: SlotServer's
              greedy tokens equal generate()'s for 8 requests; the
              PagedSlotServer with and without a registered prefix and
              the prefixed SlotServer equal generate(prefix + suffix)
              (the paged kernel launches); ragged generate() rows equal
              their solo runs; generate_speculative (gamma 3, 4),
              generate_lookup and generate_beam(beams=1) equal
              generate(); a droppy config (capacity factor 1.25) is
              refused with "dropless"
22. mixtral-train -- Mixtral-8x7B-v0.1 widths trained (2 layers, bf16,
              AdamW), then through make_sharded_moe over {"ep": 4}, then a
              float32 step against the plain attention
23. mesh-train -- llama3-8b widths over dp x tp x sp (ring, zigzag),
              Mixtral widths over dp x ep x tp, ZeRO over 8 fsdp slots and
              Ulysses over sp = 4, each held to the unsharded step
24. tp-serve -- serving over {"tp": 2} against phases 4 and 7, on the
              first 6 of phase 4's requests (bf16's chunk alone traced)
25. pipeline -- the pipeline family, every slot on cuda:0, bf16: llama3-8b
              widths cut to 8 layers, batch [4, 2049]: (a) 1F1B over 4
              stages of 2 layers, 4 microbatches; (b) the same layers
              interleaved, 4 stages x 2 chunks; (c) pp x dp = 2 x 2, 2
              microbatches; (d) pp x ep = 2 x 2 at Mixtral-8x7B widths, 2
              layers, 2 microbatches, routed as the pipeline routed (and
              freely, logged); each held to the unsharded step of the same
              tree and batch (the loss, the loss after one AdamW update in
              the pipeline layout, the worst gradient leaf) at phase 23's
              limits, with its step ms beside the unsharded value_and_grad,
              its peak memory and its flash launches, asserted from the
              schedule (2 forward and 1 backward a layer, microbatch and
              data slot); (e) the forward-only make_pipeline over (a)'s
              stages against the unsharded forward of each microbatch
26. dptp-serve -- serving over {"dp": 2, "tp": 2} in one process against
              phases 4, 7 and 24 (the first 6 of phase 4's requests):
              bf16 and W8A16 + int8 KV at 32 layers, untraced
              (both data groups' first decode logits against the
              unsharded tree's, tokens/s, the weights held and the peak
              memory), then float32
              at 2 layers (the server against generate(), speculative
              decoding on a batch of two)
27. gate     -- python -m starway_tpu_torch.analysis on this checkout, all
              twelve passes, wirefuzz's native leg against the port's
              engine; the seconds of each pass
28. examples -- every twin of examples/ (examples/torch/*.py) on cuda:0 at
              its original's defaults (pingpong and throughput at 256
              MiB), and the transport's scripts (scripts/torch/: the
              session soak, one pair of each bench); each exits 0 with its
              own checks, device_pull arrives "device" by one CUDA IPC
              pull, dp_training's ranks end bit-equal, the serving twins
              launch #1 and #3, serve_hf --quantize int8 #4, and
              spmd_training and pp_training #3, #5 and #6
              (phase_examples says more);
              each one's wall seconds and the transport twins' GB/s
29. mesh-serve -- serving every sharded tree the JAX package serves, in
              one process: the PagedSlotServer over {"tp": 2} on phase 5's
              traffic (bf16, then W8A16; first decode logits against the
              unsharded paged server's, pages in use equal to phase 5's
              after every step, #9 launched 2 slots x 32 layers a step),
              the rolling SlotServer over {"tp": 2} at Mistral-7B widths
              on four of phase 19's requests (one wraps the cache, one
              starts past it), Mixtral-8x7B widths cut to 8 layers
              over {"ep": 2, "tp": 2} (SlotServer and PagedSlotServer, no
              gather along ep, the peak memory beside both trees), and
              float32 at 2 layers: greedy tokens equal to the unsharded
              generate() over dp x ep x tp, dp x tp x sp, fsdp = 4 (the
              fsdp_specs tree, paged) and 3 slots over dp x tp
30. bench-twins -- the twins of scripts/kernel_bench.py and
              collect_baseline.py on cuda:0, each in a process of its
              own: the nine kernels against their plain versions
              (--which check), the bench's matmul, flash_window and
              spec_verify rows at 3 iterations, and the five baseline
              configurations at --quick sizes; each process's wall
              seconds
31. a JSON line of the kernels with their launches on the serving paths
   (phases 4-7, 18-21, 24, 26 and 29), the training paths (phases 11, 13,
   16, 22, 23 and 25) and the in-process twins of examples/ (phase 28),
   phases 18-26, 28 and 29 also apart, and the numbers of phase 3
32. the last line: {"ok": true, "device": {...}}

Exits non-zero, printing no result, without a CUDA device.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

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
# Cached decode attention's routes (ops/decode.py tma_route) and the kernel
# the serving paths run.
DECODE_ROUTES = ("cuda: bf16 decode regime (n_rep * C <= 16 rows) at head "
                 "sizes 64 and 128 TMA + wgmma, split over T past one "
                 "cluster (csrc/decode_tma.cu decode_tma_kernel); other bf16 "
                 "mma.sync (csrc/decode_attention.cu decode_mma_kernel); "
                 "float32 FMA")
# The flash forward's and the ring step's partial's routes (ops/flash.py
# fwd_route) and the kernel the main paths run.
FWD_ROUTES = ("cuda: bf16 at head sizes 64 and 128 wgmma + TMA "
              "(csrc/flash_fwd_wgmma.cu flash_fwd_wgmma_kernel, "
              "flash_partial_wgmma_kernel); bf16 at 16 "
              "and 32 mma.sync (csrc/flash_fwd.cu); float32 FMA")
WGMMA_FWD_KERNEL = "flash_fwd_wgmma_kernel"
# The flash backward's routes (ops/flash.py bwd_route) and the kernels the
# main paths run.
BWD_ROUTES = ("cuda: bf16 at head sizes 64 and 128 wgmma + TMA "
              "(csrc/flash_bwd_wgmma.cu flash_bwd_dkv_wgmma_kernel, "
              "flash_bwd_dq_wgmma_kernel); bf16 at 16 and 32 mma.sync, "
              "float32 FMA (csrc/flash_bwd.cu)")
BWD_WRAPPERS = ("flash_backward_dkv", "flash_backward_dq", "flash_partial_bwd")
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


def assert_bwd_route(counts: dict, wide_bf16: bool, label: str) -> None:
    """One run's backward launches (``counts``, counted from 0) took the
    wgmma kernels (csrc/flash_bwd_wgmma.cu) exactly when the run is bf16 at
    a head size of 64 or 128 (``wide_bf16``, ops/flash.py bwd_route): all
    of them, or none."""
    for name in BWD_WRAPPERS:
        want = counts.get(name, 0) if wide_bf16 else 0
        if counts.get(f"{name}/wgmma", 0) != want:
            raise AssertionError(
                f"{label}: {counts.get(f'{name}/wgmma', 0)} of "
                f"{counts.get(name, 0)} {name} launches on the wgmma "
                f"kernels, not {want}")


def assert_decode_route(counts: dict, label: str) -> None:
    """Every decode_attention launch of a run whose calls are all decode
    steps (bf16 q, n_rep * C <= 16 rows, head size 64 or 128: ops/decode.py
    tma_route) took csrc/decode_tma.cu, and there was at least one."""
    n, tma = counts.get("decode_attention", 0), counts.get(
        "decode_attention/tma", 0)
    if not 0 < n == tma:
        raise AssertionError(f"{label}: {tma} of {n} decode_attention "
                             f"launches on csrc/decode_tma.cu")


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev):
    """Phase 3: every kernel against its plain version; returns the rows of
    the kernels line (launch counts filled in later)."""
    import torch

    from starway_tpu_torch.ops.attention import (SCALED_TOL,
                                                 scaled_tolerance_share)
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
    worst, worst_share = 0.0, 0.0
    limit = (f"{SCALED_TOL[0]:g} |want| + {SCALED_TOL[1]:g} rms of want's "
             f"row")

    def held(label, got, want):
        """got against want: within BF16_TOL and the scaled limit."""
        nonlocal worst, worst_share
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        share = scaled_tolerance_share(got, want)
        worst, worst_share = max(worst, err), max(worst_share, share)
        log(f"decode_attention {label}: max_abs_err {err:.3e} (tol "
            f"{BF16_TOL}), {share:.3f} of the limit {limit} (<= 1)")
        if not (err <= BF16_TOL and share <= 1.0):
            raise AssertionError(f"decode_attention disagrees with its "
                                 f"plain version at {label}")

    tma_before = decode_attention.tma_launches
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
                held(f"C={n_q} int8={quant} window={window}",
                     decode_attention(q, kc, vc, pos, **kw),
                     decode_attention_reference(q, kc, vc, pos, **kw))
                if n_q == 1 and window is None and not quant:
                    plain = cuda_ms(lambda: decode_attention_reference(
                        q, kc, vc, pos, **kw), iters=5)
    del k16, v16, k8, v8, ks, vs
    # The kernel bench's row: one row of 8 q / 2 kv heads over T = 8192 at
    # its last position, split past one cluster (bf16 and int8 caches).
    q, k, v = randn(1, 8, 1, D), randn(1, 2, 8192, D), randn(1, 2, 8192, D)
    held("B=1 Hq=8 Hkv=2 T=8192", decode_attention(q, k, v, 8191),
         decode_attention_reference(q, k, v, 8191))
    plain_b1 = cuda_ms(lambda: decode_attention_reference(q, k, v, 8191),
                       iters=5)
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    held("B=1 Hq=8 Hkv=2 T=8192 int8",
         decode_attention(q, k8, v8, 8191, k_scale=ks, v_scale=vs),
         decode_attention_reference(q, k8, v8, 8191, k_scale=ks, v_scale=vs))
    if decode_attention.tma_launches != tma_before + 10:
        raise AssertionError("phase 3's decode-regime calls did not all take "
                             "csrc/decode_tma.cu")
    del q, k, v, k8, v8, ks, vs
    worst = max(worst, row_tiled_decode(dev, randn))
    regimes = window_regime_rows(dev)
    worst = max([worst] + [r["max_abs_err"]
                           for r in regimes["decode_attention"]])
    paged_err, paged_plain = paged_rows(dev, randn, rng)
    timed = decode_timings(dev)
    b1 = next(r for r in timed["decode_attention"]["shapes"]
              if "Hkv=2" in r["shape"])
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda", kernel="decode_tma_kernel",
        design=DECODE_ROUTES,
        source="starway_tpu_torch/csrc/decode_tma.cu",
        sources_other_regimes="starway_tpu_torch/csrc/decode_attention.cu",
        replaces="starway_tpu/ops/pallas_decode.py:150 "
                 "(_decode_stream_kernel; also :107 _decode_kernel)",
        max_abs_err=worst, tol_share=worst_share, plain_ms=plain,
        bench_shape=dict(shape=b1["shape"], ms=b1["ms"],
                         bound_ms=b1["bound_ms"], plain_ms=plain_b1,
                         library_ms=b1["library_ms"]),
        window_regimes=regimes["decode_attention"],
        **timed["decode_attention"])
    rows["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda", design=MMA_ROUTE,
        source="starway_tpu_torch/csrc/paged_attention.cu",
        replaces="starway_tpu/ops/pallas_paged.py:46 (_paged_stream_kernel)",
        max_abs_err=paged_err, plain_ms=paged_plain,
        **timed["paged_decode_attention"])

    rows["flash_forward"] = flash_forward_rows(dev, randn)
    flash = rows["flash_forward"]
    flash["window_regimes"] = regimes["flash_forward"]
    flash["max_abs_err"] = max([flash["max_abs_err"]] + [
        r["max_abs_err"] for r in regimes["flash_forward"]])

    rows.update(flash_backward_rows(dev, randn))
    rows.update(ring_kernel_rows(dev, randn))
    rows["flash_partial_bwd"]["split_effect"] = split_effect(dev)

    rows["int8_matmul"] = gemv_rows(dev, randn)
    shard = shard_shape_rows(dev, randn)
    rows["paged_decode_attention"]["shard_shape_ms"] = shard.pop(
        "paged_shard_ms")
    for key, share in shard.pop("shares").items():
        rows[key]["shard_shapes_tol_share"] = share
    for key, err in shard.items():
        rows[key]["shard_shapes_max_err"] = err
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def shard_shape_rows(dev, randn) -> dict:
    """Phase 3 at the shapes phases 22-24 give the kernels: llama3-8b's
    heads over tp = 2 (16 q, 4 kv heads) with dp's halved batch, Ulysses'
    8 q and 2 kv heads a slot over the whole S = 4096, the ring step at
    tp's heads, the decode kernel at tp's heads (bf16 and int8 caches, C =
    1 and 4) and the GEMV at tp's widths (gate/up 4096 x 7168, down 7168 x
    4096, wo 2048 x 4096, lm_head 4096 x 64128).  Each against its plain
    version: the attention outputs of #3 and #1 to the limit that scales
    with the output (ops/attention.py SCALED_TOL, as
    :func:`window_regime_rows`: BF16_TOL is the size of a typical output
    at these lengths), #3's lse to 1e-3 as in :func:`flash_forward_rows`,
    the gradients and the GEMV to the tolerances their own rows use;
    returns the worst error of each kernel."""
    import torch

    from starway_tpu_torch.ops.attention import (SCALED_TOL,
                                                 scaled_tolerance_share)
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
    from starway_tpu_torch.ops.quantize import quantize_kv, quantize_weight

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    limit = (f"{SCALED_TOL[0]:g} |want| + {SCALED_TOL[1]:g} rms of want's "
             f"row")
    out = {"shares": {}}
    worst_f = worst_b = worst_fs = 0.0
    for b, hq, hkv, s_len in ((1, 16, 4, 2048), (1, 8, 2, 4096)):
        q, k, v = (randn(b, h, s_len, 128) for h in (hq, hkv, hkv))
        o, lse = flash_forward(q, k, v, causal=True)
        o_r, lse_r = flash_forward_reference(q, k, v, causal=True)
        err = (o.float() - o_r.float()).abs().max().item()
        share = scaled_tolerance_share(o, o_r)
        lse_err = (lse - lse_r).abs().max().item()
        do = randn(b, hq, s_len, 128)
        got = flash_backward(q, k, v, o, lse, do, causal=True)
        want = flash_backward_reference(q, k, v, o, lse, do, causal=True)
        gerr = max(rel(g, w) for g, w in zip(got, want))
        log(f"[shard shapes] flash fwd/bwd q [{b}, {hq}, {s_len}, 128], kv "
            f"{hkv} heads: o max_abs_err {err:.3e}, {share:.3f} of the limit "
            f"{limit} (<= 1), lse {lse_err:.3e} (tol 1e-3); grads rel "
            f"{gerr:.3e} (tol {GRAD_REL_TOL['bfloat16']})")
        if not (share <= 1.0 and lse_err <= 1e-3
                and gerr <= GRAD_REL_TOL["bfloat16"]):
            raise AssertionError("the flash kernels disagree at a shard shape")
        worst_f, worst_b = max(worst_f, err), max(worst_b, gerr)
        worst_fs = max(worst_fs, share)
    out["flash_forward"] = worst_f
    out["flash_backward_dkv"] = out["flash_backward_dq"] = worst_b
    out["shares"]["flash_forward"] = worst_fs

    q, k, v = randn(1, 16, 1024, 128), randn(1, 4, 1024, 128), randn(
        1, 4, 1024, 128)
    worst_p = worst_pb = 0.0
    for q_off, kv_off in ((1024, 0), (1024, 1024)):
        o, m, l = flash_partial(q, k, v, q_off, kv_off, causal=True)
        o_r, m_r, l_r = flash_partial_reference(q, k, v, q_off, kv_off,
                                                causal=True)
        err = max(rel(o / l[..., None].clamp(min=1e-30),
                      o_r / l_r[..., None].clamp(min=1e-30)),
                  (m - m_r).abs().max().item())
        lse = (m + torch.log(l.clamp(min=1e-30))).float()
        do = randn(1, 16, 1024, 128)
        delta = torch.randn(1, 16, 1024, device=dev)
        got = flash_partial_bwd(q, do, k, v, lse, delta, q_off, kv_off)
        want = flash_partial_bwd_reference(q, do, k, v, lse, delta, q_off,
                                           kv_off)
        gerr = max(rel(g, w) for g, w in zip(got, want))
        worst_p, worst_pb = max(worst_p, err), max(worst_pb, gerr)
    log(f"[shard shapes] ring step at tp's heads: partial {worst_p:.3e}, "
        f"its backward rel {worst_pb:.3e} (tol {GRAD_REL_TOL['bfloat16']})")
    if not (worst_p <= GRAD_REL_TOL["bfloat16"]
            and worst_pb <= GRAD_REL_TOL["bfloat16"]):
        raise AssertionError("the ring-step kernels disagree at tp's heads")
    out["flash_partial"], out["flash_partial_bwd"] = worst_p, worst_pb

    B, T = 8, 2048
    k16, v16 = randn(B, 4, T, 128), randn(B, 4, T, 128)
    k8, ks = quantize_kv(k16)
    v8, vs = quantize_kv(v16)
    pos = torch.full((B,), 1500, dtype=torch.int32, device=dev)
    worst_d = worst_ds = 0.0
    for n_q in (1, 4):
        q = randn(B, 16, n_q, 128)
        for kc, vc, kw in ((k16, v16, {}),
                           (k8, v8, dict(k_scale=ks, v_scale=vs))):
            got = decode_attention(q, kc, vc, pos, **kw)
            want = decode_attention_reference(q, kc, vc, pos, **kw)
            err = (got.float() - want.float()).abs().max().item()
            worst_d = max(worst_d, err)
            worst_ds = max(worst_ds, scaled_tolerance_share(got, want))
    log(f"[shard shapes] decode attention at 16 q / 4 kv heads, pos 1500: "
        f"max_abs_err {worst_d:.3e}, {worst_ds:.3f} of the limit {limit} "
        f"(<= 1)")
    if not worst_ds <= 1.0:
        raise AssertionError("decode_attention disagrees at tp's heads")
    out["decode_attention"] = worst_d
    out["shares"]["decode_attention"] = worst_ds

    worst_g = 0.0
    for d, f in ((4096, 7168), (7168, 4096), (2048, 4096), (4096, 64128)):
        w = quantize_weight(randn(d, f) * 0.02)
        for m in (8, 64):
            x = randn(m, d)
            share = tolerance_share(int8_matmul(x, w["q"], w["s"]),
                                    int8_matmul_reference(x, w["q"], w["s"]))
            worst_g = max(worst_g, share)
    log(f"[shard shapes] int8 GEMV at tp's widths, M = 8 and 64: worst "
        f"share of tolerance {worst_g:.3f} (1 passes)")
    if not worst_g <= 1:
        raise AssertionError("the int8 GEMV disagrees at tp's widths")
    out["int8_matmul"] = worst_g
    out["paged_decode_attention"], out["shares"]["paged_decode_attention"], \
        out["paged_shard_ms"] = paged_shard_row(dev, randn, limit)
    return out


def paged_shard_row(dev, randn, limit: str) -> tuple:
    """#9 at the shape phase 29's paged-tp gives it: llama3-8b's heads
    over tp = 2 (16 q, 4 kv heads a slot), bf16, 16 slots, page 64, D =
    128, ragged cursors over a scrambled table whose entries past each
    cursor point outside the pool; against its plain version to the
    limit that scales with the output (ops/attention.py SCALED_TOL).
    Returns the error, its share of the limit and both times (CUDA
    events)."""
    import torch

    from starway_tpu_torch.ops.attention import scaled_tolerance_share
    from starway_tpu_torch.ops.paged import (paged_decode_attention,
                                             paged_decode_attention_reference)

    rng = np.random.default_rng(SEED + 29)
    b, hq, hkv, d, page, max_len = 16, 16, 4, 128, 64, 4096
    max_pages = max_len // page
    pos_np = rng.integers(100, 2001, b).astype(np.int32)
    n_pages = 1 + b * max_pages
    table = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, max_pages)
    for i, last in enumerate(pos_np // page):
        table[i, last + 1:] = 2 ** 30 + i  # never read
    kp, vp = randn(n_pages, hkv, page, d), randn(n_pages, hkv, page, d)
    q = randn(b, hq, 1, d)
    table_d, pos = (torch.from_numpy(a).to(dev) for a in (table, pos_np))
    got = paged_decode_attention(q, kp, vp, table_d, pos)
    want = paged_decode_attention_reference(q, kp, vp, table_d, pos)
    err = (got.float() - want.float()).abs().max().item()
    share = scaled_tolerance_share(got, want)
    ms = dict(kernel_ms=cuda_ms(lambda: paged_decode_attention(
        q, kp, vp, table_d, pos)), plain_ms=cuda_ms(
        lambda: paged_decode_attention_reference(q, kp, vp, table_d, pos),
        iters=5))
    log(f"[shard shapes] paged_decode_attention at 16 q / 4 kv heads, 16 "
        f"slots, page {page}, pos {pos_np.min()}-{pos_np.max()}: max_abs_err "
        f"{err:.3e}, {share:.3f} of the limit {limit} (<= 1); {ms}")
    if not share <= 1.0:
        raise AssertionError("paged_decode_attention disagrees at tp's "
                             "heads")
    del kp, vp
    torch.cuda.empty_cache()
    return err, share, ms


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
        name="flash_attention_fwd", route="cuda", kernel=WGMMA_FWD_KERNEL,
        source="starway_tpu_torch/csrc/flash_fwd_wgmma.cu",
        design=FWD_ROUTES,
        replaces="starway_tpu/ops/pallas_attention.py:124 (_fwd_kernel)",
        max_abs_err=max(r["max_abs_err"] for r in by_shape
                        + list(per_bucket.values())),
        **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "graph_ms",
                                  "library_graph_ms")},
        timed_at=f"B=1 Hq={HQ} Hkv={HKV} D={D} S=2048 causal bf16 "
                 f"({WGMMA_FWD_KERNEL}), by events around one call; "
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
    requests, at the rolling admission's 64-token chunk (phase 18) and at
    M=512 and 2048, the lm_head at M=1 (admission's last
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
                                            int8_matmul, launch_plan,
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
                   else sorted({8, 64, 512, 2048, *buckets}))
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
            plan = launch_plan(m, d, f, n_sms, static=True)
            regime, splits = plan[0], plan[4]
            early = plan[1] == 3
            route = "wgmma" if plan[1] == 4 else "mma.sync"
            rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if b_by == "operations"
                    else f"{n_bytes / ms / 1e6:.1f} GB/s")
            how = f"{regime} on {route}, {splits} splits" + (
                ", early launch" if early else "")
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
                early_launch=early, route=route,
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
    pre = table[(512, 4096, 14336)]
    return dict(
        name="int8_matmul", route="cuda", kernel="gemv_decode_kernel",
        source="starway_tpu_torch/csrc/int8_gemv.cu",
        design="cuda: decode regime (M <= 32) mma.sync "
               "(csrc/int8_gemv.cu gemv_decode_kernel); prefill regime "
               "wgmma + TMA (csrc/w8a16_wgmma.cu w8a16_wgmma_kernel) where "
               "TMA takes the operands, else mma.sync (gemv_prefill_kernel); "
               "float32 FMA",
        replaces="starway_tpu/ops/pallas_gemv.py:32 (_gemv_kernel)",
        max_abs_err=worst, tol_share=worst_excess,
        **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        timed_at="M=8 D=4096 F=14336 bf16 (decode regime), device ms a "
                 "call, weight cold; prefill has the prefill regime's row",
        prefill=dict(
            kernel="w8a16_wgmma_kernel", route="cuda",
            source="starway_tpu_torch/csrc/w8a16_wgmma.cu",
            **{k: pre[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "max_abs_err",
                                    "tol_share", "splits")},
            timed_at="M=512 D=4096 F=14336 bf16 (prefill regime), device "
                     "ms a call, weight cold"),
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


def window_regime_rows(dev) -> dict:
    """The decode and flash kernels at the shapes phase 18 gives them, each
    against its plain version: the decode kernel on the
    rolling server's circular cache (8 slots, W = 4096, positions past the
    window clamped to W - 1, bf16 and int8 KV), at the speculative verify
    of a windowed model (C = 3, 4 and 5: 12 and 16 rows in the decode
    regime, 20 in the ingest regime) and at beam search's 8 rows; the
    flash forward with the window at S = 6000 (its last 512 rows against
    the plain partial).  BF16_TOL is the size of a typical output here
    (~0.026 at T = 4096), so these are held to a limit that scales with
    the output (ops/attention.py SCALED_TOL).  Returns each kernel's
    readings (label, max_abs_err, tol_share)."""
    import torch

    from starway_tpu_torch.ops.attention import (SCALED_TOL,
                                                 finalize_partial,
                                                 partial_attention,
                                                 repeat_kv,
                                                 scaled_tolerance_share)
    from starway_tpu_torch.ops.decode import (decode_attention,
                                              decode_attention_reference,
                                              decode_plan)
    from starway_tpu_torch.ops.flash import flash_forward
    from starway_tpu_torch.ops.quantize import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(SEED + 180)
    out = {"decode_attention": [], "flash_forward": []}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def check(kernel, label, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        share = scaled_tolerance_share(got, want)
        log(f"{kernel} {label}: max_abs_err {err:.3e} (max |want| "
            f"{want.float().abs().max().item():.3e}), {share:.3f} of the "
            f"limit {SCALED_TOL[0]:g} |want| + {SCALED_TOL[1]:g} rms of "
            f"want's row (<= 1)")
        if not share <= 1.0:
            raise AssertionError(f"{kernel} disagrees with its plain version "
                                 f"at {label}")
        out[kernel].append(dict(label=label, max_abs_err=err,
                                tol_share=share))

    W = 4096
    q, k, v = randn(8, 32, 1, 128), randn(8, 8, W, 128), randn(8, 8, W, 128)
    pos = torch.tensor([100, 4095, 4096, 4097, 6000, 9000, 12345, 16000],
                       dtype=torch.int32, device=dev).clamp(max=W - 1)
    check("decode_attention", "rolling cache (T = W = 4096, pos clamped)",
          decode_attention(q, k, v, pos),
          decode_attention_reference(q, k, v, pos))
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    kw = dict(k_scale=ks, v_scale=vs)
    check("decode_attention", "rolling int8 cache",
          decode_attention(q, k8, v8, pos, **kw),
          decode_attention_reference(q, k8, v8, pos, **kw))
    del k, v, k8, v8, ks, vs
    t = SPEC_PROMPT + SPEC_NEW + 6
    k, v = randn(2, 8, t, 128), randn(2, 8, t, 128)
    pos = torch.tensor([SPEC_PROMPT, SPEC_PROMPT + SPEC_NEW - 1],
                       dtype=torch.int32, device=dev)
    for c in (3, 4, 5):
        q = randn(2, 32, c, 128)
        regime = decode_plan(2, 8, 4 * c, t)[0]
        check("decode_attention", f"verify C={c} ({4 * c} rows, {regime} "
              f"regime), window {W}, T={t}",
              decode_attention(q, k, v, pos, window=W),
              decode_attention_reference(q, k, v, pos, window=W))
    t = BEAM["prompt"] + BEAM["new"]
    rows = BEAM["batch"] * BEAM["beams"]
    q, k, v = randn(rows, 32, 1, 128), randn(rows, 8, t, 128), randn(
        rows, 8, t, 128)
    pos = torch.full((rows,), t - 1, dtype=torch.int32, device=dev)
    check("decode_attention", f"beam rows ({rows}, T={t})",
          decode_attention(q, k, v, pos, window=W),
          decode_attention_reference(q, k, v, pos, window=W))
    del q, k, v
    s = 6000
    q, k, v = randn(1, 32, s, 128), randn(1, 8, s, 128), randn(1, 8, s, 128)
    o = flash_forward(q, k, v, causal=True, window=W)[0][:, :, -512:]
    want = finalize_partial(*partial_attention(
        q[:, :, -512:], repeat_kv(k, 4), repeat_kv(v, 4), q_offset=s - 512,
        causal=True, window=W), out_dtype=q.dtype)
    check("flash_forward", f"window {W}, S={s} (last 512 rows)", o, want)
    del q, k, v, o, want
    torch.cuda.empty_cache()
    return out


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

    from starway_tpu_torch.ops import flash as flash_ops
    from starway_tpu_torch.ops.flash import (flash_backward,
                                             flash_backward_delta,
                                             flash_backward_delta_reference,
                                             flash_backward_dkv,
                                             flash_backward_dq,
                                             flash_backward_reference,
                                             flash_forward)
    from starway_tpu_torch.utils.cuda_timing import graph_us, visible_pairs

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
        before = [getattr(flash_ops, n).wgmma_launches for n in BWD_WRAPPERS]
        got = flash_backward(q, k, v, o, lse, do, **kw)
        want = flash_backward_reference(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        wgmma = flash_ops.bwd_route(dt == torch.bfloat16, d) == "wgmma"
        moved = [getattr(flash_ops, n).wgmma_launches - b
                 for n, b in zip(BWD_WRAPPERS, before)]
        if moved != [int(wgmma), int(wgmma), 0]:
            raise AssertionError(f"flash_backward {dt} D={d}: the wgmma "
                                 f"counts moved {moved}, bwd_route says "
                                 f"{wgmma}")
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
        delta = flash_backward_delta(o, do)
        delta_want = flash_backward_delta_reference(o, do)
        torch.cuda.synchronize()
        delta_err = (delta - delta_want).abs().max().item()
        delta_tol = 1e-5 * delta_want.abs().max().item()
        log(f"  flash_backward_delta: max_abs_err {delta_err:.3e} (tol "
            f"{delta_tol:.3e}: float32 sums of {d} products in another "
            f"order)")
        if not delta_err <= delta_tol:
            raise AssertionError("flash_backward_delta disagrees with its "
                                 "plain version")
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
        # Device ms in a CUDA graph: both passes with the delta reduction
        # (flash_backward), and SDPA's backward as its forward and
        # backward captured whole (autograd's backward runs on the
        # capturing stream) less its forward.
        pair_graph = graph_us(lambda _: flash_backward(q, k, v, o, lse, do,
                                                       **kw), [None]) / 1e3
        lib_graph = (graph_us(lambda _: sdpa_fwd_bwd(q, k, v, do, causal),
                              [None])
                     - graph_us(lambda _: F.scaled_dot_product_attention(
                         q, k, v, is_causal=causal, enable_gqa=True),
                         [None])) / 1e3
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
        log(f"  device ms a call in a CUDA graph: flash_backward (delta and "
            f"both passes) {pair_graph:.4f}, SDPA's backward "
            f"{lib_graph:.4f} ({pair_graph / lib_graph:.2f}x)")
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
                   library_ms=lib, graph_ms_with_delta=pair_graph,
                   library_graph_ms=lib_graph, **rates)
        if (b, s_len) == (2, 2048):
            # delta: dO and O read once, delta written once.
            delta_b = bound(2 * es * q.numel() + 4 * b * hq * s_len, 0)
            timed["delta"] = dict(
                max_abs_err=delta_err,
                ms=cuda_ms(lambda: flash_backward_delta(o, do)),
                graph_ms=graph_us(lambda _: flash_backward_delta(o, do),
                                  [None]) / 1e3,
                plain_ms=cuda_ms(lambda: flash_backward_delta_reference(
                    o, do)),
                bound_ms=delta_b[0], bound_by=delta_b[1],
                timed_at=f"B={b} Hq={hq} S={s_len} D={d} bf16; ms by "
                         f"events around one call, graph_ms device ms a "
                         f"call in a CUDA graph")
            log(f"  flash_backward_delta {timed['delta']['ms']:.4f} ms, "
                f"device {timed['delta']['graph_ms']:.4f} ms (bound "
                f"{delta_b[0]:.4f} ms, {delta_b[1]}), plain (float32 "
                f"copies) {timed['delta']['plain_ms']:.4f} ms")
            timed["dkv"] = dict(row, ms=dkv_ms, bound_ms=dkv_b[0],
                                bound_by=dkv_b[1])
            timed["dq"] = dict(row, ms=dq_ms, bound_ms=dq_b[0],
                               bound_by=dq_b[1])
        else:
            timed["long"] = dict(row, dkv_ms=dkv_ms, dq_ms=dq_ms)
        del q, k, v, do, o, lse, got, want, delta
        torch.cuda.empty_cache()
    src = "starway_tpu_torch/csrc/flash_bwd_wgmma.cu"
    return {
        "flash_backward_delta": dict(
            name="flash_attention_bwd_delta", route="cuda",
            kernel="flash_bwd_delta_kernel",
            source="starway_tpu_torch/csrc/flash_bwd.cu",
            replaces="none: the jnp reduction of "
                     "starway_tpu/ops/pallas_attention.py:560 (_bwd_impl's "
                     "delta, an XLA fusion on the TPU)",
            library_ms=None, **timed["delta"]),
        "flash_backward_dkv": dict(
            name="flash_attention_bwd_dkv", route="cuda",
            kernel="flash_bwd_dkv_wgmma_kernel", source=src,
            design=BWD_ROUTES,
            replaces="starway_tpu/ops/pallas_attention.py:309 "
                     "(_bwd_dkv_kernel)",
            max_abs_err=worst["dkv"], **timed["dkv"],
            at_b1_s4096=timed["long"]),
        "flash_backward_dq": dict(
            name="flash_attention_bwd_dq", route="cuda",
            kernel="flash_bwd_dq_wgmma_kernel", source=src,
            design=BWD_ROUTES,
            replaces="starway_tpu/ops/pallas_attention.py:364 "
                     "(_bwd_dq_kernel)",
            max_abs_err=worst["dq"], **timed["dq"])}


def sdpa_fwd_bwd(q, k, v, do, causal: bool):
    """SDPA's forward and backward in one call (the library's backward is
    timed as this less the forward): gradients of q, k, v."""
    import torch
    import torch.nn.functional as F

    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                           enable_gqa=True)
        return torch.autograd.grad(o, leaves, do)


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

    from starway_tpu_torch.ops import flash as flash_ops
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
        before = flash_partial_bwd.wgmma_launches
        g = flash_partial_bwd(q, do, k, v, lse, delta, q_off, kv_off, **kw)
        g_r = flash_partial_bwd_reference(q, do, k, v, lse, delta, q_off,
                                          kv_off, **kw)
        torch.cuda.synchronize()
        if flash_partial_bwd.wgmma_launches != before + 1:
            raise AssertionError(f"flash_partial_bwd ({name}) did not take "
                                 f"the wgmma kernels")
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
            timed["bwd_graph"] = graph_us(
                lambda _: flash_partial_bwd(q, do, k, v, lse, delta, q_off,
                                            kv_off, **kw), [None]) / 1e3
            timed["bwd_lib_graph"] = (
                graph_us(lambda _: sdpa_fwd_bwd(q, k, v, do, False), [None])
                - graph_us(library, [None])) / 1e3
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
        f"{timed['bwd_lib']:.4f} ms; device ms a call in a CUDA graph "
        f"{timed['bwd_graph']:.4f}, SDPA's backward {timed['bwd_lib_graph']:.4f}")
    torch.cuda.empty_cache()
    del full
    at = (f"B=1 Hq={HQ} Hkv={HKV} D={D} T=Tkv={T} bf16, past block (q_off "
          f"1024, kv_off 0); by_offset has every offset, zigzag's half "
          f"shards too")
    src = "starway_tpu_torch/csrc/"
    return {
        "flash_partial": dict(
            name="flash_partial", route="cuda",
            kernel="flash_partial_wgmma_kernel",
            source=src + "flash_fwd_wgmma.cu", design=FWD_ROUTES,
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
            name="flash_partial_bwd", route="cuda",
            kernel="flash_bwd_dkv_wgmma_kernel, flash_bwd_dq_wgmma_kernel",
            source=src + "flash_bwd_wgmma.cu", design=BWD_ROUTES,
            replaces="starway_tpu/ops/pallas_attention.py:734 "
                     "(flash_partial_bwd, through _run_bwd_passes :406)",
            max_abs_err=worst["bwd"], ms=by_case["past"]["bwd_ms"],
            plain_ms=timed["bwd_plain"], bound_ms=timed["bwd_b"][0],
            bound_by=timed["bwd_b"][1], library_ms=timed["bwd_lib"],
            tflops_7=past["bwd_tflops_7"], tflops_5=past["bwd_tflops_5"],
            vs_library=past["bwd_vs_library"], graph_ms=timed["bwd_graph"],
            library_graph_ms=timed["bwd_lib_graph"],
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
    the decode-attention kernels'), and the paged pool's pages in use
    after every step (their peak)."""

    def __init__(self, *args, **kwargs):
        self.chunk_ms, self.traced, self.peak_pages = [], {}, 0
        self.pages_steps = []
        super().__init__(*args, **kwargs)

    def step(self):
        out = super().step()
        if hasattr(self, "pages_in_use"):
            self.pages_steps.append(self.pages_in_use)
        return out

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
        time.  An MoE model's FFN runs inside a ``MOE_RANGE`` range for
        the traced chunk only, so the kernels it launches (the expert
        ``bmm``s and the dispatch and combine around them) are summed
        apart."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from starway_tpu_torch.models import moe
        from starway_tpu_torch.ops.decode_bench import attention_device_ms

        plain_moe = moe.switch_moe

        def ranged_moe(*args, **kw):
            with torch.profiler.record_function(MOE_RANGE):
                return plain_moe(*args, **kw)

        t_call = time.perf_counter()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof, mock.patch.object(
                moe, "switch_moe", ranged_moe):
            t0 = time.perf_counter()
            out = super()._run_chunk()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avgs = prof.key_averages()
        # The range's own device-side span (if the profiler records one)
        # is not a kernel.
        kernels = [e for e in avgs
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key != MOE_RANGE]
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
        if busy_us and self.cfg.n_experts:
            self.traced.update(moe_device_ms(avgs))
        return out


MOE_RANGE = "moe_ffn"  # the profiler range around switch_moe in a trace


def moe_device_ms(avgs) -> dict:
    """The MoE FFN's device ms in a trace: every kernel launched inside
    the ``MOE_RANGE`` ranges, of which the expert ``bmm``s (the FFN's only
    batched products) and the rest (routing, dispatch, combine)."""
    import torch

    def device_ms(key):
        for e in avgs:
            if e.key == key and e.device_type == torch.autograd.DeviceType.CPU:
                return getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0)) / 1e3
        return 0.0

    total, bmm = device_ms(MOE_RANGE), device_ms("aten::bmm")
    return dict(moe_device_ms=total, moe_expert_bmm_device_ms=bmm,
                moe_dispatch_combine_device_ms=total - bmm)


def serve(params, cfg, reqs, *, server=None, prefix=None, n_slots=8,
          max_len=2048, chunk=8, trace=True, **kw):
    """Drive ``server`` (SlotServer by default) over ``reqs`` of (tokens,
    budget, prefixed); with ``prefix`` registered first, a prefixed
    request's tokens are its suffix; ``trace=False`` traces no chunk.
    Returns (finished, stats, server)."""
    import torch

    from starway_tpu_torch.models import SlotServer

    timed = type("Timed", (TimedChunks, server or SlotServer), {})
    srv = timed(params, cfg, n_slots=n_slots, max_len=max_len, chunk=chunk,
                seed=SEED, **kw)
    if not trace:
        srv.traced = {"traced": False}  # TimedChunks traces while it is empty
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
                 chunks=len(chunk_ms) + ("traced_chunk_ms" in traced),
                 median_chunk_ms=statistics.median(chunk_ms),
                 admission_s=wall - decode_s, **traced)
    if traced.get("device_busy_ms"):  # else: not measured (no CUDA events)
        # Against an untraced chunk: tracing slows the host, not the device.
        stats["device_idle_share"] = (
            1 - traced["device_busy_ms"] / stats["median_chunk_ms"])
    if srv.peak_pages:
        stats["peak_pages_in_use"] = srv.peak_pages
    if srv.pages_steps:
        stats["pages_in_use_steps"] = srv.pages_steps
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


def first_logits_inputs(params, prompt, max_len):
    """The prompt right-padded to its admission bucket, the bucket, and
    the position of its last token."""
    import torch

    from starway_tpu_torch.models.serving import _bucket, default_buckets

    dev = params["embed"].device
    pb = _bucket(len(prompt), default_buckets(max_len))
    padded = torch.zeros((1, pb), dtype=torch.long, device=dev)
    padded[0, :len(prompt)] = torch.tensor(prompt, device=dev)
    return padded, pb, torch.tensor([len(prompt) - 1], device=dev)


def check_first_logits(params, cfg, prompt, max_len):
    """First-token logits of one request as admission computes them (the
    flash kernel) against a forward through the plain attention."""
    from starway_tpu_torch.models.generate import prefill
    from starway_tpu_torch.models.llama import forward

    padded, pb, last = first_logits_inputs(params, prompt, max_len)
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
    """Phase 9: float32, 2 layers, full widths.  PagedSlotServer without
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
    """Phase 11: Trainer + adamw, llama3-8b widths cut to 4 layers, bf16,
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
    """Phase 12: one float32 step at llama3-8b widths, 2 layers, through
    the kernels against the same step through the plain attention."""
    import torch

    from starway_tpu_torch.models import LlamaConfig, init_params
    from starway_tpu_torch.models.llama import value_and_grad
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.attention import blockwise_attention

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
    worst = worst_grad_rel_err(grads, want)
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
    """Phase 13: the Trainer with ring attention over make_mesh({"sp": 4})
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
    """Phase 14: one float32 step, llama3-8b widths, 2 layers, [1, 513],
    sp = 4: ring and zigzag through the kernels against the same step
    through the plain attention."""
    import torch

    from starway_tpu_torch.models import (LlamaConfig, init_params,
                                          make_sharded_attn)
    from starway_tpu_torch.models.llama import value_and_grad
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.attention import blockwise_attention
    from starway_tpu_torch.parallel import make_mesh

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
        worst = worst_grad_rel_err(grads, want)
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
                 "decode_attention.cu", "paged_attention.cu",
                 "flash_fwd_wgmma.cu", "w8a16_wgmma.cu", "flash_bwd_wgmma.cu",
                 "decode_tma.cu")


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
    k = re.search(r"flash_bwd_(dkv|dq)_wgmma_kernelILi(\d+)E(\w+?)EEv",
                  mangled)
    if k:
        to = "f32" if k.group(3) == "f" else "bf16"
        return f"{k.group(1)} wgmma {to} D={k.group(2)}"
    k = re.search(r"flash_(fwd|partial)_wgmma_kernelILi(\d+)E", mangled)
    if k:
        return f"{k.group(1)} wgmma bf16 D={k.group(2)} rows=64"
    k = re.search(r"decode_tma_kernelI(13__nv_bfloat16|a)Li(\d+)ELi(\d+)E",
                  mangled)
    if k:
        kv = "int8" if k.group(1) == "a" else "bf16"
        return f"decode tma {kv} KV D={k.group(2)} N={k.group(3)}"
    k = re.search(r"w8a16_wgmma_kernelILi(\d+)E", mangled)
    if k:
        return f"gemv prefill wgmma {k.group(1)}x256"
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
        for line in text.splitlines():  # e.g. wgmma serialized (C75xx)
            if "warning" in line.lower():
                log(f"[registers] {src}: {line.strip()}")
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
# The cross-process sweep: from 64 KiB (STARWAY_DEVPULL_MIN, the pull's
# threshold) to 64 MiB.
CROSS_SIZES = [64 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20]
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
    cuda:0 -> cuda:0 send of ``nbytes``.  In process a send to a posted
    receive is one copy on the card, straight into the sink: neither is
    counted (``inproc_copies`` counts it).  The C++ engine stages and
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


@contextlib.contextmanager
def inproc_copies():
    """Counts, while inside, the device plane's copies (``device._copy``)
    and the snapshots of device payloads (``DevicePayload.snapshot``)."""
    from starway_tpu_torch import device

    counts = {"copies": 0, "snapshots": 0}
    copy, snapshot = device._copy, device.DevicePayload.snapshot

    def counted_copy(*args):
        counts["copies"] += 1
        return copy(*args)

    def counted_snapshot(self):
        counts["snapshots"] += 1
        return snapshot(self)

    with mock.patch.object(device, "_copy", counted_copy), \
            mock.patch.object(device.DevicePayload, "snapshot",
                              counted_snapshot):
        yield counts


def check_copies(name: str, what: str, counts: dict, want: tuple) -> None:
    got = (counts["copies"], counts["snapshots"])
    if got != want:
        raise AssertionError(f"{name} {what}: copies/snapshots {got}, "
                             f"expected {want}")


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
    inproc = name == "inproc"
    try:
        trips = 0
        with inproc_copies() as sweep_counts:
            for nbytes in SWEEP_SIZES:
                warm, iters = sweep_iters(nbytes)
                for host in (False, True):
                    fw, raw = await headline.pingpong(
                        server, client, ep, nbytes, dev, dev, host, warm,
                        iters, seed=nbytes)
                    trips += warm + iters + 1  # and the checked pass
                    row = headline.summary(fw, raw, nbytes)
                    row["mode"] = ("host<->device" if host
                                   else "device<->device")
                    out["sweep"].append(row)
                # host buffers both ways: no copy of the device plane
                rtts = await host_pingpong(server, client, ep, nbytes, warm,
                                           iters)
                out.setdefault("host_p50_us", {})[nbytes] = (
                    statistics.median(rtts) * 1e6)
        if inproc:
            # every receive of the sweep is posted before its send: one
            # copy each way, straight into the receive, and no snapshot
            check_copies(name, "sweep", sweep_counts, (2 * trips, 0))
            out["copies"] = {"round_trips": trips, **sweep_counts}

        # chunk counts: one cuda:0 -> cuda:0 send per size
        counts = {}
        for nbytes in (64 << 10, 1 << 20, 16 << 20, 64 << 20):
            src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                                device=dev)
            sink = DeviceBuffer((nbytes,), torch.uint8, device=dev)
            client._client.stage_scope.reset()
            server._server.stage_scope.reset()
            with inproc_copies() as one_counts:
                await one_way(client, server, src, sink, 0x61)
            if inproc:
                check_copies(name, f"{nbytes} B posted", one_counts, (1, 0))
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
            with inproc_copies() as park_counts:
                await client.asend(src, 0x63)
                src.zero_()
                sink = DeviceBuffer((nbytes,), torch.uint8, device=dev)
                got = await server.arecv(sink, 0x63, MASK)
            if inproc:  # it parks: snapshotted, then copied from the clone
                check_copies(name, f"{nbytes} B parked", park_counts, (2, 1))
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


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def echo_server_child(port: int, native: str, devpull: str, device: str,
                      plan: list, result) -> None:
    """Spawned child: a Server over tcp on the engine ``native`` asks for,
    the pull on or off (``devpull``), that receives each size of ``plan``
    (a list of (nbytes, passes)) ``passes`` times into one DeviceBuffer on
    ``device`` and sends each back from it; reports whether every receive
    kept its (tag, length) and memory, how the receives landed, and its
    pull counts."""
    import asyncio
    import os

    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_NATIVE"] = native
    os.environ["STARWAY_DEVPULL"] = devpull

    async def serve():
        import torch

        from starway_tpu_torch import DeviceBuffer, Server

        server = Server()
        server.listen("127.0.0.1", port)
        for _ in range(4000):
            if server.list_clients():
                break
            await asyncio.sleep(0.005)
        ep = server.list_clients().pop()
        ok, seen = True, set()
        for nbytes, passes in plan:
            sink = DeviceBuffer((nbytes,), torch.uint8, device=device)
            ptr = sink.array.data_ptr()
            for _ in range(passes):
                got = await server.arecv(sink, 0x81, MASK)
                await server.asend(ep, sink, 0x82)
                ok = ok and tuple(got) == (0x81, nbytes)
            ok = ok and sink.array.data_ptr() == ptr
            seen.add(sink.last_transport)
        await server.aflush()
        mgr = server._server.transfer_manager()
        counts = dict(mgr.counts) if mgr is not None else {}
        stages = server._server.stage_scope.snapshot()
        await server.aclose()
        return {"ok": ok, "transports": sorted(seen), "counts": counts,
                "stages": stages}

    result.put(asyncio.run(serve()))


async def cross_process(native: str, dev, sizes, devpull: str,
                        child_native: str = None) -> dict:
    """Pingpongs of each of ``sizes`` with the echo server in a spawned
    child on the same card, over tcp, interleaved pass by pass with the
    raw copy there and back on the card; this side on the engine
    ``native`` asks for, the child on ``child_native`` (default the
    same).  With the pull on, either engine moves each direction by a
    CUDA IPC pull (checked: "device" on both sides, one IPC pull a
    message on each); otherwise staged frames."""
    import asyncio
    import multiprocessing as mp
    import os

    import torch

    from starway_tpu_torch import Client, DeviceBuffer, headline

    use_transport("native" if native == "1" else "tcp")
    os.environ["STARWAY_DEVPULL"] = devpull
    child_native = native if child_native is None else child_native
    pulled = devpull == "1"
    want = "device" if pulled else "staged"
    plan = [(n, sum(sweep_iters(n))) for n in sizes]
    port = free_port()
    ctx = mp.get_context("spawn")
    result = ctx.Queue()
    child = ctx.Process(target=echo_server_child,
                        args=(port, child_native, devpull, str(dev), plan,
                              result))
    child.start()
    rows = []
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
        for nbytes, passes in plan:
            warm = sweep_iters(nbytes)[0]
            src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                                device=dev)
            ret = DeviceBuffer((nbytes,), torch.uint8, device=dev)
            fw, raw = [], []
            for i in range(passes):
                ret.array.zero_()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fut = client.arecv(ret, 0x82, MASK)
                await client.asend(src, 0x81)
                got = await fut
                fw_dt = time.perf_counter() - t0
                t0 = time.perf_counter()
                there = src.to(dev, copy=True)
                torch.cuda.synchronize()
                there.to(dev, copy=True)
                torch.cuda.synchronize()
                if i >= warm:
                    fw.append(fw_dt)
                    raw.append(time.perf_counter() - t0)
            if tuple(got) != (0x82, nbytes) or not torch.equal(ret.array,
                                                              src):
                raise AssertionError(f"cross-process {nbytes} B: bytes "
                                     f"differ")
            if ret.last_transport != want:
                raise AssertionError(f"cross-process {nbytes} B: landed "
                                     f"{ret.last_transport!r}, not {want!r}")
            rows.append(headline.summary(fw, raw, nbytes))
        mgr = client._client.transfer_manager()
        counts = dict(mgr.counts) if mgr is not None else {}
        stages = client._client.stage_scope.snapshot()
        # The child flushes its last echo and closes first: a flush that
        # met this side already closed would fail in the child.
        echo = await asyncio.get_running_loop().run_in_executor(
            None, lambda: result.get(timeout=120))
        await client.aclose()
        child.join(60)
    finally:
        if child.is_alive():
            child.kill()
            child.join()
    total = sum(p for _, p in plan)
    if not echo["ok"] or echo["transports"] != [want]:
        raise AssertionError(f"the echo server's checks failed: {echo}")
    if pulled and not (counts.get("pulled_ipc") == total
                       and echo["counts"].get("pulled_ipc") == total):
        raise AssertionError(f"expected {total} IPC pulls each side, got "
                             f"{counts} here and {echo['counts']} there")
    return {"rows": rows, "counts": counts, "echo_counts": echo["counts"],
            "stages": stages, "echo_stages": echo["stages"]}


def devpull_peer_child(port: int, mode: str, q, native: str = "0") -> None:
    """Spawned peer on cuda:0 over tcp, on the engine ``native`` asks
    for, for the pull's lifecycle checks: ``flush-close`` connects, sends
    16 MiB, flushes, closes and exits; ``truncate`` listens and posts a
    too-small receive (which must fail "truncated"); ``idle`` listens and
    receives nothing; both listeners close on a one-byte bye (tag
    0xC9)."""
    import asyncio
    import os

    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_NATIVE"] = native
    os.environ["STARWAY_DEVPULL"] = "1"

    async def run():
        import torch

        from starway_tpu_torch import Client, Server

        if mode == "flush-close":
            for _ in range(240):
                client = Client()
                try:
                    await client.aconnect("127.0.0.1", port)
                    break
                except Exception:
                    await asyncio.sleep(0.25)
            src = torch.arange(16 << 20, dtype=torch.int32,
                               device="cuda:0").to(torch.uint8)
            await client.asend(src, 0xB1)
            src.zero_()
            await client.aflush()
            await client.aclose()
            return "ok"
        server = Server()
        server.listen("127.0.0.1", port)
        q.put("listening")
        for _ in range(4000):
            if server.list_clients():
                break
            await asyncio.sleep(0.005)
        if mode == "truncate":
            try:
                await server.arecv(np.zeros(1024, dtype=np.uint8), 0xC1, MASK)
                q.put("the too-small receive succeeded")
            except Exception as e:  # noqa: BLE001
                q.put("ok" if "runcat" in str(e) else str(e))
        await server.arecv(np.zeros(1, dtype=np.uint8), 0xC9, MASK)
        await server.aclose()
        return "closed"

    q.put(asyncio.run(run()))


async def devpull_lifecycle(dev, native: str = "0") -> dict:
    """The pull's lifecycle across processes on the card, this side and
    its peer on the engine ``native`` asks for: a sender that flushes,
    closes and exits before the receive is posted still delivers; after a
    truncated receive (a drain pull) and after a close with an unpulled
    offer (revoked), the sender's allocated memory is back at its
    baseline once ipc_collect() has run.  The idle peer is always the
    Python engine, which pulls when a receive claims the descriptor: the
    C++ engine pulls every descriptor as it arrives, so an offer to it is
    never left unpulled."""
    import asyncio
    import multiprocessing as mp
    import os

    import torch

    from starway_tpu_torch import Client, DeviceBuffer, Server

    use_transport("native" if native == "1" else "tcp")
    os.environ["STARWAY_DEVPULL"] = "1"
    ctx = mp.get_context("spawn")
    loop = asyncio.get_running_loop()
    out = {}

    def spawn(port, mode):
        q = ctx.Queue()
        peer = "0" if mode == "idle" else native
        p = ctx.Process(target=devpull_peer_child,
                        args=(port, mode, q, peer))
        p.start()
        return p, q

    # flush, close and exit before the receive
    port = free_port()
    server = Server()
    server.listen("127.0.0.1", port)
    p, q = spawn(port, "flush-close")
    try:
        if await loop.run_in_executor(None, lambda: q.get(timeout=120)) != "ok":
            raise AssertionError("the flush-close sender failed")
        await loop.run_in_executor(None, p.join, 60)
        sink = DeviceBuffer((16 << 20,), torch.uint8, device=dev)
        got = await asyncio.wait_for(server.arecv(sink, 0xB1, MASK), 30)
        want = torch.arange(16 << 20, dtype=torch.int32,
                            device=dev).to(torch.uint8)
        if (tuple(got) != (0xB1, 16 << 20) or not torch.equal(sink.array, want)
                or sink.last_transport != "device" or p.exitcode != 0):
            raise AssertionError(f"flush-close-exit: {got}, "
                                 f"{sink.last_transport}, exit {p.exitcode}")
        out["flush_close_exit"] = "delivered by the pull"
    finally:
        await server.aclose()
        if p.is_alive():
            p.kill()
        p.join()

    # the sender's memory after a drain pull and after a revoked offer
    for mode in ("truncate", "idle"):
        port = free_port()
        p, q = spawn(port, mode)
        try:
            if await loop.run_in_executor(None, lambda: q.get(timeout=120)) \
                    != "listening":
                raise AssertionError(f"{mode}: the peer did not listen")
            for _ in range(240):
                client = Client()
                try:
                    await client.aconnect("127.0.0.1", port)
                    break
                except Exception:
                    await asyncio.sleep(0.25)
            src = torch.randint(0, 256, (16 << 20,), dtype=torch.uint8,
                                device=dev)
            gc.collect()
            torch.cuda.ipc_collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            await client.asend(src, 0xC1)
            held = torch.cuda.memory_allocated(dev) - base
            if mode == "truncate":
                await asyncio.wait_for(client.aflush(), 60)
                verdict = await loop.run_in_executor(
                    None, lambda: q.get(timeout=60))
                if verdict != "ok":
                    raise AssertionError(f"truncate: {verdict}")
            # no flush after the bye: a barrier would pull the idle offer
            await client.asend(np.ones(1, dtype=np.uint8), 0xC9)
            await asyncio.sleep(0.2)
            await client.aclose()
            gc.collect()
            torch.cuda.ipc_collect()
            after = torch.cuda.memory_allocated(dev) - base
            if after > 0:
                raise AssertionError(f"{mode}: the sender holds {after} B "
                                     f"past its baseline after ipc_collect")
            out[f"memory_{mode}"] = {"held_after_send": held,
                                     "after_ipc_collect": after}
            await loop.run_in_executor(None, p.join, 60)
        finally:
            if p.is_alive():
                p.kill()
            p.join()
    return out


def bench_cli_runs() -> dict:
    """The bench CLI on the card: every scenario in loopback with device
    payloads over tcp (two workers of one process: the pull's local
    route), and large-array plus streaming-duplex between a server and a
    client process (the CUDA IPC route); returns their JSON reports."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    folder = root / "build" / "bench_reports"
    folder.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("STARWAY_")}
    cli = [sys.executable, "-m", "starway_tpu_torch.bench", "--tls", "tcp"]
    sizes = ["--large-bytes", "64M", "--large-iterations", "3",
             "--stream-iterations", "16", "--stream-warmup", "2",
             "--striped-iterations", "4", "--reshard-bytes", "64M",
             "--flag-iterations", "200", "--flag-warmup", "20"]
    reports = {}

    def check(proc, what):
        text = proc.stdout + proc.stderr
        if proc.returncode != 0 or "falling back" in text:
            raise AssertionError(f"bench {what}: exit {proc.returncode}\n"
                                 f"{text[-3000:]}")

    path = folder / "loopback.json"
    proc = subprocess.run(
        cli + ["--role", "loopback", "--payload", "device", "--port",
               str(free_port()), "--output", str(path)] + sizes,
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    check(proc, "loopback")
    reports["loopback"] = json.loads(path.read_text())

    port = str(free_port())
    server = subprocess.Popen(
        cli + ["--role", "server", "--addr", "127.0.0.1", "--port", port],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        path = folder / "two-process.json"
        for _ in range(60):  # the client connects once: wait for the port
            proc = subprocess.run(
                cli + ["--role", "client", "--port", port, "--payload",
                       "device", "--scenarios", "large-array",
                       "streaming-duplex", "--output", str(path)] + sizes,
                cwd=root, env=env, capture_output=True, text=True,
                timeout=300)
            if proc.returncode == 0 or "onnect" not in proc.stderr:
                break
            time.sleep(0.5)
        check(proc, "client")
        server_out = server.communicate(timeout=120)[0]
        if server.returncode != 0 or "falling back" in server_out:
            raise AssertionError(f"bench server: exit {server.returncode}\n"
                                 f"{server_out[-3000:]}")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    reports["two-process"] = json.loads(path.read_text())
    return reports


def phase_transport(dev, card: str) -> dict:
    """The transport phase: the headline, the sweep and checks on every
    transport (the staged device plane), the 256 MiB throughput, the
    cross-process pingpong on both engines, the cross-process sweep (the
    CUDA IPC pull against staged frames and the C++ engine), the pull's
    lifecycle, a round trip under the protocol monitor and the bench CLI;
    fails if a check fails or a fallback warning or a failed pull was
    logged."""
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
    saved = {k: os.environ.get(k) for k in ("STARWAY_TLS", "STARWAY_NATIVE",
                                             "STARWAY_DEVPULL")}
    t0 = time.perf_counter()
    try:
        use_transport("inproc")
        head = asyncio.run(headline.run())
        if head["fallback"]:
            raise AssertionError("the headline fell back to the CPU")
        log(f"[transport] headline {json.dumps(head)}")
        st = {"headline": {k: head[k] for k in ("value", "vs_baseline")}}
        # The staged device plane: two workers of one process over tcp
        # would otherwise take the pull's local route.
        os.environ["STARWAY_DEVPULL"] = "0"
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
            if "copies" in res:
                log(f"[transport] {name} sweep copies {res['copies']} (two "
                    f"a round trip, no snapshot, expected and held)")
            log(f"[transport] {name} chunks staged/placed {res['chunks']}; "
                f"stages {res['stages']}")
        for name in ("inproc", "tcp"):
            st[f"throughput-{name}"] = asyncio.run(throughput(name, dev))
            log(f"[transport] 256 MiB one way {name}: "
                f"{st[f'throughput-{name}']}")
        # Across processes: the pull (CUDA IPC) on the Python engine, the
        # same with STARWAY_DEVPULL=0 (staged) as its yardstick, the C++
        # engine's pull and its staged frames, at the sweep's sizes from
        # 64 KiB; and the C++ engine here against the Python engine in the
        # child, pulled, at 1 MiB and 64 MiB.
        for label, native_flag, pull, child, sizes in (
                ("ipc", "0", "1", None, CROSS_SIZES),
                ("staged", "0", "0", None, CROSS_SIZES),
                ("native", "1", "1", None, CROSS_SIZES),
                ("native-staged", "1", "0", None, CROSS_SIZES),
                ("native-py", "1", "1", "0", [1 << 20, 64 << 20])):
            res = asyncio.run(cross_process(native_flag, dev, sizes, pull,
                                            child))
            st[f"cross-process-{label}"] = res
            for row in res["rows"]:
                log(f"[transport] cross-process {label:13s} device<->device "
                    f"{row['bytes']:>9d} B  fw p50 {row['fw_p50_us']:9.1f} "
                    f"us p99 {row['fw_p99_us']:9.1f} us  raw p50 "
                    f"{row['raw_p50_us']:8.1f} us  {row['fw_gbps']:7.3f} "
                    f"GB/s  vs_baseline {row['vs_baseline']:.4f}")
            log(f"[transport] cross-process {label}: pulls here "
                f"{res['counts']}, in the child {res['echo_counts']}; "
                f"stages here {res['stages']}, in the child "
                f"{res['echo_stages']}")
        st["devpull-lifecycle"] = asyncio.run(devpull_lifecycle(dev))
        log(f"[transport] pull lifecycle {st['devpull-lifecycle']}")
        st["devpull-lifecycle-native"] = asyncio.run(
            devpull_lifecycle(dev, "1"))
        log(f"[transport] pull lifecycle, C++ engine "
            f"{st['devpull-lifecycle-native']}")
        st["monitor"] = monitor_check(dev)
        t_bench = time.perf_counter()
        reports = bench_cli_runs()
        for name, report in reports.items():
            log(f"[bench] {name} report {json.dumps(report)}")
        st["bench"] = {name: [r["name"] for r in report["scenarios"]]
                       for name, report in reports.items()}
        log(f"[bench] CLI runs took {time.perf_counter() - t_bench:.1f} s")
    finally:
        port_logger.removeHandler(catch)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fallbacks = [w for w in warnings
                 if "falling back" in w or "pull failed" in w]
    if fallbacks:
        raise AssertionError(f"fallback or failed-pull warnings in the "
                             f"transport phase: {fallbacks}")
    log(f"[transport] done in {time.perf_counter() - t0:.1f} s on {card}; "
        f"warnings {warnings}")
    return st


# ------------------------------------------------ the model over the transport


@contextlib.contextmanager
def port_warnings():
    """Collects the WARNING and ERROR messages of the port's loggers (the
    transport's and remote serving's) while inside."""
    import logging

    records = []

    class Handler(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                records.append(record.getMessage())

    handler = Handler()
    loggers = [logging.getLogger(name)
               for name in ("starway_tpu_torch", "starway.serve_remote")]
    for lg in loggers:
        lg.addHandler(handler)
    try:
        yield records
    finally:
        for lg in loggers:
            lg.removeHandler(handler)


def failures(records) -> list:
    """The failed sends and fallbacks among logged warnings."""
    return [w for w in records if "fail" in w or "falling back" in w]


def cancel_request(cfg):
    """The remote-serve phase's 13th request, cancelled after its first
    chunk: a 300-token prompt with a budget of 64."""
    rng = np.random.default_rng(SEED + 11)
    return rng.integers(1, cfg.vocab_size, 300).tolist(), 64


def remote_client_child(port: int, reqs: list, doomed, q, close_ok) -> None:
    """Spawned client of the remote-serve phase (imports only the port):
    one RemoteGenerateSession over tcp sends every request of ``reqs``
    ((tokens, budget) pairs) and ``doomed`` concurrently, cancels
    ``doomed`` after its first chunk, and reports each stream's tokens and
    time to first token, the wall time of the 12, and how the cancelled
    stream ended; it closes its session once ``close_ok`` is set."""
    import asyncio
    import os

    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_NATIVE"] = "0"

    async def run():
        from starway_tpu_torch.models.remote_serving import \
            RemoteGenerateSession

        session = None
        for _ in range(240):  # connect-once clients: a fresh one a try
            try:
                session = await RemoteGenerateSession.aconnect("127.0.0.1",
                                                               port)
                break
            except Exception:  # noqa: BLE001
                await asyncio.sleep(0.25)
        if session is None:
            raise RuntimeError("could not reach the serving process")
        t0 = time.perf_counter()
        ttft = {}

        async def one(i, prompt, budget):
            sent = time.perf_counter()

            def first(_chunk):
                ttft.setdefault(i, time.perf_counter() - sent)

            toks = await session.generate(prompt, budget, on_tokens=first)
            return toks.tolist(), time.perf_counter() - t0

        async def cancelled(prompt, budget):
            handle = RemoteGenerateSession.Handle()
            got, first = [], asyncio.Event()

            def chunk(c):
                got.extend(c)
                first.set()

            task = asyncio.create_task(session.generate(
                prompt, budget, handle=handle, on_tokens=chunk))
            await first.wait()
            await session.cancel(handle)
            try:
                await task
                return {"status": 1, "tokens": len(got)}
            except ValueError as e:
                return {"status": 2 if "cancelled" in str(e) else str(e),
                        "tokens": len(got), "budget": budget}

        try:
            *streams, doomed_out = await asyncio.gather(
                *(one(i, p, m) for i, (p, m) in enumerate(reqs)),
                cancelled(*doomed))
            q.put({"streams": [s[0] for s in streams],
                   "wall_s": max(s[1] for s in streams),
                   "ttft_s": [ttft.get(i) for i in range(len(reqs))],
                   "cancelled": doomed_out})
        finally:
            await asyncio.get_running_loop().run_in_executor(
                None, close_ok.wait, 300)
            await session.aclose()

    try:
        asyncio.run(run())
    except Exception as e:  # noqa: BLE001 - the parent reports it
        q.put(f"client failed: {e!r}")


async def serve_remote(params, cfg, client, *, n_slots=8, max_len=2048,
                       chunk=8) -> tuple:
    """A RemoteSlotServer over a SlotServer on ``params``, listening on tcp
    127.0.0.1, until ``client(port)`` -- a coroutine function of the port
    returning ``(result, close)`` -- returns; ``close()`` (a coroutine
    function) runs once the bridge has served and flushed everything, so
    the client stays connected until its final chunks are delivered.
    Returns (result, the SlotServer, serve seconds)."""
    import asyncio

    from starway_tpu_torch.models import SlotServer
    from starway_tpu_torch.models.remote_serving import RemoteSlotServer

    port = free_port()
    slot = SlotServer(params, cfg, n_slots=n_slots, max_len=max_len,
                      chunk=chunk, seed=SEED)
    bridge = RemoteSlotServer(slot)
    bridge.server.listen("127.0.0.1", port)
    serve_task = asyncio.get_running_loop().create_task(bridge.serve())
    t0 = time.perf_counter()
    close = None
    try:
        result, close = await client(port)
    finally:
        bridge.stop()
        await serve_task
        serve_s = time.perf_counter() - t0
        if close is not None:
            await close()
        await bridge.aclose()
    return result, slot, serve_s


def phase_remote_serve(params, cfg, reqs, done4, st4, card) -> tuple:
    """Phase 6: phase 4's model served over the transport.  A
    RemoteSlotServer over a SlotServer (n_slots 8, max_len 2048, chunk 8)
    in this process, on tcp; a spawned client process sends phase 4's 12
    requests and a 13th, cancelled after its first chunk.  Returns
    (stats, launches)."""
    import asyncio
    import multiprocessing as mp
    import os

    from starway_tpu_torch.ops import launch_counts, reset_launch_counts

    doomed = cancel_request(cfg)
    wire_reqs = [(p, m) for p, m, _w in reqs]
    log(f"[remote-serve] RemoteSlotServer over SlotServer (n_slots=8 "
        f"max_len=2048 chunk=8) on tcp 127.0.0.1, Python engine; a spawned "
        f"client sends phase 4's {len(reqs)} requests and a 13th "
        f"({len(doomed[0])} tokens, budget {doomed[1]}) cancelled after its "
        f"first chunk")
    ctx = mp.get_context("spawn")
    q, close_ok = ctx.Queue(), ctx.Event()

    async def client(port):
        child = ctx.Process(target=remote_client_child,
                            args=(port, wire_reqs, doomed, q, close_ok))
        child.start()

        async def close():
            close_ok.set()
            await asyncio.get_running_loop().run_in_executor(
                None, child.join, 60)
            if child.is_alive():
                child.terminate()

        try:
            res = await asyncio.get_running_loop().run_in_executor(
                None, q.get, True, 900)
        except BaseException:
            await close()
            raise
        return res, close

    with mock.patch.dict(os.environ, STARWAY_TLS="tcp", STARWAY_NATIVE="0"), \
            port_warnings() as caught:
        reset_launch_counts()
        res, slot, serve_s = asyncio.run(serve_remote(params, cfg, client))
        counts = launch_counts()
    if isinstance(res, str):
        raise AssertionError(res)
    if slot.busy or slot._slot_rid:
        raise AssertionError(f"slots still held after the run: "
                             f"{slot._slot_rid}")
    for i, ((_p, m), toks) in enumerate(zip(wire_reqs, res["streams"])):
        if len(toks) != m:
            raise AssertionError(f"remote stream {i}: {len(toks)} tokens, "
                                 f"budget {m}")
    gone = res["cancelled"]
    if gone["status"] != 2 or gone["tokens"] >= doomed[1]:
        raise AssertionError(f"the cancelled stream ended as {gone}")
    if failures(caught):
        raise AssertionError(f"failed sends or fallbacks logged: "
                             f"{failures(caught)}")
    n_tok = sum(m for _p, m in wire_reqs)
    same = sum(np.array_equal(np.asarray(t), np.asarray(want))
               for t, want in zip(res["streams"], done4))
    ttft = sorted(t for t in res["ttft_s"] if t is not None)
    stats = dict(tokens=n_tok, client_wall_s=res["wall_s"],
                 tokens_per_s=n_tok / res["wall_s"],
                 in_process_tokens_per_s=st4["tokens_per_s"],
                 ttft_p50_s=statistics.median(ttft), ttft_max_s=ttft[-1],
                 streams_equal_to_phase4=f"{same} of {len(wire_reqs)}",
                 cancelled=gone, serve_s=serve_s, warnings=caught)
    log(f"[remote-serve] {stats} ({card})")
    return stats, counts


def phase_remote_parity(params32, cfg32, reqs, wants) -> dict:
    """Phase 10: the bridge at phase 8's float32 configuration, with an
    in-process client over tcp: every request's greedy tokens, as the
    client receives them, equal generate()'s (``wants``)."""
    import asyncio
    import os

    from starway_tpu_torch.models.remote_serving import RemoteGenerateSession

    async def client(port):
        session = await RemoteGenerateSession.aconnect("127.0.0.1", port)
        try:
            outs = await asyncio.gather(*(session.generate(p, m)
                                          for p, m, _w in reqs))
        except BaseException:
            await session.aclose()
            raise
        return outs, session.aclose

    with mock.patch.dict(os.environ, STARWAY_TLS="tcp", STARWAY_NATIVE="0"), \
            port_warnings() as caught:
        outs, _slot, serve_s = asyncio.run(serve_remote(params32, cfg32,
                                                        client))
    for i, (got, want) in enumerate(zip(outs, wants)):
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            raise AssertionError(f"remote request {i}: {got} != generate "
                                 f"{want}")
    if failures(caught):
        raise AssertionError(f"failed sends logged: {failures(caught)}")
    st = dict(requests=len(outs), serve_s=serve_s)
    log(f"[remote-parity] {len(outs)} streams over tcp token-for-token "
        f"equal to generate(); {st}")
    return st


def monitor_check(dev) -> dict:
    """A 1 MiB cuda:0 -> cuda:0 round trip over tcp, staged and pulled on
    the Python engine and pulled on the C++ engine, under
    STARWAY_MONITOR=1: every worker's protocol events replay through the
    monitor compiled from the port's sources (checked at each worker's
    retirement and once more here) with no violation, and the data arms
    are witnessed (DATA staged, DEVPULL pulled).  In process there is no
    wire protocol to check."""
    import asyncio
    import os

    import torch

    from starway_tpu_torch import DeviceBuffer, headline
    from starway_tpu_torch.core import monitor, swtrace

    out = {}
    with mock.patch.dict(os.environ, STARWAY_TLS="tcp", STARWAY_NATIVE="0",
                         STARWAY_MONITOR="1"):
        for label, native, pull, frame in (
                ("staged", "0", "0", "DATA"), ("pull", "0", "1", "DEVPULL"),
                ("native-pull", "1", "1", "DEVPULL")):
            os.environ["STARWAY_NATIVE"] = native
            os.environ["STARWAY_DEVPULL"] = pull
            swtrace.reset()
            monitor.reset()

            async def round_trip():
                server, client, ep = await headline.connect_pair()
                try:
                    src = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8,
                                        device=dev)
                    sinks = [DeviceBuffer((1 << 20,), torch.uint8, device=dev)
                             for _ in range(2)]
                    fut = server.arecv(sinks[0], 0x31, MASK)
                    await client.asend(src, 0x31)
                    await fut
                    fut = client.arecv(sinks[1], 0x32, MASK)
                    await server.asend(ep, sinks[0].array, 0x32)
                    await fut
                    await client.aflush()
                    for sink in sinks:
                        if not torch.equal(sink.array, src):
                            raise AssertionError("monitored round trip "
                                                 "changed the bytes")
                    routes = [s.last_transport for s in sinks]
                    if routes != ["staged" if pull == "0" else "device"] * 2:
                        raise AssertionError(f"monitored round trip "
                                             f"({label}) landed {routes}")
                    return routes
                finally:
                    await client.aclose()
                    await server.aclose()

            routes = asyncio.run(round_trip())
            monitor.check_all()
            seen = monitor.witnessed()
            if monitor.violations() or ("estab", frame) not in seen:
                raise AssertionError(
                    f"monitor ({label}): violations "
                    f"{[v.render() for v in monitor.violations()]}, "
                    f"witnessed {sorted(seen)}")
            out[label] = dict(routes=routes, violations=0,
                              transitions_witnessed=len(seen))
    monitor.reset()
    swtrace.reset()
    log(f"[monitor] STARWAY_MONITOR=1, 1 MiB cuda:0 <-> cuda:0 over tcp: "
        f"{out}")
    return out


# ------------------------------------------------------------ the DP pair

DP_BASE_TAG = 0x6000
DP_PARITY_BASE_TAG = 0x6000 + 0x40000  # past the full run's tag window
DP_PARITY_LR = 1.0  # one SGD step: moves the leaves far past the tolerance
DP_PARITY_REL_TOL = 1e-5
DP_HELD_ALLOWANCE = 128 << 20  # device bytes a rank may hold after a step


def leaf_checksum(t) -> int:
    """A 64-bit position-weighted sum of a tensor's bytes, computed where
    the tensor lives (int64 arithmetic wraps): equal tensors give equal
    sums, and a changed word changes it."""
    import torch

    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
              8: torch.int64}[t.element_size()]
    w = t.detach().contiguous().view(-1).view(as_int)
    total = torch.zeros((), dtype=torch.int64, device=w.device)
    step = 1 << 26
    for off in range(0, w.numel(), step):
        x = w[off:off + step].long()
        idx = torch.arange(off, off + x.numel(), dtype=torch.int64,
                           device=w.device)
        total += ((x * 0x9E3779B1 + idx) * ((idx * 2654435761) | 1)).sum()
    return int(total) & ((1 << 64) - 1)


def sgd(lr: float):
    """Plain SGD in utils.optim's shape: the float32 parity run's optimizer
    (AdamW's two float32 moments would not leave two full-width ranks
    room on one card; the exchange, not the optimizer, is under test)."""
    from starway_tpu_torch.utils.optim import GradientTransformation
    from starway_tpu_torch.utils.tree import tree_map

    return GradientTransformation(
        lambda params: (),
        lambda grads, state, params=None: (
            tree_map(lambda g: -lr * g, grads), state))


class RecordingPort:
    """A dp_exchange port that records how each received leaf landed (its
    sink's ``last_transport``), keeping no sink alive."""

    def __init__(self, inner):
        self.inner, self.transports = inner, []

    def asend(self, buf, tag):
        return self.inner.asend(buf, tag)

    async def arecv(self, buf, tag, mask=MASK):
        out = await self.inner.arecv(buf, tag, mask)
        self.transports.append(buf.last_transport)
        return out

    def aflush(self):
        return self.inner.aflush()


def dp_rank_child(rank: int, port: int, spec: dict, q, released,
                  barrier) -> None:
    """One rank of the DP phase, in its own process on ``spec["device"]``
    (imports only the port).  Rank 0 holds a Server with a ServerPort,
    rank 1 a Client with a ClientPort, over tcp on the engine
    ``spec["native"]`` asks for, with the pull on for every leaf.  Runs
    ``spec["full"]`` (Trainer + adamw, bf16, ``steps`` step_dp steps on
    its own batch), then ``spec["parity"]`` where there is one (float32,
    one step, SGD), and puts a dict per step on ``q``; rank 0 then checks
    the parity step against one in-process reference of both ranks'
    averaged step, once rank 1 has set ``released``.  Both ranks read a
    step's counts and memory before either starts the next (``barrier``,
    outside the timed step): the C++ engine pulls a message as it
    arrives, so the peer's next gradients would otherwise land, and count,
    inside this step's reading."""
    import asyncio
    import os

    os.environ.update(STARWAY_TLS="tcp", STARWAY_NATIVE=spec["native"],
                      STARWAY_DEVPULL="1", STARWAY_DEVPULL_MIN="1")

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    from starway_tpu_torch import Client, Server
    from starway_tpu_torch.models import LlamaConfig, Trainer, init_params
    from starway_tpu_torch.models.llama import apply_updates, value_and_grad
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.parallel import ClientPort, ServerPort
    from starway_tpu_torch.utils import adamw
    from starway_tpu_torch.utils.tree import tree_leaves, tree_map

    def held() -> tuple:
        """Device bytes allocated now, as read right away and once the
        allocator has settled: exports the peer has released collected,
        and the frees deferred behind side-stream uses (record_stream)
        processed, which the allocator does at its next allocation."""
        if dev.type != "cuda":
            return 0, 0
        torch.cuda.synchronize(dev)
        raw = torch.cuda.memory_allocated(dev)
        torch.cuda.ipc_collect()
        torch.empty(1, device=dev)
        return raw, torch.cuda.memory_allocated(dev)

    async def run_mode(worker, port_obj, mode: str) -> None:
        run = spec[mode]
        cfg = LlamaConfig.preset(run["preset"], **run["cfg"])
        params = init_params(cfg, run["seed"], device=dev)
        b, s1 = run["batch"]
        batch = train_batch(cfg, b, s1, run["batch_seed"] + rank, dev)
        tx = sgd(DP_PARITY_LR) if mode == "parity" else adamw(LR_TRAIN)
        rec = RecordingPort(port_obj)
        trainer = Trainer(cfg, tx, params, dp_port=rec,
                          dp_base_tag=run["base_tag"])
        mgr = worker.transfer_manager()
        n_leaves = len(tree_leaves(params))
        leaf_bytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(params))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        base = held()[1]
        reset_launch_counts()
        before = dict(mgr.counts) if mgr is not None else {}
        tel_before = {}
        for step in range(run["steps"]):
            rec.transports.clear()
            t0 = time.perf_counter()
            loss = await trainer.step_dp(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            after = dict(mgr.counts) if mgr is not None else {}
            tel = trainer.telemetry()
            spans_ms = {k: (v["total_s"] - tel_before.get(k, {}).get(
                "total_s", 0.0)) * 1e3 for k, v in tel.items()}
            tel_before = tel
            q.put(dict(
                kind="step", mode=mode, rank=rank, step=step, loss=loss,
                ms=ms, spans_ms=spans_ms, n_leaves=n_leaves,
                leaf_bytes=leaf_bytes,
                checksums=[leaf_checksum(t)
                           for t in tree_leaves(trainer.state.params)],
                transports=sorted(set(rec.transports)),
                n_sinks=len(rec.transports),
                pulls={k: after.get(k, 0) - before.get(k, 0)
                       for k in ("offered_ipc", "pulled_ipc")},
                **dict(zip(("held_raw_over_base_bytes",
                            "held_over_base_bytes"),
                           (h - base for h in held())))))
            before = after
            await asyncio.get_running_loop().run_in_executor(
                None, barrier.wait, 600)
        q.put(dict(kind="done", mode=mode, rank=rank,
                   launches=launch_counts(),
                   peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None)))
        if mode == "parity" and rank == 0:
            mine = trainer.state.params
            trainer.state.opt_state = None
            del trainer, rec
            await asyncio.get_running_loop().run_in_executor(
                None, released.wait, 600)
            q.put(dict(kind="reference", rank=0,
                       **parity_reference(cfg, run, mine, dev)))
        del params, batch

    def parity_reference(cfg, run, mine, dev) -> dict:
        """Both ranks' gradients at the initial parameters, averaged and
        applied once, in this process; each leaf of ``mine`` against it."""
        ref = init_params(cfg, run["seed"], device=dev)
        moved = max(float((got - p0).abs().max() / p0.abs().max())
                    for got, p0 in zip(tree_leaves(mine), tree_leaves(ref)))
        b, s1 = run["batch"]
        grads = []
        for r in (0, 1):
            batch = train_batch(cfg, b, s1, run["batch_seed"] + r, dev)
            grads.append(value_and_grad(ref, batch, cfg)[1])
        avg = tree_map(lambda a, c: (a + c) / 2, grads[0], grads[1])
        del grads
        ref, _ = apply_updates(sgd(DP_PARITY_LR), ref, (), avg)
        worst = max(float((got - want).abs().max() / want.abs().max())
                    for got, want in zip(tree_leaves(mine), tree_leaves(ref)))
        return dict(max_rel_err=worst, max_rel_move=moved)

    async def main():
        if rank == 0:
            server = Server()
            server.listen("127.0.0.1", port)
            q.put(dict(kind="listening", rank=0))
            for _ in range(24000):
                if server.list_clients():
                    break
                await asyncio.sleep(0.005)
            link, port_obj = server, ServerPort(server)
            worker = server._server
        else:
            link = None
            for _ in range(480):
                link = Client()
                try:
                    await link.aconnect("127.0.0.1", port)
                    break
                except Exception:  # noqa: BLE001
                    await asyncio.sleep(0.25)
            port_obj, worker = ClientPort(link), link._client
        try:
            for mode in dp_modes(spec):
                await run_mode(worker, port_obj, mode)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            await link.aclose()  # every step flushed its own sends
        if rank == 1:
            released.set()

    try:
        asyncio.run(main())
    except Exception as e:  # noqa: BLE001 - the parent reports it
        import traceback

        q.put(dict(kind="error", rank=rank,
                   error=f"{e!r}\n{traceback.format_exc()}"))
        if rank == 1:
            released.set()


def dp_spec(device: str, preset: str = "llama3-8b",
            native: bool = False) -> dict:
    """The DP phase's two runs on the Python engine: llama3-8b widths cut
    to 2 layers, bf16, remat "dots", [1, 2049], 3 steps; then float32, 2
    layers, [1, 513], one step.  ``native``: the bf16 run alone, 2 steps,
    on the C++ engine."""
    full = dict(preset=preset, steps=2 if native else 3, batch=(1, 2049),
                cfg=dict(n_layers=2, remat=True, remat_policy="dots"),
                seed=SEED + 5, batch_seed=SEED + 20, base_tag=DP_BASE_TAG)
    parity = None if native else dict(
        preset=preset, steps=1, batch=(1, 513),
        cfg=dict(n_layers=2, dtype="float32"), seed=SEED + 6,
        batch_seed=SEED + 30, base_tag=DP_PARITY_BASE_TAG)
    return dict(device=device, native="1" if native else "0", full=full,
                parity=parity)


def dp_modes(spec: dict) -> list:
    return [m for m in ("full", "parity") if spec[m] is not None]


def phase_dp(spec: dict, card: str) -> tuple:
    """Phase 16: two ranks, each a spawned process on the card, average
    their gradients over the transport every step (Trainer.step_dp).
    Checks: after every step both ranks' parameters are bit-for-bit equal
    (a checksum of each leaf's bytes), every loss is finite, every leaf
    landed on the card ("device") by one CUDA IPC pull a leaf and step on
    each side, the memory of the exchange is released after each step;
    the float32 parity step (where the spec has one) equals, to 1e-5 of
    each leaf's largest value, one in-process step on both ranks'
    averaged gradients.  Returns (stats, the ranks' launches summed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q, released, barrier = ctx.Queue(), ctx.Event(), ctx.Barrier(2)
    port = free_port()
    on_card = spec["device"].startswith("cuda")
    full, modes = spec["full"], dp_modes(spec)
    engine = "C++" if spec["native"] == "1" else "Python"
    log(f"[dp] two ranks on {spec['device']}, one process each, tcp, "
        f"{engine} engine, CUDA IPC pull: {full['preset']} widths, "
        f"{full['cfg']['n_layers']} layers, bf16, remat dots, AdamW, batch "
        f"{list(full['batch'])} a rank, {full['steps']} step_dp steps"
        + (f"; then float32, batch {list(spec['parity']['batch'])}, one "
           f"step (SGD)" if "parity" in modes else ""))
    ranks = [ctx.Process(target=dp_rank_child,
                         args=(r, port, spec, q, released, barrier))
             for r in (0, 1)]
    t0 = time.perf_counter()
    ranks[0].start()
    msgs = []
    try:
        first = q.get(timeout=300)
        if first.get("kind") != "listening":
            raise AssertionError(f"rank 0 did not listen: {first}")
        ranks[1].start()
        n_want = sum(2 * (spec[m]["steps"] + 1) for m in modes)
        n_want += "parity" in modes  # rank 0's parity reference
        while len(msgs) < n_want:
            msg = q.get(timeout=900)
            if msg.get("kind") == "error":
                raise AssertionError(f"DP rank {msg['rank']} failed: "
                                     f"{msg['error']}")
            msgs.append(msg)
    finally:
        for p in ranks:
            p.join(120)
            if p.is_alive():
                p.terminate()
    wall_s = time.perf_counter() - t0
    steps = {(m["mode"], m["step"], m["rank"]): m for m in msgs
             if m["kind"] == "step"}
    done = {(m["mode"], m["rank"]): m for m in msgs if m["kind"] == "done"}
    ref = next((m for m in msgs if m["kind"] == "reference"), None)
    for key in sorted(steps):
        m = steps[key]
        log(f"  [dp] {key}: loss {m['loss']:.4f}, {m['ms']:.1f} ms, "
            f"landed {m['transports']} x{m['n_sinks']}, IPC {m['pulls']}, "
            f"held over base {m['held_raw_over_base_bytes'] / 1e6:.1f} MB "
            f"right after, {m['held_over_base_bytes'] / 1e6:.1f} MB settled")
    want_route = "device" if on_card else "staged"
    for mode in modes:
        for step in range(spec[mode]["steps"]):
            a, b = steps[(mode, step, 0)], steps[(mode, step, 1)]
            if a["checksums"] != b["checksums"]:
                diff = [i for i, (x, y) in enumerate(zip(a["checksums"],
                                                         b["checksums"]))
                        if x != y]
                raise AssertionError(f"{mode} step {step}: the ranks' "
                                     f"parameters differ at leaves {diff}")
            for m in (a, b):
                if not np.isfinite(m["loss"]):
                    raise AssertionError(f"{mode} step {step} rank "
                                         f"{m['rank']}: loss {m['loss']}")
                if m["transports"] != [want_route] or \
                        m["n_sinks"] != m["n_leaves"]:
                    raise AssertionError(f"{mode} step {step} rank "
                                         f"{m['rank']}: leaves landed "
                                         f"{m['transports']} "
                                         f"({m['n_sinks']} sinks)")
                pulls = m["n_leaves"] if on_card else 0
                if m["pulls"] != {"offered_ipc": pulls, "pulled_ipc": pulls}:
                    raise AssertionError(f"{mode} step {step} rank "
                                         f"{m['rank']}: IPC {m['pulls']}, "
                                         f"want {pulls} a leaf")
                # Allowance: the cuBLAS workspaces a first step allocates
                # for good (64 MiB measured); a leaf held on would be
                # 16.8 MB to 2.1 GB (all but the norms).
                if m["held_over_base_bytes"] > DP_HELD_ALLOWANCE:
                    raise AssertionError(
                        f"{mode} step {step} rank {m['rank']}: "
                        f"{m['held_over_base_bytes'] / 1e9:.3f} GB still "
                        f"held after the exchange")
    if ref is not None and not ref["max_rel_err"] <= DP_PARITY_REL_TOL:
        raise AssertionError(f"the DP parity step is {ref['max_rel_err']:.3g}"
                             f" of a leaf's largest value from the "
                             f"in-process reference")
    if ref is not None and not ref["max_rel_move"] > 100 * DP_PARITY_REL_TOL:
        raise AssertionError(f"the parity step hardly moved the parameters: "
                             f"{ref['max_rel_move']:.3g}")
    launches = {}
    for m in done.values():
        for k, v in m["launches"].items():
            launches[k] = launches.get(k, 0) + v
    # Steady state: every step but the first, which pays the ranks' first
    # kernel loads and IPC exports.
    steady = range(1, full["steps"])
    full_steps = [steps[("full", i, r)] for i in steady for r in (0, 1)]
    nbytes = full_steps[0]["leaf_bytes"]
    span = {r: {k: statistics.median(steps[("full", i, r)]["spans_ms"][k]
                                     for i in steady)
                for k in ("grad", "dp_exchange", "apply")} for r in (0, 1)}
    stats = dict(
        wall_s=wall_s,
        losses={r: [steps[("full", i, r)]["loss"]
                    for i in range(full["steps"])] for r in (0, 1)},
        median_step_ms=statistics.median(m["ms"] for m in full_steps),
        step_ms={r: [round(steps[("full", i, r)]["ms"], 1)
                     for i in range(full["steps"])] for r in (0, 1)},
        spans_median_ms=span,
        exchange_bytes_each_way=nbytes,
        exchange_gb_per_s_each_way={
            r: nbytes / (span[r]["dp_exchange"] / 1e3) / 1e9
            for r in (0, 1)},
        leaves=full_steps[0]["n_leaves"],
        held_over_base_bytes=max(m["held_over_base_bytes"]
                                 for m in steps.values()),
        held_raw_over_base_bytes=max(m["held_raw_over_base_bytes"]
                                     for m in steps.values()),
        peak_gb={f"{mode}-{r}": done[(mode, r)]["peak_gb"]
                 for mode in modes for r in (0, 1)},
        parity=ref, engine=engine, launches_by_rank={
            f"{mode}-{r}": done[(mode, r)]["launches"]
            for mode in modes for r in (0, 1)})
    log(f"[dp] {stats} ({card})")
    return stats, launches



# ------------------------------------------------------------ reshard

LM_HEAD = (128256, 4096)  # llama3-8b's lm_head, bf16: 1.05 GB
W1 = (4096, 14336)        # one layer's w1, bf16: 117 MB
RESHARD_MEM_SLACK = 0     # device bytes a move may leave allocated
RESHARD_REPS = 2          # each move twice: the first pays a process's first uses


def reshard_source(shape, seed: int, dev):
    """The move's source: bf16 from a seeded generator, made on ``dev``
    (both ranks make the same tensor and keep their own boxes)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)


def check_shards(res, sharding, full) -> None:
    """Every destination shard equals its box of ``full``, byte for byte,
    compared on the card."""
    import torch

    boxes = sharding.indices_map(full.shape)
    for slot, t in res.shards.items():
        want = full[tuple(slice(lo, hi) for lo, hi in boxes[slot])]
        if t.device != slot.device or not torch.equal(
                t.view(torch.int16), want.contiguous().view(torch.int16)):
            raise AssertionError(f"reshard: slot {slot.index}'s shard "
                                 f"differs from its box {boxes[slot]}")


def settled_allocated(dev) -> int:
    """Device bytes allocated once released exports are collected and the
    frees deferred behind side-stream uses are processed."""
    import torch

    gc.collect()
    if dev.type != "cuda":  # a rehearsal on the CPU: nothing to read
        return 0
    torch.cuda.synchronize(dev)
    torch.cuda.ipc_collect()
    torch.empty(1, device=dev)
    return torch.cuda.memory_allocated(dev)


def reshard_rank_child(rank: int, ports: list, dev_name: str, shapes,
                       q, barrier) -> None:
    """One rank of phase 17(b), in its own process on the card (imports
    only the port).  Rank 0 serves each move on its own port, rank 1
    connects.  The moves: the lm_head, rows over 2 -> columns over 2,
    via "device" on the Python engine, via "device" on the C++ engine and
    via "host"; then one layer's w1 from replicated on rank 0 to columns
    over 2, via "device" (``shapes``: the two tensors' shapes).  Each
    checks its shards byte for byte, its counts and its memory, and puts
    one dict on ``q`` (each move runs RESHARD_REPS times); the ranks
    close a move's link only once both have finished it (``barrier``), so
    no flush meets a closed peer."""
    import asyncio
    import os

    import torch

    os.environ.update(STARWAY_TLS="tcp", STARWAY_DEVPULL="1")
    dev = torch.device(dev_name)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    lm_head, w1 = shapes

    from starway_tpu_torch import Client, Server
    from starway_tpu_torch.parallel import ClientPort, ServerPort
    from starway_tpu_torch.reshard import (ArrayRef, ShardedTensor, SlotMesh,
                                           SlotSharding, executor,
                                           redistribute)

    two = SlotMesh({"x": 2}, devices=dev, ranks=[0, 1])
    moves = [
        ("lm_head-device-py", lm_head, "0", "device", ("x", None),
         (None, "x"), False),
        ("lm_head-device-native", lm_head, "1", "device", ("x", None),
         (None, "x"), False),
        ("lm_head-host", lm_head, "0", "host", ("x", None), (None, "x"),
         False),
        ("w1-replicated-device", w1, "0", "device", (), (None, "x"), True),
    ]

    async def link(port, native):
        os.environ["STARWAY_NATIVE"] = native
        if rank == 0:
            server = Server()
            server.listen("127.0.0.1", port)
            for _ in range(24000):
                if server.list_clients():
                    break
                await asyncio.sleep(0.005)
            return server, ServerPort(server), server._server
        for _ in range(480):
            client = Client()
            try:
                await client.aconnect("127.0.0.1", port)
                break
            except Exception:  # noqa: BLE001
                await asyncio.sleep(0.25)
        return client, ClientPort(client), client._client

    async def move(i, name, shape, native, via, src_spec, dst_spec,
                   from_rank0):
        if from_rank0:  # the source replicated on rank 0 alone
            src_sh = SlotSharding(SlotMesh({"x": 1}, devices=dev, ranks=0),
                                  src_spec)
        else:
            src_sh = SlotSharding(two, src_spec)
        dst_sh = SlotSharding(two, dst_spec)
        full = reshard_source(shape, SEED + 40 + i, dev)
        if from_rank0 and rank == 1:
            src = ArrayRef(shape, torch.bfloat16)
        else:
            src = ShardedTensor.from_tensor(full, src_sh, rank=rank)
        closer, port_obj, worker = await link(ports[i], native)
        base = settled_allocated(dev)
        executor.reset_staging_peak()
        mgr = worker.transfer_manager()
        before = dict(mgr.counts)
        wall_ms = []
        for rep in range(RESHARD_REPS):
            sync(dev)
            t0 = time.perf_counter()
            res = await redistribute(src, dst_sh, {1 - rank: port_obj},
                                     rank=rank,
                                     lease_slot=8 + RESHARD_REPS * i + rep,
                                     via=via, round_timeout=300)
            sync(dev)
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            check_shards(res, dst_sh, full)
            st = res.stats
            del res  # the destination: what is left must be what was there
        pulls = {k: mgr.counts[k] - before.get(k, 0)
                 for k in ("offered_ipc", "pulled_ipc")}
        peak = executor.staging_snapshot()["peak"]
        await asyncio.get_running_loop().run_in_executor(
            None, barrier.wait, 600)
        await closer.aclose()
        after = settled_allocated(dev) - base
        del src, full
        moved = st["tx_bytes"] + st["rx_bytes"]
        return dict(
            kind="move", rank=rank, name=name, shape=list(shape), via=via,
            engine="C++" if native == "1" else "Python",
            wall_ms=wall_ms, rounds=st["rounds"],
            plan_rounds=st["plan_rounds"], tx_bytes=st["tx_bytes"],
            rx_bytes=st["rx_bytes"], peak_staging=peak,
            peak_staging_bound=st["peak_staging_bound"], pulls=pulls,
            gb_per_s=moved / (min(wall_ms) / 1e3) / 1e9,
            held_after_bytes=after)

    async def main():
        for i, m in enumerate(moves):
            q.put(await move(i, *m))

    try:
        asyncio.run(main())
    except Exception as e:  # noqa: BLE001 - the parent reports it
        import traceback

        q.put(dict(kind="error", rank=rank,
                   error=f"{e!r}\n{traceback.format_exc()}"))


def phase_reshard(dev, card: str, shapes=(LM_HEAD, W1)) -> dict:
    """Phase 17: redistribute() on the card, sized as users move weights.
    (a) In process: llama3-8b's lm_head [128256, 4096] bf16 (1.05 GB) over
    8 slots on cuda:0, rows over 8 -> columns over 8, via "device" (every
    piece a copy on the card).  (b) Two spawned ranks on the card
    (reshard_rank_child): the lm_head rows over 2 -> columns over 2 (263
    MB each way) via "device" on the Python engine, via "device" on the
    C++ engine and via "host"; one layer's w1 [4096, 14336] from
    replicated on rank 0 to columns over 2.  Every destination shard
    equals its box of the source byte for byte; the rounds, tx/rx bytes,
    the IPC pulls, the peak staging against its bound and the device
    memory back at its baseline are checked; wall ms and GB/s logged."""
    import asyncio
    import multiprocessing as mp

    import torch

    from starway_tpu_torch.reshard import (ShardedTensor, SlotMesh,
                                           SlotSharding, redistribute)

    out = {}
    t_phase = time.perf_counter()
    lm_head, w1 = shapes
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda d: None)
    # (a) in process
    eight = SlotMesh({"x": 8}, devices=dev)
    full = reshard_source(lm_head, SEED + 39, dev)
    src = ShardedTensor.from_tensor(full, SlotSharding(eight, ("x", None)))
    dst_sh = SlotSharding(eight, (None, "x"))
    nbytes = full.numel() * full.element_size()
    base = settled_allocated(dev)
    times = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        res = asyncio.run(redistribute(src, dst_sh, via="device"))
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        check_shards(res, dst_sh, full)
        if res.stats["rounds"] or res.stats["tx_bytes"]:
            raise AssertionError(f"the in-process retile went over the "
                                 f"wire: {res.stats}")
        del res
    held = settled_allocated(dev) - base
    if held > RESHARD_MEM_SLACK:
        raise AssertionError(f"the in-process retile left {held} B "
                             f"allocated")
    copy_ms = (cuda_ms(lambda: full.t().contiguous(), iters=5, warmup=1)
               if dev.type == "cuda" else None)
    out["in-process"] = dict(
        bytes=nbytes, wall_ms=times, gb_per_s=nbytes / (min(times) / 1e3) /
        1e9, transpose_copy_ms=copy_ms, held_after_bytes=held)
    log(f"[reshard] (a) lm_head {list(lm_head)} bf16 {nbytes / 1e9:.3f} GB, "
        f"8 slots on {dev}, rows -> columns, via device: wall ms {times} "
        f"({out['in-process']['gb_per_s']:.1f} GB/s at the best); one "
        f"transpose copy of the whole tensor {copy_ms} ms (CUDA events); "
        f"memory over base after {held} B ({card})")
    del src, full
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) two spawned ranks
    ctx = mp.get_context("spawn")
    q, barrier = ctx.Queue(), ctx.Barrier(2)
    ports = [free_port() for _ in range(4)]
    ranks = [ctx.Process(target=reshard_rank_child,
                         args=(r, ports, str(dev), shapes, q, barrier))
             for r in (0, 1)]
    for p in ranks:
        p.start()
    msgs = []
    try:
        while len(msgs) < 2 * 4:
            msg = q.get(timeout=600)
            if msg.get("kind") == "error":
                raise AssertionError(f"reshard rank {msg['rank']} failed: "
                                     f"{msg['error']}")
            msgs.append(msg)
    finally:
        for p in ranks:
            p.join(120)
            if p.is_alive():
                p.terminate()
    lm_quarter = lm_head[0] * lm_head[1] * 2 // 4
    w1_half = w1[0] * w1[1] * 2 // 2
    for m in msgs:
        name, r = m["name"], m["rank"]
        if name.startswith("lm_head"):
            want_tx = want_rx = lm_quarter
        else:
            want_tx, want_rx = (w1_half, 0) if r == 0 else (0, w1_half)
        pulled = m["via"] == "device" and dev.type == "cuda"
        want_pulls = {"offered_ipc": RESHARD_REPS if pulled and want_tx
                      else 0,
                      "pulled_ipc": RESHARD_REPS if pulled and want_rx
                      else 0}
        bad = []
        if (m["tx_bytes"], m["rx_bytes"]) != (want_tx, want_rx):
            bad.append(f"tx/rx {m['tx_bytes']}/{m['rx_bytes']}, want "
                       f"{want_tx}/{want_rx}")
        if m["rounds"] != 1 or m["plan_rounds"] != 1:
            bad.append(f"rounds {m['rounds']} of a plan of "
                       f"{m['plan_rounds']}, want 1")
        if m["peak_staging"] > m["peak_staging_bound"]:
            bad.append(f"peak staging {m['peak_staging']} over its bound "
                       f"{m['peak_staging_bound']}")
        if m["pulls"] != want_pulls:
            bad.append(f"IPC {m['pulls']}, want {want_pulls}")
        if m["held_after_bytes"] > RESHARD_MEM_SLACK:
            bad.append(f"{m['held_after_bytes']} B held after the move")
        if bad:
            raise AssertionError(f"reshard {name} rank {r}: {bad}")
        out[f"{name}-rank{r}"] = m
        log(f"[reshard] (b) {name} rank {r} ({m['engine']} engine, via "
            f"{m['via']}): wall ms {[round(t, 1) for t in m['wall_ms']]}, "
            f"tx {m['tx_bytes']} B rx {m['rx_bytes']} B, "
            f"{m['gb_per_s']:.2f} GB/s (tx + rx over the best wall), "
            f"peak staging {m['peak_staging']} of bound "
            f"{m['peak_staging_bound']}, IPC {m['pulls']}, held after "
            f"{m['held_after_bytes']} B")
    log(f"[reshard] done in {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# ---------------------------------------------------------------- mistral

# Mistral-7B-v0.1's published config.json (huggingface.co/mistralai/
# Mistral-7B-v0.1), as config_from_hf reads it.
MISTRAL_7B = dict(
    model_type="mistral", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, rope_theta=10000.0, sliding_window=4096,
    max_position_embeddings=32768, rms_norm_eps=1e-5, hidden_act="silu",
    tie_word_embeddings=False)
MISTRAL_PROMPTS = (512, 2048, 4000, 4096, 4097, 6000, 9000)
MISTRAL_HORIZON = 16384   # the rolling server's rope horizon (max_len)
MISTRAL_BUDGET = 128
MISTRAL_REQS = 8          # every prompt length once, the first twice
# The W8A16 + int8 KV run's requests (a slice of phase 18's): prompts 2048
# (64-row admission chunks) and 4000, whose 4000 + 128 wraps the window.
MISTRAL_INT8_REQS = slice(1, 3)
ROLLING_PROMPT = 6000     # aligned rolling generate(): P > W
SPEC_PROMPT = 4600        # past the window: the verify's window bites
SPEC_NEW = 48
BEAM = dict(batch=2, beams=4, prompt=512, new=32)
# Phase 19's requests (prompt, budget): 4000 + 160 wraps the cache, 4500
# starts past it, 700 stays inside; their rope horizon.
PARITY_REQS = ((4000, 160), (4500, 48), (700, 40))
PARITY_HORIZON = 8192
PARITY_REL_TOL = 1e-3     # prefill_rolling vs the one-pass prefill, float32
BEAM_SCORE_REL_TOL = 1e-4


def mistral_config(**overrides):
    """The port's LlamaConfig of Mistral-7B-v0.1, by config_from_hf."""
    from types import SimpleNamespace

    from starway_tpu_torch.models import config_from_hf

    return config_from_hf(SimpleNamespace(**MISTRAL_7B), **overrides)


def mistral_state(cfg, dev, seed: int, dtype, dense_mlp: bool = True) -> dict:
    """An HF-named Mistral state dict at ``cfg``'s widths and depth, made
    on the card from a seeded generator: projections scaled by
    fan_in^-1/2, norms near 1; ``dense_mlp=False`` leaves out the MLP."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(shape, scale, base=0.0):
        w = torch.randn(shape, generator=gen, device=dev)
        return (w * scale + base).to(dtype)

    D, F, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd
    state = {"model.embed_tokens.weight": rand((cfg.vocab_size, D), 0.02),
             "model.norm.weight": rand((D,), 0.05, 1.0),
             "lm_head.weight": rand((cfg.vocab_size, D), D ** -0.5)}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        state.update({
            pre + "self_attn.q_proj.weight": rand((q_out, D), D ** -0.5),
            pre + "self_attn.k_proj.weight": rand((kv_out, D), D ** -0.5),
            pre + "self_attn.v_proj.weight": rand((kv_out, D), D ** -0.5),
            pre + "self_attn.o_proj.weight": rand((D, q_out), q_out ** -0.5)})
        if dense_mlp:
            state.update({
                pre + "mlp.gate_proj.weight": rand((F, D), D ** -0.5),
                pre + "mlp.up_proj.weight": rand((F, D), D ** -0.5),
                pre + "mlp.down_proj.weight": rand((D, F), F ** -0.5)})
        state.update({
            pre + "input_layernorm.weight": rand((D,), 0.05, 1.0),
            pre + "post_attention_layernorm.weight": rand((D,), 0.05, 1.0)})
    return state


def convert_mistral(cfg, dev, seed: int, dtype, **kw):
    """Random HF weights on the card, converted by params_from_hf; the
    source is freed before the tree is returned.  Returns (params, stats:
    the conversion's seconds and the peak device memory from before the
    source was made)."""
    import torch

    from starway_tpu_torch.models import params_from_hf

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = mistral_state(cfg, dev, seed, dtype)
    torch.cuda.synchronize()
    source_gb = (torch.cuda.memory_allocated() - base) / 1e9
    t0 = time.perf_counter()
    params = params_from_hf(state, cfg, device=dev, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del state
    gc.collect()
    torch.cuda.empty_cache()
    stats = dict(convert_s=seconds, source_gb=source_gb,
                 peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                 tree_gb=(torch.cuda.memory_allocated() - base) / 1e9)
    log(f"  converted {cfg.n_layers} layers ({dtype}, {kw or 'raw'}): "
        f"{stats}")
    return params, stats


def mistral_requests(cfg, n: int = 12):
    """(tokens, budget, prefixed): prompts of MISTRAL_PROMPTS cycled, each
    of MISTRAL_BUDGET new tokens."""
    rng = np.random.default_rng(SEED + 18)
    return [(rng.integers(1, cfg.vocab_size,
                          MISTRAL_PROMPTS[i % len(MISTRAL_PROMPTS)]).tolist(),
             MISTRAL_BUDGET, False) for i in range(n)]


def counted(counts, fn):
    """``fn()`` with the launch counts set to 0 just before and added to
    ``counts`` just after (the GEMV's by regime under "int8_matmul/")."""
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.gemv import int8_matmul

    reset_launch_counts()
    out = fn()
    for name, n in launch_counts().items():
        counts[name] = counts.get(name, 0) + n
    for regime, n in int8_matmul.regime_launches.items():
        key = f"int8_matmul/{regime}"
        counts[key] = counts.get(key, 0) + n
    return out


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spec_runs(params, cfg, counts, prompt_len: int = SPEC_PROMPT,
              new: int = SPEC_NEW, gammas=(3, 4, 5)) -> dict:
    """Speculative decoding at full width: a truncation draft of 4 layers
    at each of ``gammas``, and prompt lookup (ngram 2, gamma 4) on a
    prompt that repeats a 64-token pattern; B=2 prompts of ``prompt_len``
    and ``new`` tokens, each beside generate() on its prompt (bf16: the
    verify may round otherwise than decode, so the equal share is logged,
    not asserted)."""
    import torch

    from starway_tpu_torch.models import (draft_from_truncation, generate,
                                          generate_lookup,
                                          generate_speculative)

    dev = params["embed"].device
    rng = np.random.default_rng(SEED + 181)
    prompt = torch.tensor(rng.integers(1, cfg.vocab_size, (2, prompt_len)),
                          device=dev)
    pattern = rng.integers(1, cfg.vocab_size, (2, 64))
    rep = torch.tensor(np.tile(pattern, prompt_len // 64 + 1)[:, :prompt_len],
                       device=dev)
    out = {}
    n_tok = 2 * new
    for label, p in (("random", prompt), ("repetitive", rep)):
        ref, s = timed(lambda: counted(counts, lambda: generate(
            params, cfg, p, new)))
        out[f"generate_{label}"] = dict(s=s, tokens_per_s=n_tok / s)
        if label == "random":
            draft, dcfg = draft_from_truncation(params, cfg, 4)
            runs = [(f"speculative_gamma{g}", g, lambda g=g: (
                generate_speculative(params, cfg, draft, dcfg, p, new,
                                     gamma=g, return_stats=True)))
                    for g in gammas]
        else:
            runs = [("lookup_ngram2", 4, lambda: generate_lookup(
                params, cfg, p, new, gamma=4, ngram=2,
                return_stats=True))]
        for name, g, fn in runs:
            (toks, stats), s = timed(lambda: counted(counts, fn))
            if toks.shape != ref.shape:
                raise AssertionError(f"{name} returned {tuple(toks.shape)}")
            steps = int(stats["macro_steps"].sum())
            acc = int(stats["accepted"].sum())
            out[name] = dict(
                s=s, ms_per_token=s * 1e3 / n_tok, tokens_per_s=n_tok / s,
                macro_steps=steps, accepted=acc,
                acceptance=acc / max(1, steps * (g - 1)),
                tokens_equal_to_generate=int(
                    (toks[:, prompt_len:] == ref[:, prompt_len:]).sum()),
                of=n_tok)
            log(f"  {name}: {out[name]}")
    return out


def beam_run(params, cfg, counts, spec=BEAM) -> dict:
    """generate_beam at full width: B=2, K=4, P=512, 32 new tokens (or
    ``spec``'s).  The reorder moves the whole K-way cache each step: its
    bytes (each leaf read once and written once) are computed from the
    shapes."""
    import torch

    from starway_tpu_torch.models import generate_beam

    dev = params["embed"].device
    b, k, p, n = spec["batch"], spec["beams"], spec["prompt"], spec["new"]
    prompt = torch.tensor(np.random.default_rng(SEED + 182).integers(
        1, cfg.vocab_size, (b, p)), device=dev)
    (out, scores, fin), s = timed(lambda: counted(counts, lambda: (
        generate_beam(params, cfg, prompt, n, beams=k, return_all=True))))
    if not (out.shape == (b, k, n) and torch.isfinite(scores).all()
            and bool((scores[:, 1:] <= scores[:, :-1] + 1e-3).all())):
        raise AssertionError("beam search returned unsorted or non-finite "
                             "beams")
    entry = cfg.n_kv_heads * cfg.head_dim * cfg.compute_dtype.itemsize
    reorder = 2 * 2 * cfg.n_layers * b * k * (p + n) * entry
    st = dict(s=s, ms_per_token=s * 1e3 / n, reorder_bytes_per_step=reorder,
              reorder_gb_total=reorder * (n - 1) / 1e9,
              best_scores=scores[:, 0].tolist())
    log(f"  beam: {st}")
    return st


def phase_mistral(dev, card: str) -> tuple:
    """Phase 18: Mistral-7B-v0.1 at full width (32 layers, bf16, random
    HF-named weights converted by config_from_hf + params_from_hf).
    Returns (stats, launch counts of the main-path runs)."""
    import torch

    from starway_tpu_torch.models import forward, generate
    from starway_tpu_torch.models.serving import _rolling_prefill_state

    cfg = mistral_config()
    log(f"[mistral] Mistral-7B-v0.1 widths ({card}): {cfg}")
    st = {}
    params, st["convert_bf16"] = convert_mistral(cfg, dev, SEED + 18,
                                                 torch.bfloat16)
    counts = {}
    reqs = mistral_requests(cfg, MISTRAL_REQS)
    log(f"[mistral] rolling SlotServer: n_slots 8, max_len "
        f"{MISTRAL_HORIZON}, chunk 8, {len(reqs)} requests of "
        f"{MISTRAL_BUDGET} tokens, prompts {MISTRAL_PROMPTS} cycled")
    c_roll = {}
    _done, st["serve"], srv = counted(c_roll, lambda: serve(
        params, cfg, reqs, max_len=MISTRAL_HORIZON))
    assert_decode_route(c_roll, "phase 18 (mistral rolling server)")
    for key, n in c_roll.items():
        counts[key] = counts.get(key, 0) + n
    shape = tuple(srv.cache["k"].shape)
    del srv
    log(f"  {st['serve']}")
    if shape != (cfg.n_layers, 8, cfg.n_kv_heads, cfg.sliding_window,
                 cfg.head_dim):
        raise AssertionError(f"the rolling cache is {shape}")
    long_prompt = max((p for p, _m, _w in reqs), key=len)
    got = _rolling_prefill_state(params, cfg, np.asarray(long_prompt))[0]
    want = forward(params, torch.tensor([long_prompt], device=dev), cfg,
                   last_only=True)[:, 0]
    st["first_logits_rel_err_longest"] = compare_logits(got, want)
    del got, want
    prompt = torch.tensor(np.random.default_rng(SEED + 183).integers(
        1, cfg.vocab_size, (2, ROLLING_PROMPT)), device=dev)
    out, s = timed(lambda: counted(counts, lambda: generate(
        params, cfg, prompt, 64)))
    if (out.shape != (2, ROLLING_PROMPT + 64)
            or not bool((out < cfg.vocab_size).all())):
        raise AssertionError("rolling generate() returned a bad batch")
    st["generate_rolling"] = dict(s=s, tokens_per_s=128 / s)
    log(f"  aligned rolling generate(), B=2 P={ROLLING_PROMPT}, 64 new: "
        f"{st['generate_rolling']}")
    st["speculative"] = spec_runs(params, cfg, counts)
    st["beam"] = beam_run(params, cfg, counts)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg8 = mistral_config(kv_quant="int8")
    int8_reqs = reqs[MISTRAL_INT8_REQS]
    log("[mistral] W8A16 weights (params_from_hf quantize='int8') and an "
        f"int8 KV cache, prompts {[len(p) for p, _m, _w in int8_reqs]} of "
        f"{MISTRAL_BUDGET} tokens, untraced")
    qparams, st["convert_int8"] = convert_mistral(
        cfg8, dev, SEED + 18, torch.bfloat16, quantize="int8")
    c8 = {}
    # Untraced: the profiler's processing of a chunk costs ~15 s here.
    st["serve_int8"] = counted(c8, lambda: serve(
        qparams, cfg8, int8_reqs, max_len=MISTRAL_HORIZON, trace=False))[1]
    log(f"  {st['serve_int8']}")
    if not (c8["int8_matmul/decode"] > 0 and c8["int8_matmul/prefill"] > 0):
        raise AssertionError("the W8A16 rolling run did not launch the GEMV "
                             "in both regimes")
    for key, n in c8.items():
        counts[key] = counts.get(key, 0) + n
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches {counts}")
    for name in ("decode_attention", "flash_forward", "int8_matmul"):
        if not counts.get(name):
            raise AssertionError(f"phase 18 launched no {name} kernel")
    return st, counts


def phase_mistral_parity(dev) -> tuple:
    """Phase 19: float32, Mistral widths cut to 2 layers, window 4096;
    prompts of 4000 and 4500 tokens so that decode wraps the circular
    cache.  Returns (stats, launch counts)."""
    import torch

    from starway_tpu_torch.models import (SlotServer, draft_from_truncation,
                                          forward, generate, generate_beam,
                                          generate_lookup,
                                          generate_speculative,
                                          prefill_rolling)
    from starway_tpu_torch.models.generate import decode_step
    from starway_tpu_torch.models.llama import cfg_rope_tables
    from starway_tpu_torch.models.serving import _rolling_prefill_state

    cfg = mistral_config(n_layers=2, dtype="float32")
    params, st = convert_mistral(cfg, dev, SEED + 19, torch.float32)
    counts = {}
    rng = np.random.default_rng(SEED + 19)
    reqs = [(rng.integers(1, cfg.vocab_size, n).tolist(), m)
            for n, m in PARITY_REQS]
    srv = SlotServer(params, cfg, n_slots=2, max_len=PARITY_HORIZON, chunk=8)
    rids = [srv.submit(p, m) for p, m in reqs]
    done = counted(counts, srv.run)
    del srv
    rope = cfg_rope_tables(cfg, PARITY_HORIZON, device=dev)
    for rid, (prompt, m) in zip(rids, reqs):
        logits, cache = _rolling_prefill_state(params, cfg, prompt)
        toks = [int(logits.argmax(-1)[0])]
        while len(toks) < m:
            pos = torch.tensor([len(prompt) + len(toks) - 1], device=dev)
            logits, cache = decode_step(
                params, cache, torch.tensor([toks[-1]], device=dev), pos,
                cfg, rope, rolling=True)
            toks.append(int(logits.argmax(-1)[0]))
        if not np.array_equal(done[rid], toks):
            raise AssertionError(f"rolling SlotServer, P={len(prompt)}: "
                                 f"{done[rid]} != its primitives' {toks}")
    log(f"  rolling SlotServer: requests {PARITY_REQS} (prompt, budget) "
        f"equal the single-request loop token for token")
    long_prompt = max((p for p, _m in reqs), key=len)
    P = len(long_prompt)
    full = torch.tensor([long_prompt], device=dev)
    want = forward(params, full, cfg, last_only=True)[:, 0]
    scale = want.abs().max().item()
    for label, got in (
            ("admission widths (64, 8, 1)",
             _rolling_prefill_state(params, cfg, long_prompt)[0]),
            ("one chunk of W", prefill_rolling(params, cfg, full)[0])):
        rel = (got - want).abs().max().item() / scale
        log(f"  prefill_rolling ({label}) vs the one-pass windowed "
            f"prefill, P={P}: {rel:.3e} of max |logit| (tol "
            f"{PARITY_REL_TOL})")
        if not rel <= PARITY_REL_TOL:
            raise AssertionError("prefill_rolling disagrees with the "
                                 "one-pass prefill")
        st[f"prefill_rolling_rel_err ({label})"] = rel
    n = 32
    ref = counted(counts, lambda: generate(params, cfg, full, n))
    draft, dcfg = draft_from_truncation(params, cfg, 1)
    for label, fn in (
            ("speculative gamma 3", lambda: generate_speculative(
                params, cfg, draft, dcfg, full, n, gamma=3)),
            ("speculative gamma 4", lambda: generate_speculative(
                params, cfg, draft, dcfg, full, n, gamma=4)),
            ("lookup", lambda: generate_lookup(params, cfg, full, n)),
            ("beams=1", lambda: generate_beam(params, cfg, full, n,
                                              beams=1))):
        got = counted(counts, fn)
        if not torch.equal(got, ref):
            raise AssertionError(f"{label} != generate(): "
                                 f"{got[0, P:].tolist()} vs "
                                 f"{ref[0, P:].tolist()}")
    log(f"  generate_speculative (gamma 3, 4), generate_lookup and "
        f"generate_beam(beams=1) equal generate() at P={P}, {n} new")
    out, scores, _fin = counted(counts, lambda: generate_beam(
        params, cfg, full, n, beams=4, return_all=True))
    seqs = torch.cat([full.expand(4, -1), out[0]], dim=1)
    lp = torch.log_softmax(forward(params, seqs[:, :-1], cfg)[:, P - 1:],
                           dim=-1)
    teacher = lp.gather(-1, seqs[:, P:, None])[..., 0].sum(-1)
    del lp
    rel = ((scores[0] - teacher).abs() / teacher.abs()).max().item()
    log(f"  beam scores {scores[0].tolist()} vs teacher-forced "
        f"{teacher.tolist()}: worst {rel:.3e} of |score| (tol "
        f"{BEAM_SCORE_REL_TOL})")
    if not rel <= BEAM_SCORE_REL_TOL:
        raise AssertionError("beam scores disagree with their teacher-forced "
                             "sums")
    st["beam_score_rel_err"] = rel
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches {counts}")
    return st, counts


# ---------------------------------------------------------------- mixtral

# Mixtral-8x7B-v0.1's published config.json (huggingface.co/mistralai/
# Mixtral-8x7B-v0.1), as config_from_hf reads it; the conversion makes it
# dropless (capacity factor = its 8 experts).
MIXTRAL_8X7B = dict(
    model_type="mixtral", vocab_size=32000, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, num_local_experts=8, num_experts_per_tok=2,
    rope_theta=1e6, sliding_window=None, max_position_embeddings=32768,
    rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=False,
    router_aux_loss_coef=0.02)
MIXTRAL_LAYERS = 16       # of 32: 46.97 GB of bf16 weights (93.4 GB in all)
MIXTRAL_CONVERT_LAYERS = 4
MIXTRAL_GENERATE = dict(prompt=1024, new=32, lengths=(1024, 777))
MIXTRAL_SPEC = dict(prompt_len=1024, new=32, gammas=(4,))
MIXTRAL_BEAM = dict(batch=2, beams=4, prompt=512, new=16)
EP_X = (1, 2048)          # one layer's tokens for ep against the global view
EP_REL_TOL = 2e-2         # bf16, vs max |y|: one rounding of expert outputs
MIXTRAL_PARITY_REQS = 8


def mixtral_config(**overrides):
    """The port's LlamaConfig of Mixtral-8x7B-v0.1, by config_from_hf."""
    from types import SimpleNamespace

    from starway_tpu_torch.models import config_from_hf

    return config_from_hf(SimpleNamespace(**MIXTRAL_8X7B), **overrides)


def mixtral_state(cfg, dev, seed: int, dtype) -> dict:
    """An HF-named Mixtral state dict at ``cfg``'s widths and depth, made
    on the card from a seeded generator: the attention, norms and head of
    :func:`mistral_state`, and the router and each expert's w1/w3/w2 in
    place of the dense MLP."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def rand(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    state = mistral_state(cfg, dev, seed, dtype, dense_mlp=False)
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}.block_sparse_moe."
        state[pre + "gate.weight"] = rand((E, D), D ** -0.5)
        for e in range(E):
            state.update({
                f"{pre}experts.{e}.w1.weight": rand((F, D), D ** -0.5),
                f"{pre}experts.{e}.w3.weight": rand((F, D), D ** -0.5),
                f"{pre}experts.{e}.w2.weight": rand((D, F), F ** -0.5)})
    return state


def convert_mixtral(dev) -> dict:
    """Random HF-named weights of MIXTRAL_CONVERT_LAYERS layers on the card
    through params_from_hf: seconds and peak memory, the tree checked
    against its source; everything freed before the return."""
    import torch

    from starway_tpu_torch.models import params_from_hf
    from starway_tpu_torch.utils.tree import tree_leaves

    cfg = mixtral_config(n_layers=MIXTRAL_CONVERT_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = mixtral_state(cfg, dev, SEED + 20, torch.bfloat16)
    torch.cuda.synchronize()
    source_gb = (torch.cuda.memory_allocated() - base) / 1e9
    t0 = time.perf_counter()
    params = params_from_hf(state, cfg, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    moe = params["layers"]["moe"]
    pre = f"model.layers.{MIXTRAL_CONVERT_LAYERS - 1}.block_sparse_moe."
    checks = (
        (moe["w_gate"][-1, 7], state[pre + "experts.7.w1.weight"].t()),
        (moe["w_in"][-1, 7], state[pre + "experts.7.w3.weight"].t()),
        (moe["w_out"][-1, 7], state[pre + "experts.7.w2.weight"].t()),
        (moe["router"][-1], state[pre + "gate.weight"].t()))
    if not all(torch.equal(got, want) for got, want in checks):
        raise AssertionError("the converted Mixtral tree differs from its "
                             "HF source")
    stats = dict(layers=cfg.n_layers, convert_s=seconds, source_gb=source_gb,
                 peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                 tree_gb=sum(t.numel() * t.element_size() for t in
                             tree_leaves(params)) / 1e9)
    del state, params, moe, checks
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  converted {cfg.n_layers} Mixtral layers (bf16): {stats}")
    return stats


class PinnedRouting:
    """The routing decisions (models/moe.py ``_route``) of one run,
    replayed in another.  In bf16 two paths that round differently may
    send a token whose router probabilities nearly tie to different
    experts: a discrete change that no tolerance on the outputs was set
    for.  :meth:`record` keeps one run's choices; :meth:`replay` sends
    every token of the next run to those experts, its gates and balance
    term from its own router probabilities (so they keep their
    gradient), and counts the choices that differ from its own."""

    def __init__(self):
        from starway_tpu_torch.models import moe

        self._moe, self._real = moe, moe._route
        self.chosen, self.flips, self.pairs = [], 0, 0

    def record(self):
        def recording(xt, router_w, k):
            out = self._real(xt, router_w, k)
            self.chosen.append(out[0])
            return out

        return mock.patch.object(self._moe, "_route", recording)

    def replay(self):
        import torch
        import torch.nn.functional as F

        choices = iter(self.chosen)

        def pinned(xt, router_w, k):
            mine = next(choices)
            with torch.no_grad():
                own = self._real(xt, router_w, k)[0]
            self.flips += int((own != mine).sum())
            self.pairs += own.numel()
            probs = torch.softmax((xt @ router_w).float(), dim=-1)
            top_i = mine.reshape(k, -1).t()
            top_p = probs.gather(1, top_i)
            if k > 1:
                top_p = top_p / top_p.sum(dim=-1, keepdim=True)
            e = router_w.shape[-1]
            aux = e * (F.one_hot(top_i[:, 0], e).float().mean(dim=0)
                       * probs.mean(dim=0)).sum()
            return mine, top_p.t().reshape(-1), aux

        return mock.patch.object(self._moe, "_route", pinned)


def check_first_logits_moe(params, cfg, prompt, max_len) -> dict:
    """:func:`check_first_logits` for an MoE model.  In bf16 the flash
    kernel and the plain attention round differently, so a token whose
    router probabilities nearly tie may take another expert on one path.
    So the plain forward runs twice: routed freely (its error and the
    routing decisions that differ from the kernel path's are logged),
    then routed as the kernel path (:class:`PinnedRouting`); that run is
    held to LOGIT_REL_TOL."""
    from starway_tpu_torch.models.generate import prefill
    from starway_tpu_torch.models.llama import forward

    padded, pb, last = first_logits_inputs(params, prompt, max_len)
    pin = PinnedRouting()
    with pin.record():
        got, _ = prefill(params, cfg, padded, pb, logit_positions=last)
    free = forward(params, padded, cfg, plain_attn,
                   logit_positions=last)[:, 0]
    with pin.replay():
        want = forward(params, padded, cfg, plain_attn,
                       logit_positions=last)[:, 0]
    out = dict(free_rel_err=((got - free).abs().max()
                             / free.abs().max()).item(),
               free_same_argmax=bool((got.argmax(-1)
                                      == free.argmax(-1)).all()),
               routing_flips=pin.flips, routed_pairs=pin.pairs)
    log(f"  MoE first-token logits, the plain path routed freely: "
        f"{out}; routed as the kernel path:")
    out["pinned_rel_err"] = compare_logits(got, want)
    return out


def router_health(params, cfg, prompt) -> dict:
    """switch_moe(with_stats=True) over one admission's prompt: every
    layer's drop fraction (0: dropless) and expert load."""
    import torch

    from starway_tpu_torch.models import forward
    from starway_tpu_torch.models.moe import switch_moe

    def stats_fn(x, router_w, w_in, w_out, w_gate=None):
        return switch_moe(x, router_w, w_in, w_out, w_gate=w_gate,
                          capacity_factor=cfg.moe_capacity_factor,
                          k=cfg.moe_top_k, with_stats=True)

    dev = params["embed"].device
    _logits, st = forward(params, torch.tensor([prompt], device=dev), cfg,
                          moe_fn=stats_fn, return_moe_stats=True,
                          last_only=True)
    load = st["expert_load"]
    out = dict(tokens=len(prompt),
               drop_fraction_max=st["drop_fraction"].max().item(),
               expert_load_min=load.min().item(),
               expert_load_max=load.max().item(),
               expert_load_layer0=[round(v, 4) for v in load[0].tolist()])
    if out["drop_fraction_max"] != 0.0:
        raise AssertionError(f"the dropless config dropped tokens: {out}")
    return out


def ep_against_global(params, cfg) -> dict:
    """make_sharded_moe on make_mesh({"ep": 4}) on cuda:0 against
    switch_moe on one layer's weights at x EP_X + [d_model] (bf16): at the
    dropless capacity both compute the same function; y within EP_REL_TOL
    of max |y|; each timed by CUDA events."""
    import torch

    from starway_tpu_torch.models.moe import make_sharded_moe, switch_moe
    from starway_tpu_torch.parallel import make_mesh

    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 200)
    x = torch.randn(*EP_X, cfg.d_model, generator=gen, device=dev).to(
        cfg.compute_dtype)
    moe = {k: v[0] for k, v in params["layers"]["moe"].items()}
    args = (x, moe["router"], moe["w_in"], moe["w_out"])
    kw = dict(capacity_factor=cfg.moe_capacity_factor, k=cfg.moe_top_k)
    ep_fn = make_sharded_moe(make_mesh({"ep": 4}, device=dev), swiglu=True,
                             **kw)
    want, aux = switch_moe(*args, w_gate=moe["w_gate"], **kw)
    got, ep_aux = ep_fn(*args, w_gate=moe["w_gate"])
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    st = dict(tokens=EP_X[0] * EP_X[1], max_abs_err=err, max_abs_y=scale,
              rel_err=err / scale, tol=EP_REL_TOL, aux=aux.item(),
              ep_aux=ep_aux.item(),
              global_ms=cuda_ms(lambda: switch_moe(
                  *args, w_gate=moe["w_gate"], **kw), iters=5),
              ep_ms=cuda_ms(lambda: ep_fn(*args, w_gate=moe["w_gate"]),
                            iters=5))
    st["ep_over_global"] = st["ep_ms"] / st["global_ms"]
    log(f"  ep=4 vs global, x [{EP_X[0]}, {EP_X[1]}, {cfg.d_model}]: {st}")
    if not (np.isfinite(err) and err <= EP_REL_TOL * scale):
        raise AssertionError("the expert-parallel MoE disagrees with the "
                             "global view")
    return st


def phase_mixtral(dev, card: str) -> tuple:
    """Phase 20: Mixtral-8x7B-v0.1 at full width (config_from_hf of its
    config.json), cut to MIXTRAL_LAYERS layers, bf16, random weights from
    init_params on the card.  Returns (stats, launch counts of the
    main-path runs)."""
    import torch

    from starway_tpu_torch.models import generate, init_params
    from starway_tpu_torch.utils.tree import tree_leaves

    cfg = mixtral_config(n_layers=MIXTRAL_LAYERS)
    log(f"[mixtral] Mixtral-8x7B-v0.1 widths ({card}), cut to {cfg.n_layers} "
        f"of {MIXTRAL_8X7B['num_hidden_layers']} layers: 32 would hold "
        f"93.4 GB of bf16 weights, more than the card; {cfg}")
    st = {"convert": convert_mixtral(dev)}
    params = init_params(cfg, SEED + 20, device=dev)
    torch.cuda.synchronize()
    st["weights_gb"] = sum(t.numel() * t.element_size()
                           for t in tree_leaves(params)) / 1e9
    log(f"  weights {st['weights_gb']:.2f} GB on the card")
    counts = {}
    reqs = make_requests(cfg)
    log(f"[mixtral] SlotServer: n_slots 8, max_len 2048, chunk 8, "
        f"{len(reqs)} requests (phase 4's traffic)")
    _done, st["serve"], srv = counted(counts, lambda: serve(params, cfg, reqs))
    del srv
    log(f"  {st['serve']}")
    for name in ("decode_attention", "flash_forward"):
        if not counts.get(name):
            raise AssertionError(f"MoE serving launched no {name} kernel")
    st["first_logits"] = check_first_logits_moe(params, cfg, reqs[0][0],
                                                2048)
    st["router"] = router_health(params, cfg, reqs[3][0])
    log(f"  router on one admission: {st['router']}")

    g = MIXTRAL_GENERATE
    rng = np.random.default_rng(SEED + 201)
    prompt = torch.tensor(rng.integers(1, cfg.vocab_size, (2, g["prompt"])),
                          device=dev)
    out, s = timed(lambda: counted(counts, lambda: generate(
        params, cfg, prompt, g["new"], prompt_lengths=list(g["lengths"]))))
    if (out.shape != (2, g["new"])
            or not bool(((out >= 0) & (out < cfg.vocab_size)).all())):
        raise AssertionError("ragged MoE generate() returned a bad batch")
    st["generate_ragged"] = dict(s=s, tokens_per_s=2 * g["new"] / s,
                                 ms_per_token=s * 1e3 / (2 * g["new"]))
    log(f"  ragged generate(), B=2 P={g['prompt']} lengths {g['lengths']}, "
        f"{g['new']} new: {st['generate_ragged']}")
    st["speculative"] = spec_runs(params, cfg, counts, **MIXTRAL_SPEC)
    st["beam"] = beam_run(params, cfg, counts, MIXTRAL_BEAM)
    st["ep"] = ep_against_global(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches {counts}")
    return st, counts


def phase_mixtral_parity(dev) -> tuple:
    """Phase 21: float32, Mixtral widths cut to 2 layers (12.7 GB): every
    serving path's greedy tokens equal generate()'s, and a droppy config
    is refused.  Returns (stats, launch counts)."""
    import torch

    from starway_tpu_torch.models import (SlotServer, draft_from_truncation,
                                          generate, generate_beam,
                                          generate_lookup,
                                          generate_speculative, init_params)

    cfg = mixtral_config(n_layers=2, dtype="float32")
    params = init_params(cfg, SEED + 21, device=dev)
    counts = {}
    reqs = make_requests(cfg, MIXTRAL_PARITY_REQS)
    done = counted(counts, lambda: serve(params, cfg, reqs)[0])
    for rid, (prompt, m, _w) in zip(done, reqs):
        want = generate(params, cfg, torch.tensor([prompt], device=dev), m,
                        max_len=2048)[0, len(prompt):].cpu().numpy()
        if not np.array_equal(done[rid], want):
            raise AssertionError(f"MoE SlotServer, request {rid}: "
                                 f"{done[rid]} != generate {want}")
    log(f"  SlotServer: {len(reqs)} requests token-for-token equal to "
        f"generate()")
    st = {"paged_parity_chunk_ms": counted(
        counts, lambda: phase_paged_parity(params, cfg))}
    if not counts.get("paged_decode_attention"):
        raise AssertionError("the MoE paged servers launched no paged kernel")

    rng = np.random.default_rng(SEED + 210)
    rows = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (700, 300)]
    padded = torch.zeros((2, 700), dtype=torch.long, device=dev)
    for b, r in enumerate(rows):
        padded[b, :len(r)] = torch.tensor(r, device=dev)
    n = 16
    ragged = counted(counts, lambda: generate(
        params, cfg, padded, n, prompt_lengths=[len(r) for r in rows]))
    for b, r in enumerate(rows):
        solo = generate(params, cfg, torch.tensor([r], device=dev), n)
        if not torch.equal(ragged[b], solo[0, len(r):]):
            raise AssertionError(f"ragged MoE row {b} != its solo run")
    log(f"  ragged generate(): rows of {[len(r) for r in rows]} equal their "
        f"solo runs")

    full = padded[:1]
    ref = generate(params, cfg, full, 24)
    draft, dcfg = draft_from_truncation(params, cfg, 1)
    for label, fn in (
            ("speculative gamma 3", lambda: generate_speculative(
                params, cfg, draft, dcfg, full, 24, gamma=3)),
            ("speculative gamma 4", lambda: generate_speculative(
                params, cfg, draft, dcfg, full, 24, gamma=4)),
            ("lookup", lambda: generate_lookup(params, cfg, full, 24)),
            ("beams=1", lambda: generate_beam(params, cfg, full, 24,
                                              beams=1))):
        got = counted(counts, fn)
        if not torch.equal(got, ref):
            raise AssertionError(f"MoE {label} != generate()")
    log("  generate_speculative (gamma 3, 4), generate_lookup and "
        "generate_beam(beams=1) equal generate() at P=700, 24 new")
    droppy = mixtral_config(n_layers=2, dtype="float32",
                            moe_capacity_factor=1.25)
    try:
        SlotServer(params, droppy, n_slots=2, max_len=64)
    except ValueError as exc:
        if "dropless" not in str(exc):
            raise
        st["droppy_refused"] = str(exc)
    else:
        raise AssertionError("SlotServer admitted a droppy MoE config")
    log(f"  a droppy config (capacity factor 1.25) is refused: "
        f"{st['droppy_refused'][:60]}...")
    del params, draft
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  launches {counts}")
    return st, counts


# ------------------------------------------------------------------
# Phases 22-24: training and serving over a mesh of several axes (one
# process holds every slot of the mesh on cuda:0).

# AdamW's update holds the parameters, the gradients, the old and the new
# moments and the updates at once: ~21 GB a layer at its peak (3 layers
# peaked at 76.24 GB of 80, too thin a margin), so 2.
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_TRAIN = dict(batch=1, seq=2048, steps=4, ep_steps=3, ep=4)
MIXTRAL_TRAIN_PARITY = dict(layers=2, seq=512)
MESH_PRESET, MESH_LAYERS = "llama3-8b", 4
MESH_BATCH = dict(batch=2, seq=2048)            # dp x tp x sp and dp x ep x tp
MESH_MOE_LAYERS = 1
FSDP_BATCH = dict(batch=8, seq=1024, slots=8)
ULYSSES = dict(b=1, hq=32, hkv=8, s=4096, d=128, sp=4)
# A bf16 sharded step against the unsharded one, each limit set from the
# H100 readings (PERF.md, PR 15): the loss (7.8e-8 to 8.6e-5), the loss
# after its AdamW update (3.3e-6 to 1.3e-4 dense, 2.0e-3 MoE routed
# freely: its update moves the near ties), and its worst gradient leaf,
# max |error| over max |gradient| (1.1e-2 to 2.1e-2: bf16 partial sums
# under tp and over the data slots; MoE routed as the sharded step).
MESH_LOSS_REL_TOL = 1e-3
MESH_AFTER_REL_TOL = 5e-3
MESH_GRAD_REL_TOL = 5e-2
TP, TP_PRESET = 2, "llama3-8b"
TP_SERVE_REQS = 6  # of phase 4's 12: phases 24 and 26 are host-bound
TP_PARITY_LAYERS = 2
TP_SPEC = dict(prompt_len=512, new=32, gamma=4)


def stats_moe_fn(cfg):
    """The global-view MoE (switch_moe at the config's capacity and k)
    with its router health, as a Trainer's ``moe_fn``."""
    from starway_tpu_torch.models.moe import switch_moe

    def fn(x, router, w_in, w_out, w_gate=None):
        return switch_moe(x, router, w_in, w_out, w_gate=w_gate,
                          capacity_factor=cfg.moe_capacity_factor,
                          k=cfg.moe_top_k, with_stats=True)

    return fn


def moe_flops(cfg, tokens: int, s_len: int) -> float:
    """Model FLOPs of one MoE training step: 6 * active weights * tokens
    (attention projections, the k routed experts, the router and the
    lm_head) plus the attention's products, without remat's recompute."""
    from starway_tpu_torch.utils.cuda_timing import visible_pairs

    hd, L, D = cfg.head_dim, cfg.n_layers, cfg.d_model
    per_layer = (D * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                 + cfg.n_heads * hd * D + cfg.moe_top_k * 3 * D * cfg.d_ff
                 + D * cfg.n_experts)
    n = L * per_layer + D * cfg.vocab_size
    attn = 12 * hd * visible_pairs(s_len, s_len) * cfg.n_heads * L * (
        tokens // s_len)
    return 6.0 * n * tokens + attn


def collective_ms(prof) -> float:
    """Device ms of the kernels launched inside the collectives' profiler
    range (ops/collectives.py RANGE), in one trace."""
    import torch

    from starway_tpu_torch.ops.collectives import RANGE

    return sum(e.device_time_total / 1e3 for e in prof.key_averages()
               if e.key == RANGE
               and e.device_type == torch.autograd.DeviceType.CPU)


def traced_run(fn):
    """``fn()`` under torch.profiler: (result, wall ms, trace summary with
    the collectives' device ms and their share of the busy time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    st = trace_summary(prof, ms)
    st["collective_device_ms"] = round(collective_ms(prof), 3)
    if st.get("device_busy_ms"):
        st["collective_share"] = (st["collective_device_ms"]
                                  / st["device_busy_ms"])
    return out, ms, st


def phase_mixtral_train(dev, card: str) -> tuple:
    """Phase 22: Mixtral-8x7B-v0.1 widths trained: MIXTRAL_TRAIN_LAYERS
    layers, bf16, AdamW, remat "dots", B=1, S=2048, capacity factor 1.25
    (drops allowed), the Trainer with the router health; then the same
    steps through make_sharded_moe over {"ep": 4} in one process; then a
    float32 2-layer step through the kernels against the plain
    attention.  Returns (stats, launch counts of the main-path runs)."""
    import torch

    from starway_tpu_torch.models import Trainer, forward, init_params
    from starway_tpu_torch.models.llama import value_and_grad
    from starway_tpu_torch.models.moe import make_sharded_moe
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.attention import blockwise_attention
    from starway_tpu_torch.parallel import make_mesh
    from starway_tpu_torch.utils import adamw

    spec = MIXTRAL_TRAIN
    B, S, L = spec["batch"], spec["seq"], MIXTRAL_TRAIN_LAYERS
    cfg = mixtral_config(n_layers=L, moe_capacity_factor=1.25, remat=True,
                         remat_policy="dots")
    params = init_params(cfg, SEED + 300, device=dev)
    batch = train_batch(cfg, B, S + 1, SEED + 301, dev)
    trainer = Trainer(cfg, adamw(LR_TRAIN), params,
                      moe_fn=stats_moe_fn(cfg), with_moe_stats=True)
    mem = fresh_peak()
    log(f"[mixtral-train] Mixtral-8x7B-v0.1 widths, {L} of 32 layers, bf16, "
        f"AdamW lr {LR_TRAIN:g}, remat dots, top-{cfg.moe_top_k} of "
        f"{cfg.n_experts} experts at capacity factor "
        f"{cfg.moe_capacity_factor}, batch [{B}, {S + 1}], {spec['steps']} "
        f"steps on one batch ({card})")
    reset_launch_counts()
    losses, step_ms, traced = train_steps(trainer, batch, spec["steps"])
    counts = launch_counts()
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        if counts[name] != spec["steps"] * L:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{spec['steps']} steps of {L} layers")
    med = statistics.median(step_ms[1:])
    flops = moe_flops(cfg, B * S, S)
    moe_stats = {k: v.float().cpu().numpy().round(4).tolist()
                 for k, v in trainer.last_moe_stats.items()}
    with torch.no_grad():
        aux = forward(trainer.state.params, batch[:, :-1], cfg,
                      return_aux=True)[1].item()
    st = dict(losses=losses, median_step_ms=med, step_ms=step_ms, **mem,
              tokens_per_s=B * S / med * 1e3,
              model_flop_share=flops / (med / 1e3) / BF16_FLOPS,
              peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
              aux_after=aux, moe_stats=moe_stats, **traced)
    if traced.get("device_busy_ms"):
        st["device_idle_share"] = 1 - traced["device_busy_ms"] / med
    log(f"  median step {med:.1f} ms, {st['tokens_per_s']:.0f} tokens/s, "
        f"model FLOP share {st['model_flop_share']:.4f}, peak "
        f"{st['peak_memory_gb']:.2f} GB, idle share "
        f"{st.get('device_idle_share')}; aux {aux:.4f}; router {moe_stats}")
    log(f"  top device operations of the traced step: "
        f"{traced.get('top_kernels_ms')}")
    state = trainer.state
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    ep_fn = make_sharded_moe(make_mesh({"ep": spec["ep"]}, device=dev),
                             k=cfg.moe_top_k, swiglu=True,
                             capacity_factor=cfg.moe_capacity_factor)
    trainer = Trainer(cfg, adamw(LR_TRAIN), state.params, moe_fn=ep_fn)
    trainer.state = state  # the run goes on with its optimizer state
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[mixtral-train] the next steps with make_sharded_moe over "
        f"{{'ep': {spec['ep']}}} in one process")
    ep_mem = fresh_peak()
    reset_launch_counts()
    ep_losses, ep_ms, ep_traced = train_steps(trainer, batch,
                                              spec["ep_steps"])
    ep_counts = launch_counts()
    counts = {k: counts[k] + ep_counts[k] for k in counts}
    assert_bwd_route(counts, True, "mixtral-train")
    ep_med = statistics.median(ep_ms[1:]) if len(ep_ms) > 1 else ep_ms[0]
    st["ep"] = dict(losses=ep_losses, median_step_ms=ep_med,
                    step_ms=ep_ms, over_global=ep_med / med,
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                    device_busy_ms=ep_traced.get("device_busy_ms"),
                    top_kernels_ms=ep_traced.get("top_kernels_ms"), **ep_mem)
    log(f"  ep: median step {ep_med:.1f} ms, {ep_med / med:.3f} x the "
        f"global view's, peak {st['ep']['peak_memory_gb']:.2f} GB")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    pspec = MIXTRAL_TRAIN_PARITY
    cfg32 = mixtral_config(n_layers=pspec["layers"], dtype="float32",
                           moe_capacity_factor=1.25, remat=True,
                           remat_policy="dots")
    params32 = init_params(cfg32, SEED + 302, device=dev)
    batch32 = train_batch(cfg32, 1, pspec["seq"] + 1, SEED + 303, dev)
    log(f"[mixtral-train-parity] float32, {pspec['layers']} layers, [1, "
        f"{pspec['seq'] + 1}]: kernels against the plain attention")
    reset_launch_counts()
    loss, grads = value_and_grad(params32, batch32, cfg32)
    torch.cuda.synchronize()
    par_counts = launch_counts()
    assert_bwd_route(par_counts, False, "mixtral-train-parity")
    counts = {k: counts[k] + par_counts[k] for k in counts}

    def plain(q, k, v):
        return blockwise_attention(q, k, v, causal=True)

    want_loss, want = value_and_grad(params32, batch32, cfg32, plain)
    loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    worst = worst_grad_rel_err(grads, want)
    router = ((grads["layers"]["moe"]["router"]
               - want["layers"]["moe"]["router"]).abs().max()
              / want["layers"]["moe"]["router"].abs().max()).item()
    log(f"  loss {loss.item():.6f} vs plain {want_loss.item():.6f} (rel "
        f"{loss_err:.2e}, tol 1e-5); worst gradient leaf {worst:.3e}, "
        f"router {router:.3e} (tol {TRAIN_GRAD_REL_TOL})")
    if not (loss_err <= 1e-5 and worst <= TRAIN_GRAD_REL_TOL
            and router <= TRAIN_GRAD_REL_TOL):
        raise AssertionError("the MoE kernel train step disagrees with the "
                             "plain-attention step")
    st["parity"] = dict(loss_rel_err=loss_err, worst_grad_rel_err=worst,
                        router_grad_rel_err=router)
    del params32, grads, want
    torch.cuda.empty_cache()
    return st, counts


def sharded_step(cfg, params, batch, attn_fn=None, moe_fn=None, runs=2):
    """``runs`` AdamW steps from the same sharded ``params`` (each to a new
    tree), the last traced: (loss, step ms of each, trace summary, the
    loss at the last step's new parameters)."""
    import torch

    from starway_tpu_torch.models.llama import loss_fn, make_train_step
    from starway_tpu_torch.utils import adamw

    tx = adamw(LR_TRAIN)
    opt = tx.init(params)
    step = make_train_step(cfg, tx, attn_fn, moe_fn, in_place=False)
    ms, loss, traced = [], None, {}
    for i in range(runs):
        if i == runs - 1:
            out, t, traced = traced_run(lambda: step(params, opt, batch))
        else:
            out, t = timed(lambda: step(params, opt, batch))
            t *= 1e3
        loss = out[2].item()
        ms.append(t)
        if i < runs - 1:
            del out
    del opt
    after = loss_fn(out[0], batch, cfg, attn_fn, moe_fn).item()
    del out
    torch.cuda.empty_cache()
    return loss, ms, traced, after


def unsharded_step(cfg, params, batch, attn_fn=None, moe_fn=None) -> dict:
    """The reference of a sharded step: the unsharded tree's loss, its
    gradients and the loss at its parameters after one AdamW step."""
    import torch

    from starway_tpu_torch.models.llama import (loss_fn, make_train_step,
                                                value_and_grad)
    from starway_tpu_torch.utils import adamw

    loss, grads = value_and_grad(params, batch, cfg, attn_fn, moe_fn)
    tx = adamw(LR_TRAIN)
    new = make_train_step(cfg, tx, attn_fn, moe_fn, in_place=False)(
        params, tx.init(params), batch)[0]
    after = loss_fn(new, batch, cfg, attn_fn, moe_fn).item()
    del new
    torch.cuda.empty_cache()
    return dict(loss=loss.item(), after=after, grads=grads)


def worst_grad_rel_err(got, want) -> float:
    """The worst leaf's max |got - want| over its max |want|, a sharded
    tree's leaves gathered one at a time."""
    if isinstance(want, dict):
        # np.max keeps a NaN (0 / 0: a leaf without gradient), so it fails.
        return float(np.max([worst_grad_rel_err(got[k], want[k])
                             for k in want]))
    g = got.full() if hasattr(got, "full") else got
    return ((g.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase_mesh_train(dev, card: str) -> tuple:
    """Phase 23: training over a mesh of several axes, every slot on
    cuda:0: llama3-8b widths cut to MESH_LAYERS layers over dp x tp x sp =
    2 x 2 x 2 (ring, then zigzag); Mixtral widths over dp x ep x tp =
    2 x 2 x 2; the ZeRO Trainer over 8 fsdp slots against the local one;
    Ulysses over sp = 4 against the unsharded flash.  Each step is held to
    the unsharded one: its loss, the loss after its AdamW update, and its
    worst gradient leaf.  Returns (stats, launch counts)."""
    import torch

    from starway_tpu_torch.models import (LlamaConfig, Trainer,
                                          init_params, param_specs)
    from starway_tpu_torch.models.llama import make_sharded_attn
    from starway_tpu_torch.models.llama import value_and_grad
    from starway_tpu_torch.models.moe import make_sharded_moe
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.attention import (SCALED_TOL,
                                                 scaled_tolerance_share)
    from starway_tpu_torch.ops.flash import flash_attention
    from starway_tpu_torch.parallel import (fsdp_specs, make_mesh,
                                            make_ulysses_attention,
                                            shard_tree)
    from starway_tpu_torch.utils import adamw

    out, counts = {}, {}

    def add(c):
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n

    def check(label, got: dict, want: dict) -> dict:
        rel = {k: abs(got[k] - want[k]) / abs(want[k])
               for k in ("loss", "after")}
        log(f"  {label}: loss {got['loss']:.5f} vs unsharded "
            f"{want['loss']:.5f} (rel {rel['loss']:.2e}, tol "
            f"{MESH_LOSS_REL_TOL}), after the update {got['after']:.5f} vs "
            f"{want['after']:.5f} (rel {rel['after']:.2e}, tol "
            f"{MESH_AFTER_REL_TOL}); worst gradient leaf "
            f"{got['grad_rel_err']:.3e} (tol {MESH_GRAD_REL_TOL})")
        if not (rel["loss"] <= MESH_LOSS_REL_TOL
                and rel["after"] <= MESH_AFTER_REL_TOL
                and got["grad_rel_err"] <= MESH_GRAD_REL_TOL):
            raise AssertionError(f"{label}: the sharded step disagrees with "
                                 f"the unsharded one")
        return dict(loss_rel_err=rel["loss"], after_rel_err=rel["after"],
                    grad_rel_err=got["grad_rel_err"])

    def run_sharded(cfg, sh, batch, want, attn_fn=None, moe_fn=None):
        """The timed steps, then the gradients, of a sharded tree."""
        loss, ms, traced, after = sharded_step(cfg, sh, batch, attn_fn,
                                               moe_fn)
        grads = value_and_grad(sh, batch, cfg, attn_fn, moe_fn)[1]
        gerr = worst_grad_rel_err(grads, want["grads"])
        del grads
        torch.cuda.empty_cache()
        return dict(loss=loss, after=after, grad_rel_err=gerr), ms, traced

    B, S = MESH_BATCH["batch"], MESH_BATCH["seq"]
    cfg = LlamaConfig.preset(MESH_PRESET, n_layers=MESH_LAYERS, remat=True,
                             remat_policy="dots")
    params = init_params(cfg, SEED + 310, device=dev)
    batch = train_batch(cfg, B, S + 1, SEED + 311, dev)
    want = unsharded_step(cfg, params, batch)
    mesh = make_mesh({"dp": 2, "tp": 2, "sp": 2}, device=dev)
    sh = shard_tree(params, mesh, param_specs(cfg))
    del params
    torch.cuda.empty_cache()
    for layout in ("ring", "zigzag"):
        mem = fresh_peak()
        log(f"[mesh-train] {MESH_PRESET} widths, {MESH_LAYERS} layers, bf16, "
            f"dp x tp x sp = 2 x 2 x 2 ({layout}) in one process, batch "
            f"[{B}, {S + 1}] ({card})")
        reset_launch_counts()
        got, ms, traced = run_sharded(
            cfg, sh, batch, want, make_sharded_attn(mesh, layout=layout))
        c = launch_counts()
        add(c)
        if not (c["flash_partial"] > 0 and c["flash_partial_bwd"] > 0):
            raise AssertionError(f"{layout}: no ring-step kernel launched")
        out[f"dp_tp_sp_{layout}"] = dict(
            **check(layout, got, want), step_ms=ms,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=c, **mem, **traced)
        log(f"  step ms {ms}, peak {out[f'dp_tp_sp_{layout}']['peak_memory_gb']:.2f} "
            f"GB, collectives {traced.get('collective_device_ms')} ms of "
            f"{traced.get('device_busy_ms')} busy (share "
            f"{traced.get('collective_share')}); launches {c}")
    del sh, want
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = mixtral_config(n_layers=MESH_MOE_LAYERS, moe_capacity_factor=1.25,
                          remat=True, remat_policy="dots")
    mparams = init_params(mcfg, SEED + 312, device=dev)
    mbatch = train_batch(mcfg, B, S + 1, SEED + 313, dev)
    mesh = make_mesh({"dp": 2, "ep": 2, "tp": 2}, device=dev)
    moe_fn = make_sharded_moe(mesh, k=mcfg.moe_top_k, swiglu=True,
                              capacity_factor=mcfg.moe_capacity_factor)
    want = unsharded_step(mcfg, mparams, mbatch, moe_fn=moe_fn)
    sh = shard_tree(mparams, mesh, param_specs(mcfg))
    torch.cuda.empty_cache()
    mem = fresh_peak()
    log(f"[mesh-train] Mixtral widths, {MESH_MOE_LAYERS} layer, bf16, dp x "
        f"ep x tp = 2 x 2 x 2, make_sharded_moe top-{mcfg.moe_top_k}")
    reset_launch_counts()
    loss, ms, traced, after = sharded_step(mcfg, sh, mbatch, moe_fn=moe_fn)
    pin = PinnedRouting()
    with pin.record():
        grads = value_and_grad(sh, mbatch, mcfg, None, moe_fn)[1]
    c = launch_counts()
    add(c)
    free = worst_grad_rel_err(grads, want.pop("grads"))
    with pin.replay():
        pinned = value_and_grad(mparams, mbatch, mcfg, None, moe_fn)[1]
    got = dict(loss=loss, after=after,
               grad_rel_err=worst_grad_rel_err(grads, pinned))
    del grads, pinned, mparams
    log(f"  gradients against the unsharded step's routed freely: worst "
        f"leaf {free:.3e}, {pin.flips} of {pin.pairs} routing choices "
        f"differ; held routed as the sharded step:")
    out["dp_ep_tp"] = dict(**check("dp x ep x tp", got, want),
                           free_grad_rel_err=free, routing_flips=pin.flips,
                           routed_pairs=pin.pairs, step_ms=ms,
                           peak_memory_gb=torch.cuda.max_memory_allocated()
                           / 1e9, launches=c, **mem, **traced)
    log(f"  step ms {ms}, collectives {traced.get('collective_device_ms')} "
        f"ms of {traced.get('device_busy_ms')} busy; launches {c}")
    del sh, want
    gc.collect()
    torch.cuda.empty_cache()

    fb, fs, slots = FSDP_BATCH["batch"], FSDP_BATCH["seq"], FSDP_BATCH["slots"]
    params = init_params(cfg, SEED + 314, device=dev)
    fbatch = train_batch(cfg, fb, fs + 1, SEED + 315, dev)
    fmesh = make_mesh({"fsdp": slots}, device=dev)
    mem = fresh_peak()
    log(f"[mesh-train] ZeRO over {{'fsdp': {slots}}} in one process (every "
        f"slot's 1/{slots} beside the others: no memory saved on one card), "
        f"batch [{fb}, {fs + 1}]: the gradients of the sharded tree, then "
        f"two steps of the ZeRO Trainer against two of the local one")
    reset_launch_counts()
    grads = value_and_grad(params, fbatch, cfg)[1]
    fsh = shard_tree(params, fmesh, fsdp_specs(params, fmesh))
    gerr = worst_grad_rel_err(value_and_grad(fsh, fbatch, cfg)[1], grads)
    del grads, fsh
    torch.cuda.empty_cache()
    local = Trainer(cfg, adamw(LR_TRAIN), params, donate=False)
    want = [local.step_sync(fbatch) for _ in range(2)]
    del local
    torch.cuda.empty_cache()
    zt = Trainer(cfg, adamw(LR_TRAIN), params, mesh=fmesh, fsdp_axis="fsdp")
    del params
    first, ms1 = timed(lambda: zt.step_sync(fbatch))
    second, ms2, traced = traced_run(lambda: zt.step_sync(fbatch))
    c = launch_counts()
    add(c)
    out["fsdp"] = dict(**check("fsdp", dict(loss=first, after=second,
                                            grad_rel_err=gerr),
                               dict(loss=want[0], after=want[1])),
                       losses=[first, second], step_ms=[ms1 * 1e3, ms2],
                       peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches=c, **mem, **traced)
    log(f"  step ms {out['fsdp']['step_ms']}, collectives "
        f"{traced.get('collective_device_ms')} ms of "
        f"{traced.get('device_busy_ms')} busy")
    del zt
    gc.collect()
    torch.cuda.empty_cache()

    u = ULYSSES
    gen = torch.Generator(device=dev).manual_seed(SEED + 316)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_()

    q, k, v = (randn(u["b"], h, u["s"], u["d"])
               for h in (u["hq"], u["hkv"], u["hkv"]))
    w = randn(u["b"], u["hq"], u["s"], u["d"]).detach()
    ul = make_ulysses_attention(make_mesh({"sp": u["sp"]}, device=dev))
    log(f"[mesh-train] Ulysses over sp = {u['sp']}: q [{u['b']}, "
        f"{u['hq']}, {u['s']}, {u['d']}], grouped kv {u['hkv']} heads, bf16, "
        f"forward and backward against the unsharded flash")

    def run(fn):
        with torch.enable_grad():
            o = fn(q, k, v)
            g = torch.autograd.grad((o.float() * w.float()).sum(), (q, k, v))
        return o.detach(), g

    reset_launch_counts()
    (got, g_got), ul_ms, traced = traced_run(lambda: run(ul))
    c = launch_counts()
    add(c)
    if not (c["flash_forward"] == u["sp"] and c["flash_backward_dq"]
            == u["sp"] and c["flash_backward_dkv"] == u["sp"]):
        raise AssertionError(f"Ulysses launched {c}, not one flash forward "
                             f"and backward a slot")
    want_o, g_want = run(lambda a, b, c_: flash_attention(a, b, c_,
                                                          causal=True))
    flash_ms = timed(lambda: run(lambda a, b, c_: flash_attention(
        a, b, c_, causal=True)))[1] * 1e3
    ul_ms2 = timed(lambda: run(ul))[1] * 1e3
    err = (got.float() - want_o.float()).abs().max().item()
    share = scaled_tolerance_share(got, want_o)
    gerr = max(((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
               for a, b in zip(g_got, g_want))
    log(f"  output max_abs_err {err:.3e}, {share:.3f} of the limit "
        f"{SCALED_TOL[0]:g} |want| + {SCALED_TOL[1]:g} rms of want's row "
        f"(<= 1), worst gradient rel {gerr:.3e} (tol "
        f"{GRAD_REL_TOL['bfloat16']}); fwd+bwd {ul_ms2:.2f} ms against the "
        f"unsharded flash's {flash_ms:.2f} ms; collectives "
        f"{traced.get('collective_device_ms')} ms of "
        f"{traced.get('device_busy_ms')} busy")
    if not (share <= 1.0 and gerr <= GRAD_REL_TOL["bfloat16"]):
        raise AssertionError("Ulysses disagrees with the unsharded flash")
    out["ulysses"] = dict(max_abs_err=err, tol_share=share,
                          grad_rel_err=gerr, ms=ul_ms2,
                          flash_ms=flash_ms, launches=c,
                          collective_device_ms=traced.get(
                              "collective_device_ms"),
                          device_busy_ms=traced.get("device_busy_ms"))
    return out, counts


def first_decode_logits(tree, cfg, prompt, token):
    """Logits of the first decode step after one request's admission:
    the prompt prefilled at its bucket (an int8 cache quantized), then
    ``token`` decoded at the next position through the decode kernel."""
    import torch

    from starway_tpu_torch.models.generate import decode_step, prefill

    padded, pb, last = first_logits_inputs(tree, prompt, 2048)
    _, cache = prefill(tree, cfg, padded, pb + 16, logit_positions=last)
    return decode_step(tree, cache, torch.tensor([token], device=last.device),
                       len(prompt), cfg)[0]


def phase_tp_serve(dev, card: str, reqs, done4, st4, st5) -> tuple:
    """Phase 24: SlotServer over a llama3-8b tree sharded {"tp": 2} in one
    process, 32 layers, phase 4's 12 requests: bf16, int8 KV, then the
    W8A16 tree of quantized_param_specs with int8 KV (phase 7's); the
    first decode step's logits of each format against the unsharded tree
    of that format (bf16's first logits too); tokens beside phase 4's;
    then float32 at 2 layers: the tp server and tp speculative decoding
    against greedy generate(), token for token.  Returns (stats, launch
    counts)."""
    import torch

    from starway_tpu_torch.models import (LlamaConfig, generate,
                                          generate_speculative, init_params,
                                          param_specs,
                                          quantized_param_specs)
    from starway_tpu_torch.models.generate import prefill
    from starway_tpu_torch.models.speculative import draft_from_truncation
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.gemv import int8_matmul
    from starway_tpu_torch.ops.quantize import quantize_params
    from starway_tpu_torch.parallel import make_mesh, shard_tree

    out, counts = {}, {}
    mesh = make_mesh({"tp": TP}, device=dev)
    cfg = LlamaConfig.preset(TP_PRESET)
    cfg8 = LlamaConfig.preset(TP_PRESET, kv_quant="int8")
    params = init_params(cfg, SEED, device=dev)  # phase 4's model
    sh = shard_tree(params, mesh, param_specs(cfg))

    def first_logits(tree, c):
        padded, pb, last = first_logits_inputs(params, reqs[0][0], 2048)
        return prefill(tree, c, padded, pb, logit_positions=last)[0]

    def decode_check(label, got_tree, c, want):
        log(f"  {label}, the first decode step against the unsharded "
            f"tree's:")
        return compare_logits(first_decode_logits(got_tree, c, reqs[0][0],
                                                  token), want)

    want_first = first_logits(params, cfg)
    token = int(want_first.argmax(-1)[0])
    want_decode = {label: first_decode_logits(params, c, reqs[0][0], token)
                   for label, c in (("bf16", cfg), ("int8-kv", cfg8))}
    for label, c, want_st in (("bf16", cfg, st4), ("int8-kv", cfg8, None)):
        log(f"[tp-serve] {TP_PRESET}, {cfg.n_layers} layers, over {{'tp': {TP}}} in one "
            f"process ({label}), phase 4's {len(reqs)} requests ({card})")
        reset_launch_counts()
        # Only bf16's chunk is traced: the profiler takes ~12 s a trace.
        done, st = serve(sh, c, reqs, trace=label == "bf16")[:2]
        cnt = launch_counts()
        for k, n in cnt.items():
            counts[k] = counts.get(k, 0) + n
        if not (cnt["decode_attention"] > 0 and cnt["flash_forward"] > 0):
            raise AssertionError("tp serving launched no decode or flash "
                                 "kernel")
        agree = sum(int((a == b).sum()) for a, b in zip(done.values(),
                                                        done4))
        total = sum(len(b) for b in done4)
        if label == "bf16":
            st["first_logits_rel_err"] = compare_logits(
                first_logits(sh, c), want_first)
        st.update(tokens_equal_to_phase4=agree, of=total, launches=cnt,
                  decode_logits_rel_err=decode_check(label, sh, c,
                                                     want_decode[label]))
        log(f"  {st['tokens_per_s']:.1f} tokens/s (phase 4, unsharded: "
            f"{st4['tokens_per_s']:.1f}); tokens equal to phase 4's "
            f"{agree} of {total}; launches {cnt}")
        out[label] = st
    del sh
    torch.cuda.empty_cache()
    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    want_w8 = first_decode_logits(qparams, cfg8, reqs[0][0], token)
    sq = shard_tree(qparams, mesh, quantized_param_specs(cfg))
    del qparams
    torch.cuda.empty_cache()
    log("[tp-serve] W8A16 tree over tp + int8 KV, the same requests")
    reset_launch_counts()
    done, st = serve(sq, cfg8, reqs, trace=False)[:2]
    cnt = launch_counts()
    by_regime = dict(int8_matmul.regime_launches)
    for k, n in cnt.items():
        counts[k] = counts.get(k, 0) + n
    if not (cnt["int8_matmul"] > 0 and by_regime["decode"] > 0):
        raise AssertionError("the tp W8A16 run did not launch the GEMV")
    st.update(launches=cnt, gemv_by_regime=by_regime,
              decode_logits_rel_err=decode_check("W8A16 + int8 KV", sq, cfg8,
                                                 want_w8))
    log(f"  {st['tokens_per_s']:.1f} tokens/s (phase 7, unsharded: "
        f"{st5['tokens_per_s']:.1f}); launches {cnt}, GEMV by regime "
        f"{by_regime}")
    out["w8a16-int8-kv"] = st
    del sq
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = LlamaConfig.preset(TP_PRESET, n_layers=TP_PARITY_LAYERS,
                               dtype="float32")
    p32 = init_params(cfg32, SEED + 320, device=dev)
    s32 = shard_tree(p32, mesh, param_specs(cfg32))
    log(f"[tp-parity] float32, {TP_PARITY_LAYERS} layers over tp = {TP}: "
        f"SlotServer and speculative decoding against greedy generate()")
    small = reqs[:4]
    reset_launch_counts()
    done = serve(s32, cfg32, small)[0]
    for (prompt, m, _w), got in zip(small, done.values()):
        want = generate(p32, cfg32, torch.tensor([prompt], device=dev), m,
                        max_len=2048)[0, len(prompt):].cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"the tp server diverged from generate(): "
                                 f"{got} != {want}")
    sp = TP_SPEC
    rng = np.random.default_rng(SEED + 321)
    prompt = torch.tensor(rng.integers(1, cfg32.vocab_size,
                                       (1, sp["prompt_len"])), device=dev)
    draft, dcfg = draft_from_truncation(p32, cfg32, 1)
    sdraft = shard_tree(draft, mesh, param_specs(dcfg))
    ref = generate(s32, cfg32, prompt, sp["new"])
    toks, stats = generate_speculative(s32, cfg32, sdraft, dcfg, prompt,
                                       sp["new"], gamma=sp["gamma"],
                                       return_stats=True)
    cnt = launch_counts()
    for k, n in cnt.items():
        counts[k] = counts.get(k, 0) + n
    if not torch.equal(toks, ref):
        raise AssertionError("tp speculative decoding diverged from tp "
                             "greedy generate()")
    out["parity"] = dict(server_requests_equal=len(small),
                         speculative_equal=True,
                         accepted=int(stats["accepted"].sum()),
                         macro_steps=int(stats["macro_steps"].sum()),
                         launches=cnt)
    log(f"  {len(small)} requests and the speculative run (gamma "
        f"{sp['gamma']}, {sp['new']} tokens) token for token; {out['parity']}")
    del p32, s32, draft, sdraft
    torch.cuda.empty_cache()
    return out, counts


DPTP = {"dp": 2, "tp": 2}
DPTP_PARITY_REQS = 4


def dptp_decode_logits(tree, cfg, prompt, token):
    """:func:`first_decode_logits` of a tree over the data axes: the same
    request in each data group's row (the batch must split over them)."""
    import torch

    from starway_tpu_torch.models.generate import decode_step, prefill

    padded, pb, last = first_logits_inputs(tree, prompt, 2048)
    rows = DPTP["dp"]
    _, cache = prefill(tree, cfg, padded.repeat(rows, 1), pb + 16,
                       logit_positions=last.repeat(rows))
    return decode_step(tree, cache,
                       torch.full((rows,), token, device=last.device),
                       len(prompt), cfg)[0]


def held_gb(tree) -> float:
    """GB of the distinct tensors a tree holds (a data group's view and
    the replicas over dp share theirs)."""
    from starway_tpu_torch.models.sharded import _walk

    seen, n = set(), 0
    for leaf in _walk(tree):
        for t in (leaf.tree_children() if hasattr(leaf, "shards")
                  else [leaf]):
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                n += t.numel() * t.element_size()
    return n / 1e9


def phase_dptp_serve(dev, card: str, reqs, done4, st4, st5,
                     st_tp) -> tuple:
    """Phase 26: SlotServer over a llama3-8b tree sharded {"dp": 2, "tp":
    2} in one process, 32 layers, phase 4's 12 requests on 8 slots (4 a
    data group, 16 q / 4 kv heads a slot): bf16, then the W8A16 tree of
    quantized_param_specs with int8 KV; the first decode step's logits
    of both data groups against the unsharded tree's; tokens/s beside
    tp-serve's (phase 24) and the unsharded server's (phases 4 and 7)
    and the peak memory (the unsharded tree beside the sharded one), both
    runs untraced (a traced chunk of 4 slot bodies a layer costs the
    profiler ~35-50 s to process; phase 24 traces tp's); then
    float32 at 2 layers: the dp x tp server against greedy generate() of
    the unsharded tree, and dp x tp speculative decoding on a batch of two
    against dp x tp generate().
    Returns (stats, launch counts)."""
    import torch

    from starway_tpu_torch.models import (LlamaConfig, generate,
                                          generate_speculative, init_params,
                                          param_specs,
                                          quantized_param_specs)
    from starway_tpu_torch.models.speculative import draft_from_truncation
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.ops.gemv import int8_matmul
    from starway_tpu_torch.ops.quantize import quantize_params
    from starway_tpu_torch.parallel import make_mesh, shard_tree

    out, counts = {}, {}
    mesh = make_mesh(DPTP, device=dev)
    cfg = LlamaConfig.preset(TP_PRESET)
    cfg8 = LlamaConfig.preset(TP_PRESET, kv_quant="int8")
    params = init_params(cfg, SEED, device=dev)  # phase 4's model
    token = None

    def run(label, tree, c, want_tree, base, base_label, trace):
        nonlocal token
        log(f"[dptp-serve] {TP_PRESET}, {c.n_layers} layers, over {DPTP} in "
            f"one process ({label}), phase 4's {len(reqs)} requests on 8 "
            f"slots ({card})")
        if token is None:
            padded, pb, last = first_logits_inputs(want_tree, reqs[0][0],
                                                   2048)
            from starway_tpu_torch.models.generate import prefill

            token = int(prefill(want_tree, c, padded, pb,
                                logit_positions=last)[0].argmax(-1)[0])
        want = first_decode_logits(want_tree, c, reqs[0][0], token)
        got = dptp_decode_logits(tree, c, reqs[0][0], token)
        log(f"  {label}, the first decode step of each data group against "
            f"the unsharded tree's:")
        errs = [compare_logits(got[g:g + 1], want) for g in range(got.shape[0])]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        done, st = serve(tree, c, reqs, trace=trace)[:2]
        cnt = launch_counts()
        for k, n in cnt.items():
            counts[k] = counts.get(k, 0) + n
        if not (cnt["decode_attention"] > 0 and cnt["flash_forward"] > 0):
            raise AssertionError("dp x tp serving launched no decode or "
                                 "flash kernel")
        agree = sum(int((a == b).sum()) for a, b in zip(done.values(),
                                                        done4))
        total = sum(len(b) for b in done4)
        st.update(tokens_equal_to_phase4=agree, of=total, launches=cnt,
                  decode_logits_rel_err=errs, weights_gb=held_gb(tree),
                  peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                  tp_serve_tokens_per_s=st_tp[base_label]["tokens_per_s"],
                  unsharded_tokens_per_s=base["tokens_per_s"])
        log(f"  {st['tokens_per_s']:.1f} tokens/s (tp-serve "
            f"{st['tp_serve_tokens_per_s']:.1f}, unsharded "
            f"{st['unsharded_tokens_per_s']:.1f}); weights held "
            f"{st['weights_gb']:.2f} GB, peak {st['peak_memory_gb']:.2f} GB; "
            f"tokens equal to phase 4's {agree} of {total}; launches {cnt}")
        return st

    sh = shard_tree(params, mesh, param_specs(cfg))
    out["bf16"] = run("bf16", sh, cfg, params, st4, "bf16", trace=False)
    del sh
    qparams = quantize_params(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    sq = shard_tree(qparams, mesh, quantized_param_specs(cfg))
    st = run("W8A16 + int8 KV", sq, cfg8, qparams, st5, "w8a16-int8-kv",
             trace=False)
    by_regime = dict(int8_matmul.regime_launches)
    if not (st["launches"]["int8_matmul"] > 0 and by_regime["decode"] > 0):
        raise AssertionError("the dp x tp W8A16 run did not launch the GEMV")
    st["gemv_by_regime"] = by_regime
    out["w8a16-int8-kv"] = st
    del sq, qparams
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = LlamaConfig.preset(TP_PRESET, n_layers=TP_PARITY_LAYERS,
                               dtype="float32")
    p32 = init_params(cfg32, SEED + 320, device=dev)
    s32 = shard_tree(p32, mesh, param_specs(cfg32))
    log(f"[dptp-parity] float32, {TP_PARITY_LAYERS} layers over {DPTP}: "
        f"SlotServer against greedy generate() of the unsharded tree, "
        f"speculative decoding on a batch of two against dp x tp "
        f"generate()")
    small = reqs[:DPTP_PARITY_REQS]
    reset_launch_counts()
    done = serve(s32, cfg32, small)[0]
    for (prompt, m, _w), got in zip(small, done.values()):
        want = generate(p32, cfg32, torch.tensor([prompt], device=dev), m,
                        max_len=2048)[0, len(prompt):].cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"the dp x tp server diverged from "
                                 f"generate(): {got} != {want}")
    sp = TP_SPEC
    rng = np.random.default_rng(SEED + 322)
    prompt = torch.tensor(rng.integers(1, cfg32.vocab_size,
                                       (DPTP["dp"], sp["prompt_len"])),
                          device=dev)
    draft, dcfg = draft_from_truncation(p32, cfg32, 1)
    sdraft = shard_tree(draft, mesh, param_specs(dcfg))
    ref = generate(s32, cfg32, prompt, sp["new"])
    toks, stats = generate_speculative(s32, cfg32, sdraft, dcfg, prompt,
                                       sp["new"], gamma=sp["gamma"],
                                       return_stats=True)
    cnt = launch_counts()
    for k, n in cnt.items():
        counts[k] = counts.get(k, 0) + n
    if not torch.equal(toks, ref):
        raise AssertionError("dp x tp speculative decoding diverged from "
                             "dp x tp greedy generate()")
    out["parity"] = dict(server_requests_equal=len(small),
                         speculative_equal=True,
                         accepted=int(stats["accepted"].sum()),
                         macro_steps=int(stats["macro_steps"].sum()),
                         launches=cnt)
    log(f"  {len(small)} requests and the speculative run (batch "
        f"{DPTP['dp']}, gamma {sp['gamma']}, {sp['new']} tokens) token for "
        f"token; {out['parity']}")
    del p32, s32, draft, sdraft
    torch.cuda.empty_cache()
    return out, counts


# ------------------------------------------------------------ mesh-serve

MESH_SERVE_PRESET = "llama3-8b"
MESH_SERVE_TP = {"tp": 2}
MESH_SERVE_EP = {"ep": 2, "tp": 2}
MIXTRAL_EP_LAYERS = 6      # of 32: 17.8 GB of bf16 weights, twice held
# The requests rolling-tp serves, indices into PARITY_REQS (phase 19's
# three at their budgets: 4000 + 160 wraps the cache, 4500 starts past
# it), the 700-token one twice to fill the four slots.
MESH_ROLLING = (0, 1, 2, 2)
MIXTRAL_EP_REQS = 6
MESH_PARITY_LAYERS = 2
# Aligned generate() of the Mixtral tree at a capacity that drops tokens,
# over dp x ep x tp: 3 rows of 64 tokens, 8 new.
MESH_DROP_CAPACITY = 1.25
MESH_DROP_BATCH = (3, 64, 8)
MESH_PARITY_MESHES = (("dp x ep x tp", {"dp": 2, "ep": 2, "tp": 2}),
                      ("dp x tp x sp", {"dp": 2, "tp": 2, "sp": 2}),
                      ("fsdp = 4, paged", {"fsdp": 4}),
                      ("3 slots over dp x tp", {"dp": 2, "tp": 2}))


def first_paged_logits(tree, cfg, prompt, token):
    """Logits of the first decode step after one request's admission into
    a PagedSlotServer (page 64): the prompt prefilled at its bucket and
    filed into pool pages, then ``token`` decoded at the next position
    through the paged kernel."""
    import torch

    from starway_tpu_torch.models import PagedSlotServer

    page, max_len = 64, 4096
    srv = PagedSlotServer(tree, cfg, n_slots=1, max_len=max_len, page=page,
                          n_pages=1 + max_len // page)
    prompt = np.asarray(prompt, np.int64)
    srv._admit_plain(0, prompt)
    srv._alloc_to(0, -(-(len(prompt) + 1) // page))
    srv._table_dev.copy_(torch.from_numpy(srv._tables))
    dev = srv.device
    return srv._decode_one(srv.cache, torch.tensor([token], device=dev),
                           torch.tensor([len(prompt)], dtype=torch.int32,
                                        device=dev))[0]


def no_ep_gather():
    """A context that fails a gather along ``"ep"``: the expert leaves of
    a serving tree over ep stay split (each slot runs its own)."""
    from starway_tpu_torch.ops import collectives

    real = collectives.all_gather

    def guarded(shards, mesh, axis, *a, **kw):
        if axis == "ep":
            raise AssertionError("a serving tree over ep gathered along ep")
        return real(shards, mesh, axis, *a, **kw)

    return mock.patch.object(collectives, "all_gather", guarded)


def phase_mesh_serve(dev, card: str, st_paged) -> tuple:
    """Phase 29: serving every sharded tree the JAX package serves, all
    slots on cuda:0.  (a) PagedSlotServer over a llama3-8b tree sharded
    {"tp": 2} (32 layers, bf16, phase 5's traffic: 16 slots, page 64, the
    1000-token prompt, 24 requests): the first decode step's logits
    against the unsharded paged server's, pages in use equal to phase 5's
    after every step, #9's launches (2 slots x 32 layers a decode step and
    prefixed admission), tokens/s beside phase 5's; then the W8A16 tree,
    untraced.  (b) the rolling SlotServer over a Mistral-7B tree sharded
    {"tp": 2} (32 layers, window 4096) on four of phase 19's requests
    (MESH_ROLLING: 4000 + 160 wraps the cache): the rolling admission's
    logits against the unsharded tree's, tokens/s.  (c) Mixtral-8x7B
    widths cut to 8 layers over {"ep": 2, "tp": 2}, dropless: the first
    decode step's logits against the
    unsharded tree's (routing pinned, as phase 20), SlotServer and
    PagedSlotServer with no gather along ep, and the peak memory beside
    the two trees.  (d) float32 at 2 layers: greedy tokens equal to the
    unsharded generate() over dp x ep x tp, dp x tp x sp, the fsdp_specs
    tree over fsdp = 4 (paged) and 3 slots over dp x tp; over dp x ep x tp
    also aligned generate() at a capacity that drops tokens.  Returns
    (stats, launch counts)."""
    import torch

    from starway_tpu_torch.models import (LlamaConfig, PagedSlotServer,
                                          SlotServer, generate, init_params,
                                          param_specs,
                                          quantized_param_specs)
    from starway_tpu_torch.models.generate import prefill
    from starway_tpu_torch.models.serving import _rolling_prefill_state
    from starway_tpu_torch.ops.quantize import quantize_params
    from starway_tpu_torch.parallel import fsdp_specs, make_mesh, shard_tree

    out, counts = {}, {}
    t0 = time.perf_counter()

    # (a) paged-tp, bf16 and W8A16
    cfg = LlamaConfig.preset(MESH_SERVE_PRESET)
    params = init_params(cfg, SEED, device=dev)  # phase 4's model
    mesh = make_mesh(MESH_SERVE_TP, device=dev)
    prefix, reqs = make_paged_requests(cfg)
    n_prefixed = sum(w for _p, _m, w in reqs)
    padded, pb, last = first_logits_inputs(params, reqs[0][0], 4096)
    token = int(prefill(params, cfg, padded, pb,
                        logit_positions=last)[0].argmax(-1)[0])
    want = first_paged_logits(params, cfg, reqs[0][0], token)
    sh = shard_tree(params, mesh, param_specs(cfg))
    kw = dict(server=PagedSlotServer, prefix=prefix, n_slots=16,
              max_len=4096, chunk=8, page=64, n_pages=16 * 33 + 1,
              trace=False)

    def paged_run(label, tree, c, want_logits):
        log(f"[mesh-serve] paged-tp ({label}): {MESH_SERVE_PRESET}, "
            f"{c.n_layers} layers, over {MESH_SERVE_TP} in one process, "
            f"phase 5's traffic "
            f"({len(reqs)} requests, the {len(prefix)}-token prompt; "
            f"{card})")
        log(f"  {label}, the first decode step against the unsharded paged "
            f"server's:")
        err = compare_logits(first_paged_logits(tree, c, reqs[0][0], token),
                             want_logits)
        cnt = {}
        _done, st, srv = counted(cnt, lambda: serve(tree, c, reqs, **kw))
        for k, n in cnt.items():
            counts[k] = counts.get(k, 0) + n
        steps = 8 * len(srv.chunk_ms)
        want_n = MESH_SERVE_TP["tp"] * c.n_layers * (steps + n_prefixed)
        if cnt["paged_decode_attention"] != want_n:
            raise AssertionError(
                f"paged_decode_attention launched "
                f"{cnt['paged_decode_attention']} times, not 2 slots x "
                f"{c.n_layers} layers x ({steps} decode steps + "
                f"{n_prefixed} prefixed admissions) = {want_n}")
        if cnt["decode_attention"] or not cnt["flash_forward"]:
            raise AssertionError("paged-tp must decode through the paged "
                                 "kernel only and prefill through flash")
        if srv.pages_steps != st_paged["pages_in_use_steps"]:
            raise AssertionError(
                f"pages in use after each step {srv.pages_steps} differ "
                f"from the unsharded server's "
                f"{st_paged['pages_in_use_steps']}")
        del srv
        st.pop("pages_in_use_steps")
        st.update(first_decode_logits_rel_err=err, launches=cnt,
                  paged_launches_per_decode_step=2 * c.n_layers,
                  phase5_tokens_per_s=st_paged["tokens_per_s"],
                  pages_in_use_equal_steps=len(st_paged[
                      "pages_in_use_steps"]))
        log(f"  {st['tokens_per_s']:.1f} tokens/s (phase 5, unsharded: "
            f"{st_paged['tokens_per_s']:.1f}); pages in use equal to phase "
            f"5's at all {st['pages_in_use_equal_steps']} steps; launches "
            f"{cnt}")
        return st

    out["paged-tp"] = paged_run("bf16", sh, cfg, want)
    del sh
    qparams = quantize_params(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    want = first_paged_logits(qparams, cfg, reqs[0][0], token)
    sq = shard_tree(qparams, mesh, quantized_param_specs(cfg))
    del qparams
    out["paged-tp-w8a16"] = paged_run("W8A16", sq, cfg, want)
    if not counts.get("int8_matmul/decode"):
        raise AssertionError("the W8A16 paged-tp run launched no GEMV")
    del sq
    gc.collect()
    torch.cuda.empty_cache()
    out["paged_s"] = time.perf_counter() - t0

    # (b) rolling-tp, Mistral-7B widths
    t1 = time.perf_counter()
    mcfg = mistral_config()
    params = init_params(mcfg, SEED + 29, device=dev)
    rng = np.random.default_rng(SEED + 19)  # phase 19's prompts
    drawn = [rng.integers(1, mcfg.vocab_size, n).tolist()
             for n, _m in PARITY_REQS]
    rreqs = [(drawn[i], PARITY_REQS[i][1], False) for i in MESH_ROLLING]
    sh = shard_tree(params, mesh, param_specs(mcfg))
    short = min((p for p, _m, _w in rreqs), key=len)
    log(f"[mesh-serve] rolling-tp: Mistral-7B widths, {mcfg.n_layers} "
        f"layers, window {mcfg.sliding_window}, over {MESH_SERVE_TP}; "
        f"requests {[(len(p), m) for p, m, _w in rreqs]} (prompt, budget) "
        f"of phase 19's ({card})")
    log(f"  the rolling admission's logits at P={len(short)} against the "
        f"unsharded tree's:")
    err = compare_logits(_rolling_prefill_state(sh, mcfg, short)[0],
                         _rolling_prefill_state(params, mcfg, short)[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cnt = {}
    _done, st, srv = counted(cnt, lambda: serve(
        sh, mcfg, rreqs, n_slots=4, max_len=PARITY_HORIZON, trace=False))
    shape = tuple(srv.cache["k"].shape)
    parts = [tuple(p.shape) for p in srv.cache["k"].parts]
    del srv, sh
    for k, n in cnt.items():
        counts[k] = counts.get(k, 0) + n
    if not cnt["decode_attention"] or parts != [
            (mcfg.n_layers, 4, mcfg.n_kv_heads // 2, mcfg.sliding_window,
             mcfg.head_dim)] * 2:
        raise AssertionError(f"the rolling tp run: launches {cnt}, cache "
                             f"parts {parts}")
    st.update(admission_logits_rel_err=err, launches=cnt, cache=shape,
              cache_parts=parts, s=time.perf_counter() - t1)
    log(f"  {st['tokens_per_s']:.1f} tokens/s; cache {shape} as parts "
        f"{parts}; launches {cnt}")
    out["rolling-tp"] = st
    gc.collect()
    torch.cuda.empty_cache()

    # (c) mixtral-ep
    t2 = time.perf_counter()
    xcfg = mixtral_config(n_layers=MIXTRAL_EP_LAYERS)
    params = init_params(xcfg, SEED + 29, device=dev)
    emesh = make_mesh(MESH_SERVE_EP, device=dev)
    sh = shard_tree(params, emesh, param_specs(xcfg))
    torch.cuda.synchronize()
    st = dict(weights_gb=held_gb(params), sharded_weights_gb=held_gb(sh))
    expert_gb = (3 * xcfg.n_experts * xcfg.d_model * xcfg.d_ff * 2) / 1e9
    xreqs = make_requests(xcfg, MIXTRAL_EP_REQS)
    log(f"[mesh-serve] mixtral-ep: Mixtral-8x7B widths cut to "
        f"{xcfg.n_layers} of 32 layers, dropless, over {MESH_SERVE_EP}; "
        f"the unsharded tree {st['weights_gb']:.2f} GB and the sharded "
        f"{st['sharded_weights_gb']:.2f} GB on the card ({card})")
    padded, pb, last = first_logits_inputs(params, xreqs[0][0], 2048)
    tok = int(prefill(params, xcfg, padded, pb,
                      logit_positions=last)[0].argmax(-1)[0])
    pin = PinnedRouting()
    with pin.record():
        want = first_decode_logits(params, xcfg, xreqs[0][0], tok)
    with pin.replay(), no_ep_gather():
        got = first_decode_logits(sh, xcfg, xreqs[0][0], tok)
    log(f"  the first decode step against the unsharded tree's, routed as "
        f"it ({pin.flips} of {pin.pairs} choices differ when routed "
        f"freely):")
    st.update(first_decode_logits_rel_err=compare_logits(got, want),
              routing_flips=pin.flips, routed_pairs=pin.pairs)
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for label, server, extra in (
            ("SlotServer", SlotServer, {}),
            ("PagedSlotServer", PagedSlotServer,
             dict(page=64, n_pages=8 * 32 + 1))):
        cnt = {}
        with no_ep_gather():
            _done, sst = counted(cnt, lambda: serve(
                sh, xcfg, xreqs, server=server, trace=False, **extra))[:2]
        for k, n in cnt.items():
            counts[k] = counts.get(k, 0) + n
        kernel = ("paged_decode_attention" if server is PagedSlotServer
                  else "decode_attention")
        if not (cnt[kernel] and cnt["flash_forward"]):
            raise AssertionError(f"mixtral-ep {label} launched no {kernel} "
                                 f"or flash kernel")
        sst["launches"] = cnt
        st[label] = sst
        log(f"  {label}: {sst['tokens_per_s']:.1f} tokens/s, {len(xreqs)} "
            f"requests; launches {cnt}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    st.update(resident_gb=base / 1e9, peak_gb=peak / 1e9,
              peak_over_resident_gb=(peak - base) / 1e9,
              one_layer_experts_gb=expert_gb,
              s=time.perf_counter() - t2)
    log(f"  peak {st['peak_gb']:.2f} GB, {st['peak_over_resident_gb']:.2f} "
        f"GB over the {st['resident_gb']:.2f} GB resident (both trees); "
        f"one layer's {xcfg.n_experts} experts are {expert_gb:.2f} GB, "
        f"and a gather would give each of the 4 slots a copy")
    if not st["peak_over_resident_gb"] < 4 * expert_gb:
        raise AssertionError("mixtral-ep's peak leaves room for gathered "
                             "experts")
    out["mixtral-ep"] = st
    del params, sh
    gc.collect()
    torch.cuda.empty_cache()

    # (d) float32 at 2 layers
    t3 = time.perf_counter()
    rng = np.random.default_rng(SEED + 290)
    parity = {}
    for label, shape in MESH_PARITY_MESHES:
        moe = "ep" in shape
        c = (mixtral_config(n_layers=MESH_PARITY_LAYERS, dtype="float32")
             if moe else LlamaConfig.preset(
                 MESH_SERVE_PRESET, n_layers=MESH_PARITY_LAYERS,
                 dtype="float32"))
        p32 = init_params(c, SEED + 291, device=dev)
        m32 = make_mesh(shape, device=dev)
        specs = (fsdp_specs(p32, m32) if "fsdp" in shape
                 else param_specs(c))
        s32 = shard_tree(p32, m32, specs)
        n_slots = 3 if label.startswith("3 slots") else 4
        extra = (dict(server=PagedSlotServer, page=64) if "paged" in label
                 else {})
        small = [(rng.integers(1, c.vocab_size,
                               int(rng.integers(20, 300))).tolist(),
                  int(rng.integers(6, 13)), False) for _ in range(4)]
        cnt = {}
        with no_ep_gather():
            done = counted(cnt, lambda: serve(
                s32, c, small, n_slots=n_slots, trace=False, **extra))[0]
        for k, n in cnt.items():
            counts[k] = counts.get(k, 0) + n
        for (prompt, m, _w), got in zip(small, done.values()):
            want = generate(p32, c, torch.tensor([prompt], device=dev), m,
                            max_len=2048)[0, len(prompt):].cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{label}: the server diverged from the "
                                     f"unsharded generate(): {got} != {want}")
        parity[label] = dict(requests_equal=len(small), launches=cnt)
        log(f"[mesh-serve] float32, {MESH_PARITY_LAYERS} layers, {label} "
            f"{shape}: {len(small)} requests token for token equal to the "
            f"unsharded generate(); launches {cnt}")
        if moe and "dp" in shape:
            # Capacity and priority from the whole batch, as the JAX
            # package's GSPMD routes it: every data group runs every row.
            cd = mixtral_config(n_layers=MESH_PARITY_LAYERS, dtype="float32",
                                moe_capacity_factor=MESH_DROP_CAPACITY)
            b, plen, new = MESH_DROP_BATCH
            rows = torch.tensor(rng.integers(1, c.vocab_size, (b, plen)),
                                device=dev)
            with no_ep_gather():
                got = counted(counts, lambda: generate(s32, cd, rows, new))
            want = generate(p32, cd, rows, new)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{label}, capacity {MESH_DROP_CAPACITY}: generate() "
                    f"diverged from the unsharded tree's: "
                    f"{got[:, plen:].tolist()} != {want[:, plen:].tolist()}")
            parity[label]["dropping_generate_rows_equal"] = b
            log(f"  capacity {MESH_DROP_CAPACITY} (drops tokens): aligned "
                f"generate() of {b} rows x {plen}, {new} new, equal to the "
                f"unsharded tree's")
        del p32, s32
        gc.collect()
        torch.cuda.empty_cache()
    parity["s"] = time.perf_counter() - t3
    out["parity"] = parity
    log(f"  launches {counts}")
    return out, counts


def phase_gate(card: str) -> dict:
    """Phase 27: the port's static-analysis gate (python -m
    starway_tpu_torch.analysis, all twelve passes) on this checkout, with
    the port's C++ engine built for wirefuzz's native leg.  Fails unless
    the gate is clean and the native leg ran.  Returns the per-pass
    seconds."""
    from pathlib import Path

    from starway_tpu_torch import native_build
    from starway_tpu_torch.analysis import PASSES, find_root, run_all
    from starway_tpu_torch.analysis import wirefuzz

    root = find_root(str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    so = native_build.ensure_built()
    build_s = time.perf_counter() - t0
    timings: dict = {}
    findings = run_all(root, timings=timings)
    for f in findings:
        log(f"  {f.render()}")
    if findings:
        raise AssertionError(f"the analysis gate found {len(findings)} "
                             f"finding(s)")
    if wirefuzz._NATIVE_CACHE.get(str(native_build.artifact(root))) is None:
        raise AssertionError(f"wirefuzz did not run its native leg against "
                             f"{so}")
    if sorted(timings) != sorted(PASSES):
        raise AssertionError(f"the gate ran {sorted(timings)}")
    log(f"[gate] python -m starway_tpu_torch.analysis: OK "
        f"[{', '.join(PASSES)}], wirefuzz's native leg against "
        f"{so.relative_to(root)} (engine build {build_s:.2f} s); seconds a "
        f"pass ({card}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
        + f"; total {sum(timings.values()):.3f}")
    return dict(timings_s=timings, total_s=sum(timings.values()),
                native=str(so.relative_to(root)), build_s=build_s)


# ---------------------------------------------------------------- bench twins

# The kernel bench's rows that phase 3 does not time, at short iteration
# counts, and the seconds each twin's process may take.
BENCH_TWIN_ROWS = ("matmul", "flash_window", "spec_verify")
BENCH_TWIN_ITERS = 3
BENCH_TWIN_TIMEOUT = 120


def phase_bench_twins(card: str) -> dict:
    """Phase 30: the twins of scripts/kernel_bench.py and
    scripts/collect_baseline.py on cuda:0, each in a process of its own
    (the kernels are already built): the nine kernels against their plain
    versions (``--which check``, phase 3's tolerances), the bench's rows
    that phase 3 does not time (:data:`BENCH_TWIN_ROWS`) at
    :data:`BENCH_TWIN_ITERS` iterations, and the five baseline
    configurations at ``--quick`` sizes.  Fails if a twin exits with
    another code than 0, a check row is out of its tolerance or a row is
    an error.  Returns the rows and each process's wall seconds."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("STARWAY_BENCH_REHEARSAL", "REHEARSAL",
                        "STARWAY_BENCH_CPU")}

    def twin(script, *args):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(root / "scripts" / "torch" / script), *args],
            cwd=root, capture_output=True, text=True, env=env,
            timeout=BENCH_TWIN_TIMEOUT)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{script} {' '.join(args)}: exit "
                                 f"{r.returncode}\n{r.stdout[-3000:]}\n"
                                 f"{r.stderr[-3000:]}")
        rows = [json.loads(line) for line in r.stdout.splitlines()
                if line.startswith("{")]
        return rows, wall

    check, wall_check = twin("kernel_bench.py", "--which", "check")
    for row in check:
        log(f"[bench-twins] {row['detail']}: {row['metric']} "
            f"{row['value']:.3e} (tol {row['tol']}) ok={row['ok']}")
    if len(check) != 9 or not all(row["ok"] for row in check):
        raise AssertionError(f"kernel_bench --which check: {check}")
    rows, wall_rows = twin("kernel_bench.py", "--which",
                           ",".join(BENCH_TWIN_ROWS), "--iters",
                           str(BENCH_TWIN_ITERS))
    for row in rows:
        log(f"[bench-twins] {row}")
    if (len(rows) != len(BENCH_TWIN_ROWS)
            or any("error" in row for row in rows)):
        raise AssertionError(f"kernel_bench rows: {rows}")
    base, wall_base = twin("collect_baseline.py", "--quick", "--json")
    configs = base[-1]["configs"] if base else {}
    for name, val in configs.items():
        log(f"[bench-twins] {name}: {val}")
    if len(configs) != 5:
        raise AssertionError(f"collect_baseline --quick: {base}")
    wall = dict(check=wall_check, rows=wall_rows, baseline=wall_base)
    log(f"[bench-twins] wall s a process ({card}): "
        + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    return dict(check=check, rows=rows, baseline=configs, wall_s=wall)


# ---------------------------------------------------------------- pipeline

PP_PRESET, PP_LAYERS = "llama3-8b", 8   # 1.75 G layer parameters, bf16
PP_BATCH = dict(batch=4, seq=2048)
PP_STAGES, PP_MICRO, PP_CHUNKS = 4, 4, 2  # parts a, b (2 chunks), e
PP_DP = dict(pp=2, dp=2, micro=2)         # part c
PP_MOE = dict(layers=2, pp=2, ep=2, micro=2)  # part d, Mixtral widths
# Each pipelined step is held to the unsharded one at phase 23's limits
# (MESH_LOSS_REL_TOL, MESH_AFTER_REL_TOL, MESH_GRAD_REL_TOL).


class StageRouting(PinnedRouting):
    """:class:`PinnedRouting` from a pipelined step to its reference.  The
    pipeline's F slots route stage by stage as the ticks go, out of the
    reference's order; its B slots route the same tokens again under
    autograd to the same choices.  :meth:`record` keeps the F slots'
    choices (routed without autograd) and :meth:`reorder` lays them out
    as the reference routes: microbatch by microbatch, layer by layer,
    ep shard by shard."""

    def record(self):
        import torch

        def recording(xt, router_w, k):
            out = self._real(xt, router_w, k)
            if not torch.is_grad_enabled():
                self.chosen.append(out[0])
            return out

        return mock.patch.object(self._moe, "_route", recording)

    def reorder(self, n_micro: int, n_stages: int, per_stage: int,
                ep: int) -> None:
        from starway_tpu_torch.parallel.pipeline import pipeline_ticks

        order = [(s * per_stage + l, t - s, e)
                 for t in range(pipeline_ticks(n_micro, n_stages))
                 for s in range(n_stages) if 0 <= t - s < n_micro
                 for l in range(per_stage) for e in range(ep)]
        if len(order) != len(self.chosen):
            raise AssertionError(f"{len(self.chosen)} routings recorded, "
                                 f"{len(order)} F-slot routings expected")
        by = dict(zip(order, self.chosen))
        self.chosen = [by[(g, j, e)] for j in range(n_micro)
                       for g in range(n_stages * per_stage)
                       for e in range(ep)]


def rows_ep_moe(cfg, mesh):
    """The MoE FFN as a pipeline stage runs it under pp x ep, as a
    ``moe_fn``: the rows of x split over the mesh's ``"ep"`` slots, each
    routing its own tokens (its capacity from them) to the experts split
    over ep, the aux averaged over the slots (models/moe.py)."""
    import torch

    from starway_tpu_torch.models.moe import _sharded_slots

    ep = mesh.shape["ep"]

    def fn(x, router, w_in, w_out, w_gate=None):
        ys, auxes = _sharded_slots(
            list(x.chunk(ep, 0)), [router] * ep, list(w_in.chunk(ep, 0)),
            list(w_out.chunk(ep, 0)),
            None if w_gate is None else list(w_gate.chunk(ep, 0)), mesh,
            "ep", cfg.moe_capacity_factor, cfg.moe_top_k, False)
        return torch.cat(ys, 0), auxes[0]

    return fn


def micro_loss(params, batch, cfg, n_micro: int, moe_fn=None) -> float:
    """The mean over ``n_micro`` microbatches of ``loss_fn``, no
    autograd."""
    import torch

    from starway_tpu_torch.models.llama import loss_fn

    with torch.no_grad():
        return float(sum(loss_fn(params, mb, cfg, None, moe_fn).item()
                         for mb in batch.chunk(n_micro)) / n_micro)


def pp_reference(cfg, params, batch, n_micro: int = 1, moe_fn=None,
                 pin=None) -> dict:
    """The unsharded step a pipelined one is held to: the gradients of the
    mean over ``n_micro`` microbatches of ``value_and_grad`` (accumulated
    in float32 and given the params' dtypes, as make_train_step's
    accumulation does; ``pin``: a context for that pass), its loss and
    ms, and the loss after one AdamW update with those gradients."""
    import torch

    from starway_tpu_torch.models.llama import apply_updates, value_and_grad
    from starway_tpu_torch.utils import adamw
    from starway_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    def grads_of():
        loss, acc = 0.0, None
        for mb in batch.chunk(n_micro):
            l, g = value_and_grad(params, mb, cfg, None, moe_fn)
            loss += l.item()
            if n_micro == 1:
                return loss, g
            leaves = tree_leaves(g)
            acc = ([x.float() for x in leaves] if acc is None
                   else [a.add_(x) for a, x in zip(acc, leaves)])
            del g, leaves
        return loss / n_micro, tree_unflatten(params, [
            (a / n_micro).to(p.dtype)
            for a, p in zip(acc, tree_leaves(params))])

    with pin if pin is not None else contextlib.nullcontext():
        (loss, grads), sec = timed(grads_of)
    tx = adamw(LR_TRAIN)
    new = apply_updates(tx, params, tx.init(params), grads,
                        in_place=False)[0]
    after = micro_loss(new, batch, cfg, n_micro, moe_fn)
    del new
    torch.cuda.empty_cache()
    return dict(loss=loss, after=after, grads=grads, ms=sec * 1e3)


def pp_after(cfg, tree, grads, batch, merge, n_micro: int = 1,
             moe_fn=None) -> float:
    """One AdamW update of the pipeline-layout ``tree`` (in place) with
    ``grads`` in the params' dtypes, then the loss of the merged tree."""
    import torch

    from starway_tpu_torch.models.llama import apply_updates
    from starway_tpu_torch.utils import adamw
    from starway_tpu_torch.utils.tree import tree_map

    tx = adamw(LR_TRAIN)
    grads = tree_map(lambda g, p: g.to(p.dtype), grads, tree)
    apply_updates(tx, tree, tx.init(tree), grads)
    del grads
    torch.cuda.empty_cache()
    flat = merge(tree)
    after = micro_loss(flat, batch, cfg, n_micro, moe_fn)
    del flat
    torch.cuda.empty_cache()
    return after


def pp_launches(c: dict, fwd: int, bwd: int, label: str) -> None:
    """The flash kernels of a pipelined run launched exactly as counted
    from its schedule."""
    got = (c["flash_forward"], c["flash_backward_dkv"],
           c["flash_backward_dq"])
    if got != (fwd, bwd, bwd):
        raise AssertionError(f"{label}: flash forward, dK/dV and dQ "
                             f"launched {got} times, not {(fwd, bwd, bwd)}")


def last_hidden(params, cfg, tokens):
    """The unsharded forward's last hidden state (before the final norm)
    of ``tokens``, layer by layer through decoder_layer, no autograd."""
    import torch

    from starway_tpu_torch.models.llama import (cfg_rope_tables,
                                                decoder_layer,
                                                default_attn, embed_tokens,
                                                layer_params)

    with torch.no_grad():
        h = embed_tokens(params, tokens, cfg)
        cos, sin = cfg_rope_tables(cfg, tokens.shape[1],
                                   device=tokens.device)
        for i in range(cfg.n_layers):
            h = decoder_layer(layer_params(params["layers"], i), h, cfg,
                              cos, sin, default_attn)[0]
    return h


def phase_pipeline(dev, card: str) -> tuple:
    """Phase 25: the pipeline family on cuda:0, every slot in this
    process, bf16, remat "dots".  llama3-8b widths cut to PP_LAYERS
    layers, batch PP_BATCH: (a) 1F1B over PP_STAGES stages, PP_MICRO
    microbatches; (b) the same layers interleaved, PP_CHUNKS chunks a
    stage; (c) pp x dp; (d) pp x ep at Mixtral-8x7B widths (PP_MOE),
    routed as the pipeline routed (StageRouting) and also freely; (e) the
    forward-only pipeline over (a)'s stages.  Parts a-d are held to the
    unsharded step of the same tree and batch: the loss, the loss after
    one AdamW update applied in the pipeline layout, and the worst
    gradient leaf; e to the unsharded forward of each microbatch within
    BF16_TOL.  Returns (stats, launch counts)."""
    import torch

    from starway_tpu_torch.models import LlamaConfig, init_params
    from starway_tpu_torch.models import pp_llama as tpp
    from starway_tpu_torch.models.llama import embed_tokens, value_and_grad
    from starway_tpu_torch.ops import launch_counts, reset_launch_counts
    from starway_tpu_torch.parallel import make_mesh, make_pipeline
    from starway_tpu_torch.utils.tree import tree_map

    out, counts = {}, {}

    def add(c):
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n

    def check(label, got: dict, want: dict) -> dict:
        rel = {k: abs(got[k] - want[k]) / abs(want[k])
               for k in ("loss", "after")}
        log(f"  {label}: loss {got['loss']:.5f} vs unsharded "
            f"{want['loss']:.5f} (rel {rel['loss']:.2e}, tol "
            f"{MESH_LOSS_REL_TOL}), after the update {got['after']:.5f} vs "
            f"{want['after']:.5f} (rel {rel['after']:.2e}, tol "
            f"{MESH_AFTER_REL_TOL}); worst gradient leaf "
            f"{got['grad_rel_err']:.3e} (tol {MESH_GRAD_REL_TOL})")
        if not (rel["loss"] <= MESH_LOSS_REL_TOL
                and rel["after"] <= MESH_AFTER_REL_TOL
                and got["grad_rel_err"] <= MESH_GRAD_REL_TOL):
            raise AssertionError(f"{label}: the pipelined step disagrees "
                                 f"with the unsharded one")
        return dict(loss_rel_err=rel["loss"], after_rel_err=rel["after"],
                    grad_rel_err=got["grad_rel_err"])

    def run(label, step, tree, batch, fwd, bwd, record=None, trace=False):
        """Two pipelined steps (the first with ``record``; with ``trace``
        a traced one between them), their ms, the last one's launches and
        the peak memory: (loss, grads, stats)."""
        mem = fresh_peak()
        with record if record is not None else contextlib.nullcontext():
            first = timed(lambda: step(tree, batch))[1] * 1e3
        traced = {}
        if trace:
            _, traced_ms, traced = traced_run(lambda: step(tree, batch)[0])
            if traced.get("device_busy_ms"):
                traced["device_idle_share"] = (
                    1 - traced["device_busy_ms"] / traced_ms)
            log(f"  {label}, a traced step: {traced_ms:.1f} ms, device busy "
                f"{traced.get('device_busy_ms')} ms, idle share "
                f"{traced.get('device_idle_share')}, by family "
                f"{traced.get('device_ms_by_family')}; top device "
                f"operations {traced.get('top_kernels_ms')}")
        reset_launch_counts()
        (loss, grads), sec = timed(lambda: step(tree, batch))
        c = launch_counts()
        add(c)
        pp_launches(c, fwd, bwd, label)
        st = dict(step_ms=[first, sec * 1e3], launches={
            k: c[k] for k in ("flash_forward", "flash_backward_dkv",
                              "flash_backward_dq")},
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, **mem,
            **{k: traced[k] for k in ("device_busy_ms", "device_idle_share",
                                      "device_ms_by_family",
                                      "top_kernels_ms") if k in traced})
        log(f"  {label}: step ms {st['step_ms']}, peak "
            f"{st['peak_memory_gb']:.2f} GB, launches {st['launches']}")
        return loss.item(), grads, st

    B, S = PP_BATCH["batch"], PP_BATCH["seq"]
    cfg = LlamaConfig.preset(PP_PRESET, n_layers=PP_LAYERS, remat=True,
                             remat_policy="dots")
    params = init_params(cfg, SEED + 320, device=dev)
    batch = train_batch(cfg, B, S + 1, SEED + 321, dev)
    log(f"[pipeline] {PP_PRESET} widths, {PP_LAYERS} layers, {cfg.dtype}, "
        f"remat dots, batch [{B}, {S + 1}], every slot on {dev} ({card}): the "
        f"unsharded step first")
    value_and_grad(params, batch, cfg)  # a warm run: the second is timed
    want = pp_reference(cfg, params, batch)
    log(f"  unsharded: loss {want['loss']:.5f}, value_and_grad "
        f"{want['ms']:.1f} ms")
    tokens = batch[:, :-1]
    h_micro = torch.stack([last_hidden(params, cfg, tokens[i:i + 1])
                           for i in range(PP_MICRO)])
    h_whole = last_hidden(params, cfg, tokens)
    L = PP_LAYERS

    # a. 1F1B over 4 stages of 2 layers.
    mesh = make_mesh({"pp": PP_STAGES}, device=dev)
    tree = tpp.shard_pp_params(tpp.pp_split_params(params, PP_STAGES), mesh)
    step = tpp.make_pp_llama_train(mesh, cfg, n_micro=PP_MICRO)
    log(f"[pipeline] a. 1F1B: {PP_STAGES} stages x {L // PP_STAGES} "
        f"layers, {PP_MICRO} microbatches")
    loss, grads, st = run("1f1b", step, tree, batch, 2 * PP_MICRO * L,
                          PP_MICRO * L, trace=True)
    gerr = worst_grad_rel_err(grads, tpp.pp_split_params(want["grads"],
                                                          PP_STAGES))
    after = pp_after(cfg, tree, grads, batch, tpp.pp_merge_params)
    del grads
    st["over_unsharded"] = st["step_ms"][1] / want["ms"]
    out["a_1f1b"] = dict(**check("1f1b", dict(loss=loss, after=after,
                                              grad_rel_err=gerr), want),
                         unsharded_ms=want["ms"], **st)
    log(f"  1f1b step / unsharded value_and_grad: "
        f"{st['over_unsharded']:.3f}")

    # e. the forward-only pipeline over the same stages (restored).
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    tree = tpp.shard_pp_params(tpp.pp_split_params(params, PP_STAGES), mesh)
    h0 = embed_tokens(params, tokens, cfg).reshape(PP_MICRO, B // PP_MICRO,
                                                   S, cfg.d_model)
    pipe = make_pipeline(mesh, tpp.make_pp_stage_fn(cfg))
    reset_launch_counts()
    got, sec = timed(lambda: pipe(tree["stages"], h0))
    c = launch_counts()
    add(c)
    pp_launches(c, PP_MICRO * L, 0, "forward")
    err = (got.float() - h_micro.float()).abs().max().item()
    whole = (got.reshape(h_whole.shape).float()
             - h_whole.float()).abs().max().item()
    log(f"[pipeline] e. forward-only make_pipeline: {sec * 1e3:.1f} ms, "
        f"max_abs_err {err:.3e} against the unsharded forward of each "
        f"microbatch (tol {BF16_TOL}), {whole:.3e} against the whole "
        f"batch's (max |h| {h_whole.float().abs().max().item():.3f})")
    if not err <= BF16_TOL:
        raise AssertionError("the forward pipeline disagrees with the "
                             "unsharded forward")
    out["e_forward"] = dict(ms=sec * 1e3, max_abs_err=err,
                            whole_batch_max_abs_err=whole,
                            launches=c["flash_forward"])
    del tree, got, h0, h_micro, h_whole
    gc.collect()
    torch.cuda.empty_cache()

    # b. the same layers interleaved: 4 stages x 2 chunks of 1 layer.
    tree = tpp.shard_ppv_params(
        tpp.ppv_split_params(params, PP_STAGES, PP_CHUNKS), mesh)
    step = tpp.make_pp_llama_train(mesh, cfg, n_micro=PP_MICRO,
                                   n_chunks=PP_CHUNKS)
    log(f"[pipeline] b. interleaved: {PP_STAGES} stages x {PP_CHUNKS} "
        f"chunks x {L // (PP_STAGES * PP_CHUNKS)} layer")
    loss, grads, st = run("interleaved", step, tree, batch,
                          2 * PP_MICRO * L, PP_MICRO * L)
    gerr = worst_grad_rel_err(grads, tpp.ppv_split_params(
        want["grads"], PP_STAGES, PP_CHUNKS))
    after = pp_after(cfg, tree, grads, batch, tpp.ppv_merge_params)
    del grads, tree
    st["over_unsharded"] = st["step_ms"][1] / want["ms"]
    out["b_interleaved"] = dict(**check("interleaved", dict(
        loss=loss, after=after, grad_rel_err=gerr), want),
        unsharded_ms=want["ms"], **st)
    gc.collect()
    torch.cuda.empty_cache()

    # c. pp x dp = 2 x 2, 2 microbatches.
    p = PP_DP
    mesh = make_mesh({"pp": p["pp"], "dp": p["dp"]}, device=dev)
    tree = tpp.shard_pp_params(tpp.pp_split_params(params, p["pp"]), mesh)
    step = tpp.make_pp_llama_train(mesh, cfg, n_micro=p["micro"],
                                   dp_axis="dp")
    log(f"[pipeline] c. pp x dp = {p['pp']} x {p['dp']}, {p['micro']} "
        f"microbatches")
    loss, grads, st = run("pp x dp", step, tree, batch,
                          2 * p["micro"] * L * p["dp"],
                          p["micro"] * L * p["dp"])
    gerr = worst_grad_rel_err(grads, tpp.pp_split_params(want["grads"],
                                                          p["pp"]))
    after = pp_after(cfg, tree, grads, batch, tpp.pp_merge_params)
    del grads, tree
    st["over_unsharded"] = st["step_ms"][1] / want["ms"]
    out["c_pp_dp"] = dict(**check("pp x dp", dict(
        loss=loss, after=after, grad_rel_err=gerr), want),
        unsharded_ms=want["ms"], **st)
    del params, want
    gc.collect()
    torch.cuda.empty_cache()

    # d. pp x ep at Mixtral-8x7B widths: 2 stages x 1 layer, ep = 2.
    p = PP_MOE
    mcfg = mixtral_config(n_layers=p["layers"], remat=True,
                          remat_policy="dots")
    params = init_params(mcfg, SEED + 322, device=dev)
    batch = train_batch(mcfg, B, S + 1, SEED + 323, dev)
    mesh = make_mesh({"pp": p["pp"], "ep": p["ep"]}, device=dev)
    moe_fn = rows_ep_moe(mcfg, make_mesh({"ep": p["ep"]}, device=dev))
    tree = tpp.shard_pp_params(tpp.pp_split_params(params, p["pp"]), mesh,
                               ep_axis="ep")
    step = tpp.make_pp_llama_train(mesh, mcfg, n_micro=p["micro"],
                                   ep_axis="ep")
    log(f"[pipeline] d. pp x ep = {p['pp']} x {p['ep']}, Mixtral-8x7B "
        f"widths, {p['layers']} layers, top-{mcfg.moe_top_k} of "
        f"{mcfg.n_experts} at capacity factor {mcfg.moe_capacity_factor} "
        f"(dropless), aux {mcfg.moe_aux_coef}, {p['micro']} microbatches")
    pin = StageRouting()
    n_layers = p["layers"]
    loss, grads, st = run("pp x ep", step, tree, batch,
                          2 * p["micro"] * n_layers * p["ep"],
                          p["micro"] * n_layers * p["ep"],
                          record=pin.record())
    pin.reorder(p["micro"], p["pp"], n_layers // p["pp"], p["ep"])
    # Kept in the params' dtypes (as the update takes them): the float32
    # gradients of these experts would hold 12.6 GB beside the references.
    grads = tree_map(lambda g, q: g.to(q.dtype), grads, tree)
    torch.cuda.empty_cache()
    after = pp_after(mcfg, tree, grads, batch, tpp.pp_merge_params,
                     p["micro"], moe_fn)
    del tree
    torch.cuda.empty_cache()
    free = pp_reference(mcfg, params, batch, p["micro"], moe_fn)
    free_err = worst_grad_rel_err(grads, tpp.pp_split_params(
        free.pop("grads"), p["pp"]))
    want = pp_reference(mcfg, params, batch, p["micro"], moe_fn,
                        pin=pin.replay())
    gerr = worst_grad_rel_err(grads, tpp.pp_split_params(want["grads"],
                                                          p["pp"]))
    log(f"  gradients against the reference routed freely: worst leaf "
        f"{free_err:.3e} (loss {free['loss']:.5f}); {pin.flips} of "
        f"{pin.pairs} routing choices differ; held routed as the "
        f"pipeline:")
    st["over_unsharded"] = st["step_ms"][1] / want["ms"]
    out["d_pp_ep"] = dict(**check("pp x ep", dict(
        loss=loss, after=after, grad_rel_err=gerr), want),
        free_grad_rel_err=free_err, routing_flips=pin.flips,
        routed_pairs=pin.pairs, unsharded_ms=want["ms"], **st)
    del params, grads, want, free
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


# ---------------------------------------------------------------- examples

# The twins of examples/ that run in this process (their launches counted
# around each run), and the twins that spawn processes and the
# transport's scripts, each a process of its own, with the argv phase 28
# gives them.  The originals' defaults, but for pingpong's and
# throughput's 256 MiB (their 1 GiB default takes the budget) and the two
# bench scripts' one pair of runs (five by default).
EXAMPLE_RUNS = (
    ("pingpong", ["--max-size", "256M"]),
    ("cancel_on_close", []),
    ("throughput", ["--size", "256M"]),
    ("all_to_all_p2p", []),
    ("serve_continuous", []),
    ("speculative", []),
    ("serve_remote", []),
    ("serve_remote/tcp", []),
    ("serve_remote/native-tcp", []),
    ("serve_hf", []),
    ("serve_hf/int8", ["--quantize", "int8"]),
    ("spmd_training", []),
    ("pp_training", []),
)
EXAMPLE_ENV = {"serve_remote/tcp": {"STARWAY_TLS": "tcp"},
               "serve_remote/native-tcp": {"STARWAY_TLS": "tcp",
                                           "STARWAY_NATIVE": "1"}}
SERVING_TWINS = ("serve_continuous", "speculative", "serve_remote",
                 "serve_hf")
TRAINING_TWINS = ("spmd_training", "pp_training")
SCRIPTS = ("session_chaos", "paired_bench", "integrity_bench")
SPAWNED_RUNS = (
    ("device_pull", "examples/torch/device_pull.py", []),
    ("dp_training_2proc", "examples/torch/dp_training_2proc.py", []),
    ("session_chaos", "scripts/torch/session_chaos.py", []),
    ("paired_bench", "scripts/torch/paired_bench.py", ["--pairs", "1"]),
    ("integrity_bench", "scripts/torch/integrity_bench.py",
     ["--pairs", "1", "--gate", "0"]),
)


@contextlib.contextmanager
def starway_env(extra: dict):
    """os.environ with no STARWAY_* setting of an earlier phase, plus
    ``extra``; restored on the way out."""
    import os

    saved = dict(os.environ)
    for key in [k for k in os.environ if k.startswith("STARWAY_")]:
        del os.environ[key]
    os.environ.update(extra)
    try:
        yield dict(os.environ)
    finally:
        os.environ.clear()
        os.environ.update(saved)


def example_module(name: str):
    """examples/torch/<name>.py as a module (the folder joins the end of
    the path)."""
    import importlib
    from pathlib import Path

    folder = str(Path(__file__).resolve().parent / "examples" / "torch")
    if folder not in sys.path:
        sys.path.append(folder)
    return importlib.import_module(name)


def start_run(path, argv: list, env: dict) -> dict:
    """``python path argv`` from the checkout's root in a session of its
    own, a thread collecting its output and its wall seconds (``out``,
    ``err``, ``wall_s``) as it ends."""
    import threading
    from pathlib import Path

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(path)] + argv, env=env,
                            cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    run = {"proc": proc, "name": f"{path} {' '.join(argv)}".strip()}

    def collect():
        run["out"], run["err"] = proc.communicate()
        run["wall_s"] = time.perf_counter() - t0

    run["thread"] = threading.Thread(target=collect, daemon=True)
    run["thread"].start()
    return run


def finish_run(run: dict, timeout: float = 300) -> str:
    """The stdout of a :func:`start_run` run once it exited 0 (its output
    is logged and the phase fails otherwise)."""
    run["thread"].join(timeout)
    if run["thread"].is_alive() or run["proc"].returncode != 0:
        log(run.get("out", "")[-4000:])
        log(run.get("err", "")[-4000:])
        raise AssertionError(f"{run['name']} exited "
                             f"{run['proc'].returncode}")
    return run["out"]


def phase_examples() -> tuple:
    """Phase 28: every twin of examples/ (examples/torch/*.py) on cuda:0 at
    its original's defaults, and the transport's scripts
    (scripts/torch/*.py, host only). Cuts: pingpong --max-size 256M and
    throughput --size 256M (1 GiB by default); paired_bench and
    integrity_bench one pair of runs (five by default), integrity_bench's
    gate opened (one pair on a shared host is no verdict, as its docstring
    says). In this process, the launch counts read around each run:
    pingpong, cancel_on_close, throughput, all_to_all_p2p,
    serve_continuous, speculative, serve_remote (in process, tcp, the C++
    engine over tcp: the original's three runs), serve_hf (the tiny random
    Llama, then --quantize int8), spmd_training and pp_training, each under
    its own autograd default. device_pull and dp_training_2proc (which
    spawn processes) and the three scripts run as processes of their own,
    all at once, beside the in-process model twins (after the transport
    twins, which have the host to themselves). Every run must exit 0 with
    its own checks; device_pull must arrive "device" by one CUDA IPC pull,
    dp_training's ranks bit-equal with every gradient leaf pulled over CUDA
    IPC; each serving twin launches #1 and #3, serve_hf --quantize int8 #4,
    spmd_training and pp_training #3, #5 and #6. Returns (per-run seconds,
    GB/s and launches; the launches summed)."""
    import os
    import re
    import signal
    from pathlib import Path

    import torch

    from starway_tpu_torch.ops import launch_counts, reset_launch_counts

    root = Path(__file__).resolve().parent
    runs, total, procs = {}, {}, {}
    try:
        for label, argv in EXAMPLE_RUNS:
            if label == "serve_continuous":
                # The runs that are processes of their own go beside the
                # in-process model twins from here on (their wall is mostly
                # processes reaching the card, and the scripts are host
                # only); the transport twins before them had the host to
                # themselves.
                with starway_env({}) as env:
                    for name, path, args in SPAWNED_RUNS:
                        procs[name] = start_run(path, args, env)
            name = label.split("/")[0]
            mod = example_module(name)
            with starway_env(EXAMPLE_ENV.get(label, {})), torch.enable_grad():
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                res = mod.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = launch_counts()
            st = {"wall_s": wall, "launches": {k: v for k, v in counts.items()
                                               if v}}
            if name == "pingpong":
                st["gb_per_s"] = {size: gbps for size, _, _, gbps in res}
            elif name in ("throughput", "all_to_all_p2p"):
                st["gb_per_s"] = res["gb_per_s"]
            elif name == "cancel_on_close" and "cancel" not in res:
                raise AssertionError(f"cancel_on_close's receive failed with "
                                     f"{res!r}")
            if name in SERVING_TWINS and not (counts["decode_attention"] > 0
                                              and counts["flash_forward"] > 0):
                raise AssertionError(f"{label} launched no decode or flash "
                                     f"kernel: {counts}")
            if label == "serve_hf/int8" and not counts["int8_matmul"] > 0:
                raise AssertionError(f"serve_hf --quantize int8 launched no "
                                     f"GEMV: {counts}")
            if name in TRAINING_TWINS and not all(counts[k] > 0 for k in (
                    "flash_forward", "flash_backward_dkv",
                    "flash_backward_dq")):
                raise AssertionError(f"{name} missed a flash kernel: "
                                     f"{counts}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            runs[label] = st
            log(f"[examples] {label} {' '.join(argv)}: {wall:.2f} s, "
                f"launches {st['launches']}"
                + (f", GB/s {st['gb_per_s']}" if "gb_per_s" in st else ""))
            gc.collect()
            torch.cuda.empty_cache()

        outs = {name: finish_run(run) for name, run in procs.items()}
    finally:  # a failed run leaves no process of its own behind
        for run in procs.values():
            if run["proc"].poll() is None:
                os.killpg(run["proc"].pid, signal.SIGKILL)
                run["proc"].wait()
    for name, run in procs.items():
        runs[name] = {"wall_s": run["wall_s"]}
        log(f"[examples] {run['name']}: {run['wall_s']:.2f} s (beside the "
            f"in-process twins): "
            + " | ".join(outs[name].strip().splitlines()))
    if not (re.search(r"via 'device' in .* content_ok=True",
                      outs["device_pull"])
            and "CUDA IPC pulls on the receiver: 1" in outs["device_pull"]):
        raise AssertionError(f"device_pull did not arrive 'device' by one "
                             f"CUDA IPC pull: {outs['device_pull']}")
    if not ("parameters identical across ranks" in outs["dp_training_2proc"]
            and "every gradient leaf crossed by CUDA IPC"
            in outs["dp_training_2proc"]):
        raise AssertionError(f"dp_training_2proc: "
                             f"{outs['dp_training_2proc']}")
    for name in SCRIPTS:
        report = json.loads(outs[name].strip().splitlines()[-1])
        if report.get("ok") is not True:
            raise AssertionError(f"{name}: {report}")
        runs[name]["report"] = report
    return runs, total


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

    # 4 + 5 + 6 + 7: the serving paths, counted.
    cfg = LlamaConfig.preset("llama3-8b")  # bf16, 32 layers, full widths
    reqs = make_requests(cfg)
    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    log("[serve] llama3-8b bf16, 32 layers, n_slots=8 max_len=2048 chunk=8, "
        f"{len(reqs)} requests, prompts "
        f"{min(len(r[0]) for r in reqs)}-{max(len(r[0]) for r in reqs)}")
    reset_launch_counts()
    done4, st4, srv4 = serve(params, cfg, reqs)
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

    # 6. the same model served over the transport to a client process
    st_remote, c_remote = phase_remote_serve(params, cfg, reqs,
                                             list(done4.values()), st4, card)
    log(f"  launches {c_remote}")
    if not (c_remote["decode_attention"] > 0
            and c_remote["flash_forward"] > 0):
        raise AssertionError("the remote-serve run launched no decode or "
                             "flash kernel")
    gc.collect()
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
    main_counts = {k: c4[k] + c_paged[k] + c_remote[k] + c5[k] for k in c4}
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
    # The admissions' GEMVs and attention run on Hopper's wgmma kernels
    # (csrc/w8a16_wgmma.cu, csrc/flash_fwd_wgmma.cu): every prefill launch
    # and every forward of the bf16 and int8 runs.
    if not (c5["int8_matmul/wgmma"] == by_regime["prefill"]
            and c5["flash_forward/wgmma"] == c5["flash_forward"]
            and c4["flash_forward/wgmma"] == c4["flash_forward"]):
        raise AssertionError(f"the serving runs did not take the wgmma "
                             f"kernels: {c4}, {c5}")
    # Every decode step's attention (C = 1, n_rep 4, D = 128: the decode
    # regime) runs csrc/decode_tma.cu, bf16 and int8 caches alike.
    assert_decode_route(c4, "phase 4 (serve-bf16)")
    assert_decode_route(c5, "phase 7 (serve-int8)")
    check_first_logits(qparams, cfg8, reqs[0][0], 2048)
    del qparams
    torch.cuda.empty_cache()

    # 8 + 9 + 10. parity: float32, 2 layers, same widths.
    cfg32 = LlamaConfig.preset("llama3-8b", n_layers=2, dtype="float32")
    params32 = init_params(cfg32, SEED + 2, device=dev)
    log("[parity] float32, 2 layers: SlotServer vs generate(), greedy")
    done, st6 = serve(params32, cfg32, reqs)[:2]
    wants = []
    for rid, (prompt, m, _w) in zip(done, reqs):
        want = generate(params32, cfg32, torch.tensor([prompt]), m,
                        max_len=2048)[0, len(prompt):].cpu().numpy()
        wants.append(want)
        if not np.array_equal(done[rid], want):
            raise AssertionError(f"request {rid}: SlotServer {done[rid]} != "
                                 f"generate {want}")
    log(f"  {len(done)} requests token-for-token equal; {st6}")
    log("[paged-parity] float32, 2 layers: PagedSlotServer and prefix "
        "caching vs generate(prefix + suffix), greedy")
    st_pp = phase_paged_parity(params32, cfg32)
    log("[remote-parity] float32, 2 layers: the bridge over tcp vs "
        "generate(), greedy")
    st_remote_parity = phase_remote_parity(params32, cfg32, reqs, wants)
    del params32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 11 + 12: the training path, counted, then its parity step.
    st7, c7 = phase_train(dev)
    log(f"  {st7}")
    log(f"  launches {c7}")
    # The training paths' backward runs on Hopper's wgmma kernels
    # (csrc/flash_bwd_wgmma.cu) wherever it is bf16 at head size 64 or 128:
    # phases 11, 13, 22, 23 and 25 (llama3-8b and Mixtral heads of 128);
    # phase 28's twins train float32 heads of 16, on the FMA loop.
    assert_bwd_route(c7, True, "train-bf16")
    st8 = phase_train_parity(dev)

    # 13 + 14: the training path with ring attention, then its parity.
    st_ring, c_ring = phase_train_ring(dev)
    assert_bwd_route(c_ring, True, "train-ring")
    st_rp = phase_train_ring_parity(dev)

    # 15: the transport's main path on the card (the monitor armed for one
    # round trip).
    st_tr = phase_transport(dev, card)

    # 16: two training ranks exchange their gradients over the transport.
    gc.collect()
    torch.cuda.empty_cache()
    st_dp, c_dp = phase_dp(dp_spec("cuda:0"), card)
    dp_runs = 2 * sum(dp_spec("cuda:0")[m]["steps"] for m in ("full",
                                                              "parity"))
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        if c_dp[name] != 2 * dp_runs:  # 2 layers a step, each rank
            raise AssertionError(f"{name} launched {c_dp[name]} times in the "
                                 f"DP ranks' {dp_runs} steps of 2 layers")
    # 16, C++ engine: the bf16 run again, 2 steps, both ranks on it.
    gc.collect()
    torch.cuda.empty_cache()
    spec_native = dp_spec("cuda:0", native=True)
    st_dpn, c_dpn = phase_dp(spec_native, card)
    dpn_runs = 2 * spec_native["full"]["steps"]
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        if c_dpn[name] != 2 * dpn_runs:
            raise AssertionError(f"{name} launched {c_dpn[name]} times in the "
                                 f"C++-engine DP ranks' {dpn_runs} steps")

    # 17: redistribute() on the card (no kernel of the port runs in it).
    gc.collect()
    torch.cuda.empty_cache()
    st_rs = phase_reshard(dev, card)

    # 18 + 19: Mistral-7B-v0.1 widths: rolling serving, speculative and
    # lookup decoding, beam search and HF conversion, then their parity.
    gc.collect()
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    st_mistral, c18 = phase_mistral(dev, card)
    t19 = time.perf_counter()
    st_mp, c19 = phase_mistral_parity(dev)
    log(f"[mistral] phases 18-19 took {t19 - t18:.1f} + "
        f"{time.perf_counter() - t19:.1f} s")

    # 20 + 21: Mixtral-8x7B-v0.1 widths: the MoE FFN on every serving
    # path, the expert all-to-all, then their parity.
    gc.collect()
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    st_mix, c20 = phase_mixtral(dev, card)
    t21 = time.perf_counter()
    st_mixp, c21 = phase_mixtral_parity(dev)
    log(f"[mixtral] phases 20-21 took {t21 - t20:.1f} + "
        f"{time.perf_counter() - t21:.1f} s")

    # 22-24: training and serving over a mesh of several axes.
    gc.collect()
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    st_mt, c22 = phase_mixtral_train(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    t23 = time.perf_counter()
    st_mesh, c23 = phase_mesh_train(dev, card)
    assert_bwd_route(c23, True, "mesh-train")
    gc.collect()
    torch.cuda.empty_cache()
    t24 = time.perf_counter()
    st_tp, c24 = phase_tp_serve(dev, card, reqs[:TP_SERVE_REQS],
                                list(done4.values())[:TP_SERVE_REQS], st4,
                                st5)
    log(f"[mesh] phases 22-24 took {t23 - t22:.1f} + {t24 - t23:.1f} + "
        f"{time.perf_counter() - t24:.1f} s")

    # 25: the pipeline family: 1F1B, interleaved, pp x dp, pp x ep MoE
    # and the forward pipeline.
    gc.collect()
    torch.cuda.empty_cache()
    t25 = time.perf_counter()
    st_pp, c25 = phase_pipeline(dev, card)
    assert_bwd_route(c25, True, "pipeline")
    log(f"[pipeline] phase 25 took {time.perf_counter() - t25:.1f} s")

    # 26: serving over dp x tp; 27: the static-analysis gate.
    gc.collect()
    torch.cuda.empty_cache()
    t26 = time.perf_counter()
    st_dptp, c26 = phase_dptp_serve(dev, card, reqs[:TP_SERVE_REQS],
                                    list(done4.values())[:TP_SERVE_REQS],
                                    st4, st5, st_tp)
    t27 = time.perf_counter()
    st_gate = phase_gate(card)
    log(f"[dptp-serve] phase 26 took {t27 - t26:.1f} s; [gate] phase 27 "
        f"took {time.perf_counter() - t27:.1f} s")

    # 28: the twins of examples/ and the transport's scripts.
    gc.collect()
    torch.cuda.empty_cache()
    t28 = time.perf_counter()
    st_ex, c28 = phase_examples()
    assert_bwd_route(c28, False, "examples")
    t_ex = time.perf_counter() - t28
    log(f"[examples] phase 28 took {t_ex:.1f} s")

    # 29: serving every sharded tree the JAX package serves.
    gc.collect()
    torch.cuda.empty_cache()
    t29 = time.perf_counter()
    st_ms, c29 = phase_mesh_serve(dev, card, st_paged)
    t_ms = time.perf_counter() - t29
    log(f"[mesh-serve] phase 29 took {t_ms:.1f} s")

    # 30: the twins of the kernel bench and the baseline collector, each
    # in a process of its own (their launches are not the main path's).
    gc.collect()
    torch.cuda.empty_cache()
    t30 = time.perf_counter()
    st_bt = phase_bench_twins(card)
    t_bt = time.perf_counter() - t30
    log(f"[bench-twins] phase 30 took {t_bt:.1f} s")

    regs = finish_ptxas_report(ptxas)
    bwd_regs = {**regs["flash_bwd_wgmma.cu"], **regs["flash_bwd.cu"]}
    for key, kinds in (("flash_backward_dkv", ("dkv",)),
                       ("flash_backward_dq", ("dq",)),
                       ("flash_partial_bwd", ("dkv", "dq"))):
        rows[key]["registers"] = {k: r for k, r in bwd_regs.items()
                                  if k.split()[0] in kinds}
    for key, kind in (("flash_forward", "fwd"), ("flash_partial", "partial")):
        rows[key]["registers"] = {
            k: r for src in ("flash_fwd_wgmma.cu", "flash_fwd.cu")
            for k, r in regs[src].items() if k.startswith(kind + " ")}
    rows["int8_matmul"]["registers"] = {**regs["w8a16_wgmma.cu"],
                                        **regs["int8_gemv.cu"]}
    rows["decode_attention"]["registers"] = {**regs["decode_tma.cu"],
                                             **regs["decode_attention.cu"]}
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

    # 31. kernels line: launches are the serving paths' (phases 4, 5, 6, 7,
    # 18, 19, 20, 21, 24, 26 and 29) and the training paths' (phases 11,
    # 13, 16, 22, 23 and 25, 16 the DP ranks' own counts on both engines)
    # and the in-process twins of examples/ (phase 28), each counted from
    # 0 just before its run and read just after.
    main_counts = {k: main_counts[k] + c7[k] + c_ring[k] + c_dp[k]
                   + c_dpn[k] + c18.get(k, 0) + c19.get(k, 0)
                   + c20.get(k, 0) + c21.get(k, 0) + c22.get(k, 0)
                   + c23.get(k, 0) + c24.get(k, 0) + c25.get(k, 0)
                   + c26.get(k, 0) + c28.get(k, 0) + c29.get(k, 0)
                   for k in main_counts}
    kernels = []
    for key, row in rows.items():
        row = dict(row)
        row["launches"] = main_counts[key]
        if f"{key}/wgmma" in main_counts:  # of them, on the wgmma kernel
            row["launches_wgmma"] = main_counts[f"{key}/wgmma"]
        if f"{key}/tma" in main_counts:  # of them, on csrc/decode_tma.cu
            row["launches_tma"] = main_counts[f"{key}/tma"]
        for phase, c in ((18, c18), (19, c19), (20, c20), (21, c21),
                         (22, c22), (23, c23), (24, c24), (25, c25),
                         (26, c26), (28, c28), (29, c29)):
            row[f"launches_phase{phase}"] = c.get(key, 0)
        kernels.append(row)
    # The W8A16 runs (phases 7, 18 and 29) launch the GEMV; the others'
    # counts of it are 0 and in main_counts.
    kernels[list(rows).index("int8_matmul")]["launches_by_regime"] = {
        r: n + c18.get(f"int8_matmul/{r}", 0) + c29.get(f"int8_matmul/{r}", 0)
        for r, n in by_regime.items()}
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
    log(f"[summary] transport across processes (cuda:0 <-> cuda:0, a "
        f"spawned child over tcp; p50 round trip us by size, {card}): "
        + "; ".join(f"{label} " + ", ".join(
            f"{row['bytes'] >> 10} KiB {row['fw_p50_us']:.0f}"
            for row in st_tr[f"cross-process-{label}"]["rows"])
            for label in ("ipc", "staged", "native", "native-staged",
                          "native-py")))
    log(f"[summary] remote-serve ({card}): {st_remote['tokens_per_s']:.1f} "
        f"tokens/s over the bridge against {st4['tokens_per_s']:.1f} in "
        f"process (phase 4); time to first token p50 "
        f"{st_remote['ttft_p50_s']:.3f} s (max {st_remote['ttft_max_s']:.3f}); "
        f"streams equal to phase 4's {st_remote['streams_equal_to_phase4']}; "
        f"cancelled {st_remote['cancelled']}; remote-parity "
        f"{st_remote_parity}")
    log(f"[summary] dp ({card}): median step {st_dp['median_step_ms']:.1f} ms "
        f"(both ranks, steps 2-3 of {st_dp['step_ms']}); spans median ms "
        f"{st_dp['spans_median_ms']}; "
        f"{st_dp['exchange_bytes_each_way'] / 1e9:.3f}"
        f" GB each way a step in {st_dp['leaves']} leaves, "
        f"{st_dp['exchange_gb_per_s_each_way']} GB/s each way over the "
        f"dp_exchange span; peak GB {st_dp['peak_gb']}; parity "
        f"{st_dp['parity']}; monitor {st_tr['monitor']}")
    log(f"[summary] dp on the C++ engine ({card}): step 2 "
        f"{st_dpn['median_step_ms']:.1f} ms ({st_dpn['step_ms']}); "
        f"dp_exchange ms "
        f"{ {r: v['dp_exchange'] for r, v in st_dpn['spans_median_ms'].items()} }"
        f", {st_dpn['exchange_gb_per_s_each_way']} GB/s each way, against "
        f"the Python engine's "
        f"{ {r: v['dp_exchange'] for r, v in st_dp['spans_median_ms'].items()} }"
        f" ms, {st_dp['exchange_gb_per_s_each_way']} GB/s")
    log(f"[summary] reshard ({card}): " + "; ".join(
        f"{k} {v['gb_per_s']:.2f} GB/s" for k, v in st_rs.items()))
    sv, sv8 = st_mistral["serve"], st_mistral["serve_int8"]
    log(f"[summary] mistral ({card}): rolling SlotServer "
        f"{sv['tokens_per_s']:.1f} tokens/s (admission {sv['admission_s']:.2f}"
        f" s of {sv['wall_s']:.2f}, median chunk {sv['median_chunk_ms']:.1f} "
        f"ms, decode-attention device ms in the traced chunk "
        f"{sv.get('attention_device_ms')}, idle share "
        f"{sv.get('device_idle_share')}); W8A16 + int8 KV "
        f"{sv8['tokens_per_s']:.1f} tokens/s; conversion bf16 "
        f"{st_mistral['convert_bf16']}, int8 {st_mistral['convert_int8']}; "
        f"longest prompt's first logits rel err "
        f"{st_mistral['first_logits_rel_err_longest']:.3e}; rolling generate "
        f"{st_mistral['generate_rolling']}; speculative "
        f"{st_mistral['speculative']}; beam {st_mistral['beam']}; launches "
        f"{c18}")
    log(f"[summary] mistral-parity: {st_mp}; launches {c19}")
    sv = st_mix["serve"]
    log(f"[summary] mixtral ({card}): SlotServer {sv['tokens_per_s']:.1f} "
        f"tokens/s (admission {sv['admission_s']:.2f} s of "
        f"{sv['wall_s']:.2f}, median chunk {sv['median_chunk_ms']:.1f} ms, "
        f"idle share {sv.get('device_idle_share')}, MoE FFN device ms in "
        f"the traced chunk {sv.get('moe_device_ms')} of busy "
        f"{sv.get('device_busy_ms')}: expert bmm "
        f"{sv.get('moe_expert_bmm_device_ms')}, dispatch and combine "
        f"{sv.get('moe_dispatch_combine_device_ms')}); router "
        f"{st_mix['router']}; ragged generate {st_mix['generate_ragged']}; "
        f"speculative {st_mix['speculative']}; beam {st_mix['beam']}; ep "
        f"{st_mix['ep']}; conversion {st_mix['convert']}; first logits "
        f"{st_mix['first_logits']}; launches {c20}")
    log(f"[summary] mixtral-parity: {st_mixp}; launches {c21}")
    log(f"[summary] mixtral-train ({card}): median step "
        f"{st_mt['median_step_ms']:.1f} ms, {st_mt['tokens_per_s']:.0f} "
        f"tokens/s, model FLOP share {st_mt['model_flop_share']:.4f}, peak "
        f"{st_mt['peak_memory_gb']:.2f} GB, idle share "
        f"{st_mt.get('device_idle_share')}, losses {st_mt['losses']}, aux "
        f"{st_mt['aux_after']:.4f}, router {st_mt['moe_stats']}; ep=4 "
        f"{st_mt['ep']['median_step_ms']:.1f} ms a step "
        f"({st_mt['ep']['over_global']:.3f} x); parity {st_mt['parity']}; "
        f"launches {c22}")
    for name, st in st_mesh.items():
        log(f"[summary] mesh-train {name} ({card}): "
            + ", ".join(f"{k} {st.get(k)}" for k in (
                "loss_rel_err", "step_ms", "ms", "flash_ms", "max_abs_err",
                "grad_rel_err", "peak_memory_gb", "device_busy_ms",
                "collective_device_ms", "collective_share") if k in st))
    for name, st in st_tp.items():
        log(f"[summary] tp-serve {name} ({card}): "
            + ", ".join(f"{k} {st.get(k)}" for k in (
                "tokens_per_s", "wall_s", "admission_s", "median_chunk_ms",
                "device_idle_share", "tokens_equal_to_phase4", "of",
                "first_logits_rel_err", "gemv_by_regime",
                "server_requests_equal", "speculative_equal", "accepted",
                "macro_steps") if k in st))
    for name, st in st_pp.items():
        log(f"[summary] pipeline {name} ({card}): "
            + ", ".join(f"{k} {st.get(k)}" for k in (
                "loss_rel_err", "after_rel_err", "grad_rel_err",
                "free_grad_rel_err", "routing_flips", "step_ms",
                "unsharded_ms", "over_unsharded", "device_idle_share",
                "ms", "max_abs_err", "whole_batch_max_abs_err",
                "peak_memory_gb", "launches")
                if k in st))
    for name, st in st_dptp.items():
        log(f"[summary] dptp-serve {name} ({card}): "
            + ", ".join(f"{k} {st.get(k)}" for k in (
                "tokens_per_s", "tp_serve_tokens_per_s",
                "unsharded_tokens_per_s", "wall_s", "admission_s",
                "median_chunk_ms", "device_idle_share", "peak_memory_gb",
                "weights_gb", "tokens_equal_to_phase4", "of",
                "decode_logits_rel_err", "gemv_by_regime",
                "server_requests_equal", "speculative_equal", "accepted",
                "macro_steps") if k in st))
    log(f"[summary] gate ({card}): total {st_gate['total_s']:.3f} s, by pass "
        f"{ {k: round(v, 3) for k, v in st_gate['timings_s'].items()} }, "
        f"native leg {st_gate['native']}")
    log(f"[summary] examples ({card}): phase 28 {t_ex:.1f} s; wall s "
        + ", ".join(f"{k} {v['wall_s']:.2f}" for k, v in st_ex.items())
        + "; GB/s pingpong by size "
        + ", ".join(f"{size} B {g:.2f}" for size, g in
                    st_ex["pingpong"]["gb_per_s"].items())
        + f", throughput 5 x 256 MiB {st_ex['throughput']['gb_per_s']:.2f}"
        f", all_to_all_p2p 4 ranks x 1 MiB "
        f"{st_ex['all_to_all_p2p']['gb_per_s']:.2f}; launches {c28}; "
        f"script total {time.perf_counter() - t_start:.1f} s")
    for name, st in st_ms.items():
        if name == "parity":
            log(f"[summary] mesh-serve parity ({card}): " + "; ".join(
                f"{k} {v['requests_equal']} requests equal" if k != "s"
                else f"{v:.1f} s" for k, v in st.items()))
        elif isinstance(st, dict):
            log(f"[summary] mesh-serve {name} ({card}): "
                + ", ".join(f"{k} {st.get(k)}" for k in (
                    "tokens_per_s", "phase5_tokens_per_s", "wall_s",
                    "admission_s", "median_chunk_ms",
                    "first_decode_logits_rel_err",
                    "admission_logits_rel_err", "pages_in_use_equal_steps",
                    "paged_launches_per_decode_step", "weights_gb",
                    "sharded_weights_gb", "resident_gb", "peak_gb",
                    "peak_over_resident_gb", "one_layer_experts_gb",
                    "routing_flips", "s") if k in st)
                + "".join(f", {label} {st[label]['tokens_per_s']:.1f} "
                          f"tokens/s" for label in ("SlotServer",
                                                    "PagedSlotServer")
                          if label in st))
    log(f"[summary] mesh-serve ({card}): phase 29 {t_ms:.1f} s; launches "
        f"{c29}")
    log(f"[summary] bench-twins ({card}): phase 30 {t_bt:.1f} s; check "
        + ", ".join(f"{r['detail'].split()[0]} {r['value']:.3e}"
                    for r in st_bt["check"])
        + "; " + "; ".join(f"{r['metric']} {r['value']} {r['unit']}"
                           for r in st_bt["rows"])
        + f"; script total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)

    # 32. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
