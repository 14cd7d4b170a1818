"""Times of the decode-attention kernels (ops/decode.py, ops/paged.py) at
the serving paths' shapes, and their device ms in traced decode chunks of
the three servers; the same script runs against any checkout of the port
(it calls the public wrappers only), so that two versions compare in one
call on one card.

    python -m starway_tpu_torch.ops.decode_bench [--serve] [--sweep]
                                                 [--label NAME]

Each shape prints one JSON line: the largest error against the plain
version, ms a call by CUDA events around one call (host enqueue included)
and as device ms in a CUDA graph (``utils/cuda_timing.py`` ``graph_us``,
the caches cold), the same two for one PyTorch call of the function
(``scaled_dot_product_attention`` with the rows' mask; over the gathered
dense view for the paged kernel, the gather not timed), the host's
enqueue us a call, and the bound (bytes / 3.35 TB/s or operations / 989
TFLOP/s, whichever is larger).  ``--serve`` adds llama3-8b (bf16, 32
layers, random weights) served by SlotServer, PagedSlotServer and
SlotServer with an int8 KV cache and W8A16 weights: one steady decode
chunk (8 steps) of each under torch.profiler, with the device ms of its
decode-attention kernels and of all its kernels.  ``--sweep`` also times
each shape under every split over T (this version only: it replaces
ops/decode.py's launch plan), the data behind decode_plan.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (data sheet)
BF16_FLOPS = 989e12
HQ, HKV, D = 32, 8, 128  # llama3-8b heads
# Kernel names of the decode-attention functions in a trace, both dense
# and paged, this version's and the float32 loop's.
ATTN_KERNELS = ("decode_tma_kernel", "decode_mma_kernel",
                "paged_mma_kernel", "decode_partial_kernel",
                "paged_partial_kernel", "decode_combine_kernel")


def decode_work(pos, n_q: int, hkv: int, hq: int, d: int, kv_bytes: int = 2,
                scales: bool = False):
    """(bytes, flops) that cached decode attention needs: the live keys of
    each row (positions < pos + C) read once from k and v (and their
    float32 scales), q read and the output written once in bf16; two
    products of 2 * D per visible (query, key) pair and q head."""
    pos = np.asarray(pos, np.int64)
    keys = int((pos + n_q).sum())
    pairs = int((n_q * pos + n_q * (n_q + 1) // 2).sum())
    n_bytes = (2 * keys * hkv * (d * kv_bytes + (4 if scales else 0))
               + 2 * len(pos) * hq * n_q * d * 2)
    return n_bytes, 4 * pairs * hq * d


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_us(fn, n: int = 50) -> float:
    """Host enqueue us a call of ``n`` calls in a row (before any sync)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _cold(tensors, min_bytes: int = 256 << 20) -> list:
    """``tensors`` and enough copies that cycling through them reads more
    than the 50 MB L2 between two uses of one copy."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, -(-min_bytes // size))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def _mask(pos, n_q: int, t: int, dev):
    """SDPA's boolean mask of rows at pos + ci over t keys: [B, 1, C, t]."""
    return (torch.arange(t, device=dev)[None, None, None, :]
            <= pos[:, None, None, None]
            + torch.arange(n_q, device=dev)[None, None, :, None])


def split_sweep(ours, caches, splits) -> dict:
    """Device ms of ``ours`` with the launch plan's split over T replaced
    by each of ``splits`` in turn (this version's wrappers only)."""
    from starway_tpu_torch.ops import decode, paged
    from starway_tpu_torch.utils.cuda_timing import graph_us

    planned = decode.launch_plan
    out = {}
    try:
        for n in splits:
            def plan(*args, n=n):
                return planned(*args)[0], n

            decode.launch_plan = paged.launch_plan = plan
            out[n] = graph_us(lambda c: ours(*c), caches) / 1e3
    finally:
        decode.launch_plan = paged.launch_plan = planned
    return out


def time_call(ours, plain, caches, library, lib_caches, tol: float,
              splits=()) -> dict:
    """Error, events ms, device ms and host enqueue us of
    ``ours(*caches[i])`` against ``plain`` on the same operands, and of
    ``library(*lib_caches[i])``; device ms under each of ``splits``."""
    from starway_tpu_torch.utils.cuda_timing import event_ms, graph_us

    got, want = ours(*caches[0]), plain(*caches[0])
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"max_abs_err {err:.3e} above {tol}")
    return dict(
        split_ms=split_sweep(ours, caches, splits) if splits else None,
        max_abs_err=err,
        events_ms=event_ms(lambda: ours(*caches[0])),
        ms=graph_us(lambda c: ours(*c), caches) / 1e3,
        library_events_ms=event_ms(lambda: library(*lib_caches[0])),
        library_ms=graph_us(lambda c: library(*c), lib_caches) / 1e3,
        host_us=host_us(lambda: ours(*caches[0])),
        library_host_us=host_us(lambda: library(*lib_caches[0])))


def dense_row(gen, b: int, n_q: int, t: int, pos, quant: bool,
              splits=(), tol: float = 2e-2, hq: int = HQ,
              hkv: int = HKV) -> dict:
    """#1 at B=b, C=n_q over a cache of t, bf16 q, bf16 or int8 caches,
    hq / hkv heads.  Where every row sees the whole cache (C = 1 at pos t
    - 1) SDPA runs without a mask, its fastest path for the same
    function."""
    import torch.nn.functional as F

    from starway_tpu_torch.ops.decode import (decode_attention,
                                              decode_attention_reference)
    from starway_tpu_torch.ops.quantize import quantize_kv

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = randn(b, hq, n_q, D), randn(b, hkv, t, D), randn(b, hkv, t, D)
    pos_d = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    whole = n_q == 1 and all(p == t - 1 for p in pos)
    mask = None if whole else _mask(pos_d, n_q, t, dev)
    lib_caches = _cold((k, v))

    def library(kc, vc):  # SDPA on bf16 caches
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                              enable_gqa=True)

    if quant:
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        caches = _cold((k8, v8, ks, vs))

        def ours(kc, vc, ksc, vsc):
            return decode_attention(q, kc, vc, pos_d, k_scale=ksc,
                                    v_scale=vsc)

        def plain(kc, vc, ksc, vsc):
            return decode_attention_reference(q, kc, vc, pos_d, k_scale=ksc,
                                              v_scale=vsc)
    else:
        caches = lib_caches

        def ours(kc, vc):
            return decode_attention(q, kc, vc, pos_d)

        def plain(kc, vc):
            return decode_attention_reference(q, kc, vc, pos_d)

    row = time_call(ours, plain, caches, library, lib_caches, tol, splits)
    n_bytes, flops = decode_work(pos, n_q, hkv, hq, D, 1 if quant else 2,
                                 quant)
    heads = "" if (hq, hkv) == (HQ, HKV) else f" Hq={hq} Hkv={hkv}"
    return _finish(row, n_bytes, flops, kernel="decode_attention",
                   shape=f"B={b} T={t} C={n_q} {'int8' if quant else 'bf16'}"
                         f" KV{heads}, pos {min(pos)}-{max(pos)}"
                         + (", SDPA unmasked" if whole else ""))


def paged_row(gen, rng, b: int, n_q: int, pos, page: int = 64,
              max_len: int = 4096, splits=(), tol: float = 2e-2) -> dict:
    """#9 at b slots, C=n_q, over a pool of page ``page`` through a
    scrambled table whose entries past each cursor point outside it."""
    import torch.nn.functional as F

    from starway_tpu_torch.ops.paged import (gather_logical,
                                             paged_decode_attention,
                                             paged_decode_attention_reference)

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    max_pages = max_len // page
    n_pages = 1 + b * max_pages
    pos = np.asarray(pos, np.int32)
    table = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    table = table.reshape(b, max_pages)
    last = (pos + n_q - 1) // page
    for i in range(b):
        table[i, last[i] + 1:] = 2 ** 30 + i  # never read
    q = randn(b, HQ, n_q, D)
    kp, vp = randn(n_pages, HKV, page, D), randn(n_pages, HKV, page, D)
    table_d = torch.from_numpy(table).to(dev)
    pos_d = torch.from_numpy(pos).to(dev)
    n_live = int(last.max()) + 1
    live = torch.where(torch.arange(n_live, device=dev)[None, :]
                       <= torch.from_numpy(last).to(dev)[:, None],
                       table_d[:, :n_live], 0)
    kd, vd = gather_logical(kp, live), gather_logical(vp, live)
    mask = _mask(pos_d, n_q, n_live * page, dev)

    def ours(kc, vc):
        return paged_decode_attention(q, kc, vc, table_d, pos_d)

    def plain(kc, vc):
        return paged_decode_attention_reference(q, kc, vc, table_d, pos_d)

    def library(kc, vc):
        return F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask,
                                              enable_gqa=True)

    row = time_call(ours, plain, _cold((kp, vp)), library, _cold((kd, vd)),
                    tol, splits)
    return _finish(row, *decode_work(pos, n_q, HKV, HQ, D),
                   kernel="paged_decode_attention",
                   shape=f"{b} slots C={n_q} page={page}, pos "
                         f"{pos.min()}-{pos.max()}")


def _finish(row: dict, n_bytes: int, flops: int, **kw) -> dict:
    b_ms, b_by = bound_ms(n_bytes, flops)
    return dict(kw, **row, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / row["ms"],
                library_ratio=row["ms"] / row["library_ms"])


def kernel_rows(seed: int = 0, splits=()) -> list:
    """#1 and #9 at the serving paths' shapes (bf16, Hq 32, Hkv 8, D 128):
    dense B=8 T=2048 at C=1 (bf16 and int8 KV) and C=4 (a chunk verify),
    ragged positions; one row at C=128 at pos 1000 (a suffix ingest, T =
    4096); the kernel bench's row (B=1, Hq 8, Hkv 2, T=8192 at its last
    position); paged 16 slots at C=1 and one slot at C=128, page 64.  With
    ``splits``, each also under every split over T listed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    ragged = rng.integers(50, 2048 - 4, 8).tolist()
    rows = [dense_row(gen, 8, 1, 2048, ragged, False, splits),
            dense_row(gen, 8, 4, 2048, ragged, False, splits),
            dense_row(gen, 1, 128, 4096, [1000], False, splits),
            dense_row(gen, 8, 1, 2048, ragged, True, splits),
            dense_row(gen, 1, 1, 8192, [8191], False, splits, hq=8, hkv=2),
            paged_row(gen, rng, 16, 1, rng.integers(100, 2001, 16),
                      splits=splits),
            paged_row(gen, rng, 1, 128, [1000], splits=splits)]
    torch.cuda.empty_cache()
    return rows


def attention_device_ms(prof) -> tuple:
    """(decode-attention kernels' device ms, all kernels' device ms) of a
    torch.profiler run."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in kernels)
    attn = sum(getattr(e, "self_device_time_total", 0) for e in kernels
               if any(n in e.key for n in ATTN_KERNELS))
    return attn / 1e3, busy / 1e3


def traced_chunk(server_cls, params, cfg, reqs, prefix=None, **kw) -> dict:
    """Serve ``reqs`` (tokens, budget, prefixed) and trace the third decode
    chunk: its wall ms and its kernels' device ms."""
    from torch.profiler import ProfilerActivity, profile

    class Traced(server_cls):
        chunks, traced = 0, None

        def _run_chunk(self):
            self.chunks += 1
            if self.chunks != 3:
                return super()._run_chunk()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = super()._run_chunk()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            attn, busy = attention_device_ms(prof)
            self.traced = dict(chunk_wall_ms=wall, attention_device_ms=attn,
                               busy_device_ms=busy)
            return out

    srv = Traced(params, cfg, seed=0, **kw)
    pid = None if prefix is None else srv.register_prefix(prefix)
    for tokens, budget, prefixed in reqs:
        srv.submit(tokens, budget, prefix=pid if prefixed else None)
    srv.run()
    if srv.traced is None:
        raise AssertionError("the run ended before its third decode chunk")
    return srv.traced


def serve_rows(seed: int = 0) -> list:
    """One traced decode chunk of serve-bf16 (8 slots, max_len 2048),
    serve-paged (16 slots, max_len 4096, page 64, a 1000-token prefix
    that half the requests continue) and serve-int8 (int8 KV, W8A16), on
    llama3-8b widths (bf16, 32 layers, random weights from ``seed``)."""
    from starway_tpu_torch.models import (LlamaConfig, PagedSlotServer,
                                          SlotServer, init_params)
    from starway_tpu_torch.ops.quantize import quantize_params

    torch.set_grad_enabled(False)
    cfg = LlamaConfig.preset("llama3-8b")
    rng = np.random.default_rng(seed + 1)
    vocab = cfg.vocab_size

    def prompt(lo, hi):
        return rng.integers(1, vocab, int(rng.integers(lo, hi))).tolist()

    reqs = [(prompt(100, 1501), 40, False) for _ in range(8)]
    prefix = prompt(1000, 1001)
    paged = [(prompt(20, 301) if i % 2 else prompt(100, 1501), 40,
              bool(i % 2)) for i in range(16)]
    params = init_params(cfg, seed, device="cuda")
    out = [dict(server="serve-bf16", **traced_chunk(
        SlotServer, params, cfg, reqs, n_slots=8, max_len=2048, chunk=8))]
    out.append(dict(server="serve-paged", **traced_chunk(
        PagedSlotServer, params, cfg, paged, prefix=prefix, n_slots=16,
        max_len=4096, chunk=8, page=64, n_pages=16 * 33 + 1)))
    qparams = quantize_params(params)
    del params
    torch.cuda.empty_cache()
    out.append(dict(server="serve-int8", **traced_chunk(
        SlotServer, qparams, LlamaConfig.preset("llama3-8b",
                                                kv_quant="int8"),
        reqs, n_slots=8, max_len=2048, chunk=8)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--serve", action="store_true",
                    help="also trace a decode chunk of the three servers")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every split over T (this version only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_bench needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(label=args.label, card=card)), flush=True)
    with torch.no_grad():
        for row in kernel_rows(splits=(1, 2, 3, 4, 5, 6, 8, 16) if args.sweep
                               else ()):
            print(json.dumps(dict(label=args.label, **row)), flush=True)
        if args.serve:
            for row in serve_rows():
                print(json.dumps(dict(label=args.label, **row)), flush=True)


if __name__ == "__main__":
    main()
