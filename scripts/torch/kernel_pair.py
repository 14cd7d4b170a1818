"""Paired times of the kernels that lost most to a PyTorch call: #3 (the
flash forward, B=1 S=2048 causal, llama3-8b heads), #7 (one ring step's
partial over train-ring's past block, T=1024), #4's prefill regime (the
W8A16 GEMV, gate/up 4096 x 14336 at M=512), #5 and #6 (``flash_bwd``: the
backward at B=2 S=2048 causal, llama3-8b heads, both passes and the delta
reduction; ``flash_bwd_dkv`` and ``flash_bwd_dq``, each pass alone), #8
(``flash_partial_bwd``: the ring step's backward over train-ring's past
block), #1 (``decode_*``: cached decode attention at the serving shape,
8 ragged rows of llama3-8b heads over T=2048 at C=1 with bf16 and int8
caches and at C=4, and at the kernel bench's shapes, one row of 8 q / 2 kv
heads over T=8192 and its three ``decode_shapes``, each at its last
position) and #9 (``paged_serve``: 16 slots at C=1, page 64), each beside
its library call (SDPA, ``torch.matmul`` on the dequantized weight,
SDPA's backward; none for a pass alone; for #1 and #9 SDPA over the bf16
cache with the rows' mask, none where every row sees the whole cache, and
over the gathered dense view for #9) on the same inputs.  The decode rows also carry their bound (bytes / 3.35 TB/s,
ops/decode_bench.py ``decode_work``) and the host's enqueue us a call.

Each kernel is timed as device ms a call (20 calls in one CUDA graph,
``utils/cuda_timing.py`` ``graph_us``; the GEMV on cold copies of its
weight, as ``chip_smoke.py`` phase 3 times it) and by CUDA events around
one call.  SDPA's backward is timed as its forward and backward in one
call (captured whole, so that autograd's backward runs on the capturing
stream) less its forward alone, each timed the same way.  Only the public
wrappers are called, so the script times whichever tree's package it is
pointed at:

    python scripts/torch/kernel_pair.py --tree .           # one JSON line
    python scripts/torch/kernel_pair.py --against PARENT --repeats 5

``--against`` runs this tree and the tree at PARENT (a checkout of the
parent commit, e.g. ``git archive`` unpacked under the ignored
``build/``) in alternating processes, ABBA order (parent, this, this,
parent, ...), ``--repeats`` times each, on one card, and prints every
run's line and then the medians of each tree.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROWS = ("flash_fwd", "flash_partial", "gemv_prefill", "flash_bwd",
        "flash_bwd_dkv", "flash_bwd_dq", "flash_partial_bwd", "decode_serve",
        "decode_serve_int8", "decode_serve_c4", "decode_b1_hkv2_t8192",
        "decode_b8_hkv2_t4096", "decode_b1_hkv8_t8192",
        "decode_b4_hkv1_t16384", "paged_serve")
# (name, B, Hq, Hkv, T, C, int8 cache): #1's rows; None for the serving
# shape's ragged positions, else every row at T - C.
DECODE_ROWS = (("decode_serve", 8, 32, 8, 2048, 1, False),
               ("decode_serve_int8", 8, 32, 8, 2048, 1, True),
               ("decode_serve_c4", 8, 32, 8, 2048, 4, False),
               ("decode_b1_hkv2_t8192", 1, 8, 2, 8192, 1, False),
               ("decode_b8_hkv2_t4096", 8, 8, 2, 4096, 1, False),
               ("decode_b1_hkv8_t8192", 1, 32, 8, 8192, 1, False),
               ("decode_b4_hkv1_t16384", 4, 8, 1, 16384, 1, False))


def measure(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F

    from starway_tpu_torch.ops.flash import (flash_backward,
                                             flash_backward_dkv,
                                             flash_backward_dq, flash_forward,
                                             flash_partial, flash_partial_bwd)
    from starway_tpu_torch.ops.gemv import int8_matmul
    from starway_tpu_torch.ops.quantize import quantize_weight
    from starway_tpu_torch.utils.cuda_timing import (card_name, cold_copies,
                                                     event_ms, graph_us)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    out = {"tree": os.path.abspath(tree), "card": card_name()}

    def row(name, ours, library, copies=(None,), lib_copies=(None,),
            library_less=None):
        """``library_less``: a part of the library call timed apart and
        taken off its times (SDPA's forward, where the library call is its
        forward and backward)."""
        out[name] = dict(ms=graph_us(ours, list(copies)) / 1e3,
                         events_ms=event_ms(lambda: ours(copies[0])))
        if library is None:
            return
        out[name].update(
            library_ms=graph_us(library, list(lib_copies)) / 1e3,
            library_events_ms=event_ms(lambda: library(lib_copies[0])))
        if library_less is not None:
            out[name]["library_ms"] -= graph_us(library_less, [None]) / 1e3
            out[name]["library_events_ms"] -= event_ms(library_less)

    def sdpa_fwd_bwd(q, k, v, do, causal):
        def call(_=None):
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                o = F.scaled_dot_product_attention(
                    *leaves, is_causal=causal, enable_gqa=True)
                return torch.autograd.grad(o, leaves, do)

        def fwd(_=None):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True)

        return call, fwd

    hq, hkv, d = 32, 8, 128
    q, k, v = randn(1, hq, 2048, d), randn(1, hkv, 2048, d), randn(
        1, hkv, 2048, d)
    row("flash_fwd", lambda _: flash_forward(q, k, v, causal=True),
        lambda _: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                 enable_gqa=True))
    q, k, v = (x[:, :, :1024].contiguous() for x in (q, k, v))
    row("flash_partial", lambda _: flash_partial(q, k, v, 1024, 0),
        lambda _: F.scaled_dot_product_attention(q, k, v, enable_gqa=True))
    del q, k, v
    q, k, v, do = (randn(2, h, 2048, d) for h in (hq, hkv, hkv, hq))
    o, lse = flash_forward(q, k, v, causal=True)
    lib, lib_fwd = sdpa_fwd_bwd(q, k, v, do, True)
    row("flash_bwd",
        lambda _: flash_backward(q, k, v, o, lse, do, causal=True), lib,
        library_less=lib_fwd)
    delta = (do.float() * o.float()).sum(-1)
    kw = dict(causal=True, sm_scale=d ** -0.5)
    row("flash_bwd_dkv",
        lambda _: flash_backward_dkv(q, k, v, do, lse, delta, **kw), None)
    row("flash_bwd_dq",
        lambda _: flash_backward_dq(q, k, v, do, lse, delta, **kw), None)
    q, k, v, do = (x[:1, :, :1024].contiguous() for x in (q, k, v, do))
    o, m, l = flash_partial(q, k, v, 1024, 0)
    lse = m + torch.log(l)
    delta = (do.float() * o / l[..., None]).sum(-1)
    lib, lib_fwd = sdpa_fwd_bwd(q, k, v, do, False)
    row("flash_partial_bwd",
        lambda _: flash_partial_bwd(q, do, k, v, lse, delta, 1024, 0), lib,
        library_less=lib_fwd)
    del q, k, v, do, o, lse, m, l, delta
    decode_rows(row, out, randn, dev)
    m, dd, f = 512, 4096, 14336
    x = randn(m, dd)
    w = quantize_weight(torch.randn(dd, f, generator=gen, device=dev)
                        * dd ** -0.5)
    wq, sc = w["q"], w["s"]
    w_deq = (wq.float() * sc).to(torch.bfloat16)
    row("gemv_prefill",
        lambda c: int8_matmul(x, c, sc, static_weight=True),
        lambda c: torch.matmul(x, c), cold_copies(wq), cold_copies(w_deq))
    return out


def decode_rows(row, out, randn, dev) -> None:
    """#1 at DECODE_ROWS and #9 at the paged server's shape, each on cold
    copies of its cache beside SDPA with the rows' mask; the bound and
    the host's enqueue us a call added to each row."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from starway_tpu_torch.ops.decode import decode_attention
    from starway_tpu_torch.ops.decode_bench import (_cold, _mask, bound_ms,
                                                    decode_work, host_us)
    from starway_tpu_torch.ops.paged import (gather_logical,
                                             paged_decode_attention)
    from starway_tpu_torch.ops.quantize import quantize_kv

    rng = np.random.default_rng(0)
    ragged = rng.integers(50, 2048 - 4, 8).tolist()
    for name, b, hq, hkv, t, n_q, quant in DECODE_ROWS:
        pos = ragged if name.startswith("decode_serve") else [t - n_q] * b
        q, k, v = randn(b, hq, n_q, 128), randn(b, hkv, t, 128), randn(
            b, hkv, t, 128)
        pos_d = torch.tensor(pos, dtype=torch.int32, device=dev)
        # Rows that see the whole cache: SDPA's fastest path, no mask.
        whole = n_q == 1 and all(p == t - 1 for p in pos)
        mask = None if whole else _mask(pos_d, n_q, t, dev)
        lib_copies = _cold((k, v))
        if quant:
            (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
            copies = _cold((k8, v8, ks, vs))

            def ours(c, q=q, pos_d=pos_d):
                return decode_attention(q, c[0], c[1], pos_d, k_scale=c[2],
                                        v_scale=c[3])
        else:
            copies = lib_copies

            def ours(c, q=q, pos_d=pos_d):
                return decode_attention(q, c[0], c[1], pos_d)

        row(name, ours,
            lambda c, q=q, mask=mask: F.scaled_dot_product_attention(
                q, c[0], c[1], attn_mask=mask, enable_gqa=True),
            copies, lib_copies)
        n_bytes, flops = decode_work(pos, n_q, hkv, hq, 128,
                                     1 if quant else 2, quant)
        out[name]["bound_ms"] = bound_ms(n_bytes, flops)[0]
        out[name]["host_us"] = host_us(lambda: ours(copies[0]))
        del q, k, v, copies, lib_copies
    page, max_len, b = 64, 4096, 16
    max_pages = max_len // page
    n_pages = 1 + b * max_pages
    pos = rng.integers(100, 2001, b).astype(np.int32)
    table = rng.permutation(np.arange(1, n_pages)).astype(np.int32).reshape(
        b, max_pages)
    last = pos // page
    q = randn(b, 32, 1, 128)
    kp, vp = randn(n_pages, 8, page, 128), randn(n_pages, 8, page, 128)
    table_d = torch.from_numpy(table).to(dev)
    pos_d = torch.from_numpy(pos).to(dev)
    n_live = int(last.max()) + 1
    live = torch.where(torch.arange(n_live, device=dev)[None, :]
                       <= torch.from_numpy(last).to(dev)[:, None],
                       table_d[:, :n_live], 0)
    kd, vd = gather_logical(kp, live), gather_logical(vp, live)
    mask = _mask(pos_d, 1, n_live * page, dev)
    copies = _cold((kp, vp))
    row("paged_serve",
        lambda c: paged_decode_attention(q, c[0], c[1], table_d, pos_d),
        lambda c: F.scaled_dot_product_attention(q, c[0], c[1],
                                                 attn_mask=mask,
                                                 enable_gqa=True),
        copies, _cold((kd, vd)))
    out["paged_serve"]["bound_ms"] = bound_ms(
        *decode_work(pos, 1, 8, 32, 128))[0]
    out["paged_serve"]["host_us"] = host_us(
        lambda: paged_decode_attention(q, kp, vp, table_d, pos_d))
    torch.cuda.empty_cache()


def alternate(parent: str, repeats: int) -> int:
    runs = {"parent": [], "this": []}
    order = []
    for i in range(repeats):
        order += ["parent", "this"] if i % 2 == 0 else ["this", "parent"]
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for label in order:
        tree = parent if label == "parent" else here
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree], capture_output=True, text=True)
        if r.returncode:
            print(r.stdout[-2000:], r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        line = r.stdout.strip().splitlines()[-1]
        print(json.dumps({"run": label, **json.loads(line)}), flush=True)
        runs[label].append(json.loads(line))
    summary = {}
    for label, rs in runs.items():
        summary[label] = {
            name: {key: statistics.median(r[name][key] for r in rs)
                   for key in rs[0][name]}
            for name in ROWS}
    print(json.dumps({"medians": summary, "repeats": repeats,
                      "card": runs["this"][0]["card"]}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="time this tree's package, one JSON line")
    ap.add_argument("--against", default=None,
                    help="a parent tree: alternate it with this one")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_pair: no CUDA device; it times the kernels on the "
              "card", file=sys.stderr)
        return 2
    if args.against:
        return alternate(args.against, args.repeats)
    print(json.dumps(measure(args.tree or ".")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
