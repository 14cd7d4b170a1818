"""Paired times of the kernels that lost most to a PyTorch call: #3 (the
flash forward, B=1 S=2048 causal, llama3-8b heads), #7 (one ring step's
partial over train-ring's past block, T=1024), #4's prefill regime (the
W8A16 GEMV, gate/up 4096 x 14336 at M=512), #5 and #6 (``flash_bwd``: the
backward at B=2 S=2048 causal, llama3-8b heads, both passes and the delta
reduction; ``flash_bwd_dkv`` and ``flash_bwd_dq``, each pass alone) and
#8 (``flash_partial_bwd``: the ring step's backward over train-ring's
past block), each beside its library call (SDPA, ``torch.matmul`` on the
dequantized weight, SDPA's backward; none for a pass alone) on the same
inputs.

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
        "flash_bwd_dkv", "flash_bwd_dq", "flash_partial_bwd")


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
