"""Sweep the int8 GEMV's launch plans on the card: the data behind
:func:`starway_tpu_torch.ops.gemv.gemv_plan`.

    python -m starway_tpu_torch.ops.gemv_sweep [--m 8 128 512 2048]

For every llama3-8b projection (and the lm_head at decode M) and each M,
launches the kernels (:func:`~starway_tpu_torch.ops.gemv.launch`) under
every plan they can run (decode: D split 1-16 ways, launched early or
not; prefill: 64- or 128-row, 128- or 256-column tiles, D split 1-8
ways), prints
the one ``gemv_plan`` picks, and times each, held against the plain
version, beside ``torch.matmul`` on the
dequantized bf16 weight.  Times are device microseconds a call: 20 calls
captured in one CUDA graph, each on its own copy of the weight so that
it comes from device memory, as in a decode step
(utils/cuda_timing.py).  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..utils.cuda_timing import cold_copies, graph_us
from . import gemv
from .quantize import quantize_weight

SHAPES = (("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024),
          ("gate/up", 4096, 14336), ("down", 14336, 4096),
          ("lm_head", 4096, 128256))


def plans(m: int) -> list:
    """(regime, prefill tile rows and columns, splits, early launch) the
    kernels can run."""
    if m <= gemv.DECODE_MAX_M:
        return [("decode", 0, 0, s, e) for s in (1, 2, 3, 4, 8, 9, 12, 16)
                for e in (False, True)]
    return [("prefill", tm, tn, s, False) for tm in (64, 128)
            for tn in (128, 256) for s in range(1, 9)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[8, 128, 512, 2048])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemv_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sms = gemv._n_sms(dev.index or 0)
    for name, d, f in SHAPES:
        w = quantize_weight(torch.randn(d, f, generator=gen, device=dev)
                            * d ** -0.5)
        wq, sc = w["q"], w["s"]
        del w
        wqs = cold_copies(wq)
        w_deqs = cold_copies((wq.float() * sc).to(torch.bfloat16))
        for m in args.m:
            if name == "lm_head" and m > gemv.DECODE_MAX_M:
                continue
            x = torch.randn(m, d, generator=gen, device=dev).to(torch.bfloat16)
            want = gemv.int8_matmul_reference(x, wq, sc)
            lib = graph_us(lambda c: torch.matmul(x, c), w_deqs)
            regime, splits = gemv.gemv_plan(m, d, f, n_sms)
            early = gemv.early_launch(regime, m, f, splits, n_sms)
            print(f"{name} M={m} D={d} F={f}: torch.matmul {lib:.1f} us; "
                  f"gemv_plan {(regime, splits)}{' early' if early else ''}",
                  flush=True)
            for regime, tile_m, tile_n, splits, early in plans(m):
                if -(-d // gemv.split_chunk(d, regime, splits)) != splits:
                    continue  # whole k steps leave fewer splits: a repeat
                plan = gemv.make_plan(regime, d, splits, (tile_m, tile_n),
                                      early)
                share = gemv.tolerance_share(gemv.launch(x, wq, sc, plan),
                                             want)
                if not share <= 1:
                    raise AssertionError(f"{plan} disagrees with the plain "
                                         f"version ({share:.2f})")
                us = graph_us(lambda c: gemv.launch(x, c, sc, plan), wqs)
                print(f"  {(regime, tile_m, tile_n, splits)}"
                      f"{' early' if early else ''}: {us:.1f} us "
                      f"({us / lib:.2f}x)", flush=True)
        del wq, sc, wqs, w_deqs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
