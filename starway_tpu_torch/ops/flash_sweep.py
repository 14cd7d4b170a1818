"""Time the bf16 flash forward and the ring step's partial at each q-tile
height the kernels have, at the main paths' shapes: the data behind
:func:`~starway_tpu_torch.ops.flash.fwd_q_rows`.

    python -m starway_tpu_torch.ops.flash_sweep

llama3-8b heads (Hq 32, Hkv 8, D 128), bf16.  The forward, causal, at
B = 1 and every admission bucket S = 128 ... 2048, at B = 2 and S = 2048
(train-bf16's batch) and at B = 1 and S = 4096 (train-ring's flash
yardstick); the partial at train-ring's shard (T = 1024: a past block,
the diagonal, a band edge with window 700, a block whose first 512 rows
see no key) and zigzag's half shards (T = 512: an unmasked hi-lo pair, a
diagonal half).  At each shape, each q-tile height the kernel has at D
(flash.q_heights: the wgmma kernel has 64 rows) is held against the plain
version (o, or a partial's o / l, to 2e-2; lse and m to 1e-3) and timed
as device ms a call (utils/cuda_timing.py graph_us: 20 calls in one CUDA
graph), beside the height the plan picks.  Prints one
line a shape and a JSON line of all of them.  Needs an NVIDIA GPU.
chip_smoke.py times the planned kernels beside SDPA.
"""

from __future__ import annotations

import json
import sys

import torch

from . import flash
from ..utils.cuda_timing import graph_us, visible_pairs

HQ, HKV, D = 32, 8, 128
FORWARD = [(1, s) for s in (128, 256, 512, 1024, 2048)] + [(2, 2048),
                                                           (1, 4096)]
# (name, T, q_offset, kv_offset, window, causal)
RING_STEPS = (("past", 1024, 1024, 0, None, True),
              ("diagonal", 1024, 1024, 1024, None, True),
              ("band edge", 1024, 1024, 0, 700, True),
              ("first rows dead", 1024, 0, 512, None, True),
              ("zigzag hi-lo", 512, 2048, 0, None, False),
              ("zigzag diagonal", 512, 512, 512, None, True))


def _err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def forward_row(randn, n_sms: int, b: int, s: int) -> dict:
    q, k, v = randn(b, HQ, s, D), randn(b, HKV, s, D), randn(b, HKV, s, D)
    o_r, lse_r = flash.flash_forward_reference(q, k, v, causal=True)
    scale = D ** -0.5
    ms = {}
    for rows in flash.q_heights(D):
        def call(_=None, rows=rows):
            return flash._launch_forward(q, k, v, rows, True, scale, None)

        o, lse = call()
        if not (_err(o, o_r) <= 2e-2 and _err(lse, lse_r) <= 1e-3):
            raise AssertionError(f"flash_forward B={b} S={s} at {rows} rows "
                                 f"disagrees with its plain version")
        ms[rows] = graph_us(call, [None]) / 1e3
    return dict(kernel="flash_forward", where=f"B={b} S={s}",
                planned=flash.fwd_q_rows(b, HQ, s, s, True, n_sms=n_sms),
                graph_ms=ms,
                flops=4 * HQ * D * b * visible_pairs(s, s))


def partial_row(randn, n_sms: int, name, t, q_off, kv_off, window,
                causal) -> dict:
    q, k, v = randn(1, HQ, t, D), randn(1, HKV, t, D), randn(1, HKV, t, D)
    o_r, m_r, l_r = flash.flash_partial_reference(
        q, k, v, q_off, kv_off, causal=causal, window=window)
    live = l_r > 0
    scale = D ** -0.5
    ms = {}
    for rows in flash.q_heights(D):
        def call(_=None, rows=rows):
            return flash._launch_partial(q, k, v, q_off, kv_off, rows, causal,
                                         scale, window)

        o, m, l = call()
        o_n = o[live] / l[live][..., None]
        o_rn = o_r[live] / l_r[live][..., None]
        if not (_err(o_n, o_rn) <= 2e-2 and _err(m[live], m_r[live]) <= 1e-3
                and bool((l[~live] == 0).all())):
            raise AssertionError(f"flash_partial {name} at {rows} rows "
                                 f"disagrees with its plain version")
        ms[rows] = graph_us(call, [None]) / 1e3
    return dict(kernel="flash_partial", where=f"T={t} {name}",
                planned=flash.fwd_q_rows(1, HQ, t, t, causal, window, q_off,
                                         kv_off, n_sms),
                graph_ms=ms,
                flops=4 * HQ * D * visible_pairs(t, t, q_off, kv_off, causal,
                                                 window))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    n_sms = flash._n_sms(0)
    print(f"{torch.cuda.get_device_name(0)}, {n_sms} SMs", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    with torch.no_grad():
        rows = [forward_row(randn, n_sms, *shape) for shape in FORWARD]
        rows += [partial_row(randn, n_sms, *step) for step in RING_STEPS]
    for r in rows:
        times = ", ".join(f"{n} rows {ms:.4f} ms ({r['flops'] / ms / 1e9:.1f}"
                          f" TFLOP/s)" for n, ms in r["graph_ms"].items())
        best = min(r["graph_ms"], key=r["graph_ms"].get)
        print(f"{r['kernel']} {r['where']}: device ms a call: {times}; "
              f"fastest {best}, planned {r['planned']}", flush=True)
    print(json.dumps({"flash_sweep": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
