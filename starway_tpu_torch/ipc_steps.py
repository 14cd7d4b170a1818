"""Where a CUDA IPC pull's time goes, step by step.

    python -m starway_tpu_torch.ipc_steps [--sizes 1M 64M] [--iters 30]
        [--cached-gib 4] [--pool]

Two processes on ``cuda:0``, the steps of one pull of the device plane's
"ipc" route (device.py ``TransferManager``) timed apart on the host clock,
medians in microseconds:

* exporter: ``collect`` (``torch.cuda.ipc_collect()``: released exports
  back to the allocator), ``snapshot`` (clone on the card, waited for),
  ``share`` (``UntypedStorage._share_cuda_()``: the IPC memory and event
  handles and the reference counter);
* importer: ``open`` (``rebuild_cuda_tensor``: the IPC handle opened, the
  export's event waited on), ``copy`` (into a tensor it owns, waited
  for), ``close`` (the mapping released: the counter drops to 0);
* ``round_trip``: the exporter's view of one handle sent and released.

Prints one JSON line per size.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import statistics
import sys
import time


def _importer(q_in, q_out) -> None:
    import torch
    from torch.multiprocessing.reductions import rebuild_cuda_tensor

    dev = torch.device("cuda:0")
    stream = torch.cuda.Stream(dev)
    times: dict = {"open": [], "copy": [], "close": []}
    while True:
        item = q_in.get()
        if item is None:
            break
        n, (d, h, sz, so, rh, ro, eh, es) = item
        if n == 0:  # the size changed: report and reset
            q_out.put({k: statistics.median(v) * 1e6 for k, v in times.items()})
            times = {k: [] for k in times}
            continue
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            src = rebuild_cuda_tensor(torch.Tensor, (n,), (1,), 0,
                                      torch.UntypedStorage, torch.uint8, d, h,
                                      sz, so, False, rh, ro, eh, es)
            t1 = time.perf_counter()
            dst = torch.empty(n, dtype=torch.uint8, device=dev)
            dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()
        t2 = time.perf_counter()
        del src
        t3 = time.perf_counter()
        times["open"].append(t1 - t0)
        times["copy"].append(t2 - t1)
        times["close"].append(t3 - t2)
        q_out.put(None)


def main(argv=None) -> int:
    import torch

    from .bench import parse_size

    p = argparse.ArgumentParser(prog="python -m starway_tpu_torch.ipc_steps",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", nargs="*", type=parse_size,
                   default=[1 << 20, 64 << 20])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--cached-gib", type=float, default=0.0,
                   help="first allocate and free this many GiB, so the "
                        "snapshots are carved from one large cached segment "
                        "(as in a process that has run a model)")
    p.add_argument("--pool", action="store_true",
                   help="allocate the snapshots from a private "
                        "torch.cuda.MemPool (segments of their own size)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ipc_steps: needs a CUDA device", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    q_in, q_out = ctx.Queue(), ctx.Queue()
    child = ctx.Process(target=_importer, args=(q_in, q_out))
    child.start()
    dev = torch.device("cuda:0")
    if args.cached_gib:
        del_me = torch.empty(int(args.cached_gib * (1 << 30)),
                             dtype=torch.uint8, device=dev)
        del del_me  # the segment stays in the allocator's cache
    pool = torch.cuda.MemPool() if args.pool else None
    try:
        for n in args.sizes:
            src = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev)
            times: dict = {"collect": [], "snapshot": [], "share": [],
                           "round_trip": []}
            for _ in range(args.iters):
                t0 = time.perf_counter()
                torch.cuda.ipc_collect()
                t1 = time.perf_counter()
                if pool is not None:
                    with torch.cuda.use_mem_pool(pool):
                        snap = torch.empty_like(src)
                else:
                    snap = torch.empty_like(src)
                snap.copy_(src)
                torch.cuda.current_stream(dev).synchronize()
                t2 = time.perf_counter()
                handles = snap.untyped_storage()._share_cuda_()
                t3 = time.perf_counter()
                q_in.put((n, handles))
                del snap
                q_out.get(timeout=60)
                t4 = time.perf_counter()
                for key, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2,
                                           t4 - t3)):
                    times[key].append(dt)
            q_in.put((0, (None,) * 8))
            imp = q_out.get(timeout=60)
            print(json.dumps({
                "bytes": n, "iters": args.iters,
                "cached_gib": args.cached_gib, "pool": args.pool,
                "exporter_us": {k: statistics.median(v) * 1e6
                                for k, v in times.items()},
                "importer_us": imp}), flush=True)
    finally:
        q_in.put(None)
        child.join(30)
        if child.is_alive():
            child.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
