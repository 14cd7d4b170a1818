"""Manual perf sweep on the PyTorch port: evaluate_perf estimate vs
measured throughput, a device tensor sent into a device tensor.

Twin of examples/pingpong.py: sweeps message sizes 1 B .. ``--max-size``
over a loopback Server/Client pair of ``starway_tpu_torch``, printing the
link-model estimate next to the measured number.  The payload and the
sink are ``uint8`` tensors on the card (``cuda:0``), or on the CPU with
``--device cpu``; after each size the sink must hold the payload's bytes.

The server listens on port 0 and reads its port back, so several runs
(parallel test workers) can share a host.

Run:  python examples/torch/pingpong.py [--tls tcp] [--max-size 1g]
          [--uvloop] [--device cpu]

``--uvloop`` swaps in uvloop's event loop when the package is available,
as in the original; without it the sweep runs under stock asyncio with a
warning.
"""

import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

TAG = 0x77


async def run(max_size: int, device: str) -> list:
    """The sweep; returns ``(size, est_s, measured_s, GB/s)`` a size."""
    import torch

    from starway_tpu_torch import Client, DeviceBuffer, Server

    server = Server()
    server.listen("127.0.0.1", 0)
    port = json.loads(server.get_worker_address())["port"]
    client = Client()
    await client.aconnect("127.0.0.1", port)

    print(f"{'size':>12} {'est (s)':>12} {'measured (s)':>12} {'GB/s':>8}")
    rows = []
    size = 1
    while size <= max_size:
        buf = torch.full((size,), 0xA5, dtype=torch.uint8, device=device)
        sink = DeviceBuffer((size,), torch.uint8, device=device)
        sink.array.zero_()
        est = client.evaluate_perf(size)

        iters = 3 if size >= (1 << 28) else 10
        t0 = time.perf_counter()
        for _ in range(iters):
            recv_fut = server.arecv(sink, TAG, (1 << 64) - 1)
            await client.asend(buf, TAG)
            await recv_fut
        dt = (time.perf_counter() - t0) / iters
        if not torch.equal(sink.array, buf):
            raise AssertionError(f"{size} B: the sink differs from the "
                                 f"payload")
        gbps = size / dt / 1e9 if dt > 0 else float("inf")
        print(f"{size:>12} {est:>12.3e} {dt:>12.3e} {gbps:>8.2f}")
        rows.append((size, est, dt, gbps))
        del buf, sink
        size *= 16

    await client.aclose()
    await server.aclose()
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tls", help="STARWAY_TLS override (e.g. tcp)")
    ap.add_argument("--max-size", default="1g")
    ap.add_argument("--uvloop", action="store_true",
                    help="run under uvloop (the original's --uvloop)")
    ap.add_argument("--device", default="cuda",
                    help="where payload and sink live (default: the card)")
    args = ap.parse_args(argv)
    if args.tls:
        os.environ["STARWAY_TLS"] = args.tls
    if args.uvloop:
        try:
            import uvloop
            asyncio.set_event_loop_policy(uvloop.EventLoopPolicy())
        except ImportError:
            print("uvloop not installed; running under stock asyncio",
                  file=sys.stderr)
    import torch

    from starway_tpu_torch.bench import parse_size

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    return asyncio.run(run(parse_size(args.max_size), args.device))


if __name__ == "__main__":
    main()
