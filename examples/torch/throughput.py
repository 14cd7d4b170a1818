"""Concurrent large sends on the PyTorch port, device tensors both ends.

Twin of examples/throughput.py: fires ``--count`` x ``--size`` sends
concurrently from client to server and reports aggregate throughput.
Payloads and sinks are ``uint8`` tensors on the card (``cuda:0``), or on
the CPU with ``--device cpu``; payload i is filled with i, and every sink
must hold its payload's bytes.

The server listens on port 0 and reads its port back, so several runs
(parallel test workers) can share a host.

Run:  python examples/torch/throughput.py [--tls tcp] [--count 5]
          [--size 1g] [--device cpu]
"""

import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


async def run(count: int, size: int, device: str) -> dict:
    """The burst; returns its bytes, seconds and aggregate GB/s."""
    import torch

    from starway_tpu_torch import Client, DeviceBuffer, Server

    server = Server()
    server.listen("127.0.0.1", 0)
    port = json.loads(server.get_worker_address())["port"]
    client = Client()
    await client.aconnect("127.0.0.1", port)

    payloads = [torch.full((size,), i, dtype=torch.uint8, device=device)
                for i in range(count)]
    sinks = [DeviceBuffer((size,), torch.uint8, device=device)
             for _ in range(count)]
    for s in sinks:
        s.array.fill_(0xFF)

    t0 = time.perf_counter()
    recvs = [server.arecv(s, 0, 0) for s in sinks]
    sends = [client.asend(p, i) for i, p in enumerate(payloads)]
    done = await asyncio.gather(*sends, *recvs)
    dt = time.perf_counter() - t0

    total = count * size
    gbps = total / dt / 1e9
    print(f"{count} x {size} bytes in {dt:.3f}s -> {gbps:.2f} GB/s aggregate")
    # Tag 0 with mask 0 matches any send: each sink is checked against the
    # payload whose tag it received.
    for (tag, length), sink in zip(done[count:], sinks):
        if length != size or not torch.equal(sink.array, payloads[tag]):
            raise AssertionError(f"the sink of tag {tag} differs from its "
                                 f"payload")

    await client.aclose()
    await server.aclose()
    return {"bytes": total, "seconds": dt, "gb_per_s": gbps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tls")
    ap.add_argument("--count", type=int, default=5)
    ap.add_argument("--size", default="1g")
    ap.add_argument("--device", default="cuda",
                    help="where payloads and sinks live (default: the card)")
    args = ap.parse_args(argv)
    if args.tls:
        os.environ["STARWAY_TLS"] = args.tls
    import torch

    from starway_tpu_torch.bench import parse_size

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    return asyncio.run(run(args.count, parse_size(args.size), args.device))


if __name__ == "__main__":
    main()
