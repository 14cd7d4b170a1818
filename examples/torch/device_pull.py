"""Cross-process device transfer on the PyTorch port: the CUDA IPC pull.

Twin of examples/device_pull.py.  Two processes: a spawned child sends a
tensor on the card (``cuda:0``), the parent receives it into a
``DeviceBuffer`` on the card.  Across processes on one host the receiver
pulls the payload card to card over CUDA IPC (device.py
``TransferManager``): the bytes never stage through the host, and
``sink.last_transport`` proves which path ran.  On the card the payload
must arrive as ``"device"`` through exactly one IPC pull; a staged arrival
there is a failure.  With ``--device cpu`` both tensors are in host
memory and ride staged frames, so it arrives ``"staged"`` (the port's
deliberate difference from the JAX package, which pulls any
``jax.Array``).

The server listens on port 0 and reads its port back, as the original.

Run:  python examples/torch/device_pull.py [--size 16M] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import multiprocessing
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

MASK = (1 << 64) - 1
TAG = 0x9D


def pattern(nbytes: int, device):
    """0, 1, ..., 255, 0, 1, ... as ``uint8`` (the original's
    ``arange(nbytes, dtype=uint8)``)."""
    import torch

    return (torch.arange(nbytes, device=device) % 256).to(torch.uint8)


def child(port: int, nbytes: int, device: str) -> None:
    os.environ.setdefault("STARWAY_TLS", "tcp")
    from starway_tpu_torch import Client

    async def run() -> None:
        client = Client()
        for _ in range(100):
            try:
                await client.aconnect("127.0.0.1", port)
                break
            except Exception:
                client = Client()
                await asyncio.sleep(0.1)
        await client.asend(pattern(nbytes, device), TAG)
        await client.aflush()  # barrier: payload resident at the receiver
        await client.aclose()

    asyncio.run(run())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="16M")
    ap.add_argument("--device", default="cuda",
                    help="where both tensors live (default: the card)")
    args = ap.parse_args(argv)

    os.environ.setdefault("STARWAY_TLS", "tcp")
    import time

    import torch

    from starway_tpu_torch import DeviceBuffer, Server
    from starway_tpu_torch.bench import parse_size

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    device = "cuda:0" if args.device == "cuda" else args.device
    nbytes = parse_size(args.size)

    async def run() -> dict:
        server = Server()
        server.listen("127.0.0.1", 0)
        port = json.loads(server.get_worker_address())["port"]
        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(target=child, args=(port, nbytes, device),
                           daemon=True)
        proc.start()

        sink = DeviceBuffer((nbytes,), torch.uint8, device=device)
        t0 = time.perf_counter()
        tag, length = await asyncio.wait_for(server.arecv(sink, TAG, MASK), 60)
        dt = time.perf_counter() - t0
        assert (tag, length) == (TAG, nbytes)
        ok = bool(torch.equal(sink.array, pattern(nbytes, device)))
        mgr = server._server.transfer_manager()
        pulls = mgr.counts["pulled_ipc"] if mgr is not None else 0
        print(f"received {nbytes} bytes via {sink.last_transport!r} "
              f"in {dt:.3f}s (includes peer startup) content_ok={ok}")
        print(f"CUDA IPC pulls on the receiver: {pulls}")
        proc.join(10)
        await server.aclose()
        return {"transport": sink.last_transport, "ipc_pulls": pulls,
                "content_ok": ok, "seconds": dt,
                "child_exitcode": proc.exitcode}

    res = asyncio.run(run())
    if not res["content_ok"]:
        sys.exit("the received bytes differ from the payload")
    if torch.device(device).type == "cuda" and (
            res["transport"] != "device" or res["ipc_pulls"] != 1):
        sys.exit(f"on the card the payload must arrive as 'device' through "
                 f"one CUDA IPC pull; it came {res['transport']!r} with "
                 f"{res['ipc_pulls']} pulls")
    if res["child_exitcode"] != 0:
        sys.exit(f"the sending child exited {res['child_exitcode']}")
    return res


if __name__ == "__main__":
    main()
