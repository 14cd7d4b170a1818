"""Pending ops are cancelled when the endpoint closes, on the PyTorch port.

Twin of examples/cancel_on_close.py: posts a receive into a device tensor
(a ``DeviceBuffer`` on the card, or on the CPU with ``--device cpu``) that
nothing will ever match, closes the client, and shows the receive failing
with a cancellation reason.

The server listens on port 0 and reads its port back, so several runs
(parallel test workers) can share a host.

Run:  python examples/torch/cancel_on_close.py [--device cpu]
"""

import argparse
import asyncio
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


async def run(device: str) -> str:
    """The demo; returns the failed receive's reason."""
    import torch

    from starway_tpu_torch import Client, DeviceBuffer, Server

    server = Server()
    server.listen("127.0.0.1", 0)
    port = json.loads(server.get_worker_address())["port"]
    client = Client()
    await client.aconnect("127.0.0.1", port)

    sink = DeviceBuffer((1024,), torch.uint8, device=device)
    reason = []

    async def doomed_recv():
        try:
            await client.arecv(sink, tag=999, tag_mask=(1 << 64) - 1)
            print("recv completed (unexpected!)")
        except Exception as e:
            print(f"recv failed as expected: {e}")
            reason.append(str(e))

    task = asyncio.create_task(doomed_recv())
    await asyncio.sleep(0.05)
    print("closing client with recv in flight...")
    await client.aclose()
    await task
    await server.aclose()
    if not reason:
        raise AssertionError("the pending receive was not cancelled")
    print("done")
    return reason[0]


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the sink lives (default: the card)")
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    return asyncio.run(run(args.device))


if __name__ == "__main__":
    main()
