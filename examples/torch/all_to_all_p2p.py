"""All-to-all shuffle composed from tagged P2P on the PyTorch port, with
the chunks on the card.

Twin of examples/all_to_all_p2p.py (BASELINE config 4's pattern: N
logical ranks, each holding N chunks, redistribute so rank j ends up with
chunk j from every rank).  Each rank runs a Server (worker-address
bootstrap) and connects a Client to every peer; chunks are ``uint8``
tensors on the card (``cuda:0``, or the CPU with ``--device cpu``),
received in place into rows of each rank's output tensor, and routed
purely by tag (tag = source rank).

Run:  python examples/torch/all_to_all_p2p.py [--ranks 4] [--chunk 1M]
          [--device cpu]
"""

import argparse
import asyncio
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

MASK = (1 << 64) - 1


async def run(n_ranks: int, chunk_bytes: int, device: str) -> dict:
    """The shuffle; returns the bytes moved, seconds and GB/s."""
    import torch

    from starway_tpu_torch import Client, DeviceBuffer, Server

    # Bootstrap: every rank listens and publishes its worker address.
    servers = [Server() for _ in range(n_ranks)]
    addresses = [s.listen_address() for s in servers]

    # Full-mesh clients: clients[i][j] = rank i's connection to rank j.
    clients: list[dict[int, Client]] = [dict() for _ in range(n_ranks)]

    async def connect_all(i: int) -> None:
        for j in range(n_ranks):
            if j == i:
                continue
            c = Client()
            await c.aconnect_address(addresses[j])
            clients[i][j] = c

    await asyncio.gather(*(connect_all(i) for i in range(n_ranks)))

    # Source data: rank i's chunk destined for rank j is filled with i*16+j.
    data = [
        torch.stack([torch.full((chunk_bytes,), (i * 16 + j) % 251,
                                dtype=torch.uint8, device=device)
                     for j in range(n_ranks)])
        for i in range(n_ranks)
    ]
    out = [torch.zeros((n_ranks, chunk_bytes), dtype=torch.uint8,
                       device=device) for _ in range(n_ranks)]

    t0 = time.perf_counter()

    async def exchange(i: int) -> None:
        recvs = [
            servers[i].arecv(DeviceBuffer((chunk_bytes,), torch.uint8,
                                          array=out[i][src]), src, MASK)
            for src in range(n_ranks) if src != i
        ]
        sends = [
            clients[i][j].asend(data[i][j], i)  # tag = source rank
            for j in range(n_ranks) if j != i
        ]
        out[i][i].copy_(data[i][i])  # local chunk stays
        await asyncio.gather(*sends, *recvs)
        await asyncio.gather(*(clients[i][j].aflush() for j in clients[i]))

    await asyncio.gather(*(exchange(i) for i in range(n_ranks)))
    dt = time.perf_counter() - t0

    # Verify: rank j's row from src i must carry pattern i*16+j.
    for j in range(n_ranks):
        for i in range(n_ranks):
            assert bool((out[j][i] == (i * 16 + j) % 251).all()), (i, j)

    moved = n_ranks * (n_ranks - 1) * chunk_bytes
    gbps = moved / dt / 1e9
    print(f"all-to-all ok: {n_ranks} ranks x {chunk_bytes} B chunks, "
          f"{moved / 1e6:.1f} MB moved in {dt * 1e3:.1f} ms "
          f"({gbps:.2f} GB/s aggregate)")

    for i in range(n_ranks):
        for c in clients[i].values():
            await c.aclose()
    for s in servers:
        await s.aclose()
    return {"bytes": moved, "seconds": dt, "gb_per_s": gbps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--chunk", default="1M")
    ap.add_argument("--device", default="cuda",
                    help="where the chunks live (default: the card)")
    args = ap.parse_args(argv)
    import torch

    from starway_tpu_torch.bench import parse_size

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    return asyncio.run(run(args.ranks, parse_size(args.chunk), args.device))


if __name__ == "__main__":
    main()
