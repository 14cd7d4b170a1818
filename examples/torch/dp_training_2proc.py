"""Two-process data-parallel training over the async P2P fabric, on the
PyTorch port.

Twin of examples/dp_training_2proc.py (BASELINE config 5 as a living
loop): two ranks, each a spawned process, run the Llama model on their own
batch shard and average gradients every step by exchanging trees through
``asend``/``arecv`` + ``aflush`` (parallel/dp_exchange.py
``send_pytree``/``recv_pytree`` over ``ServerPort``/``ClientPort``).

Rank 0 serves (worker-address bootstrap written to a handoff file); rank 1
connects.  Both apply identical averaged updates (utils/optim.py
``adamw(1e-3)``), so the parameters stay bit-identical across ranks:
asserted at the end on every byte of every leaf.  Both ranks run on the
card (``cuda:0``) by default: each step's forward and backward run the
flash kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu), and every gradient
leaf crosses to the other rank by one CUDA IPC pull (asserted; the ranks
set ``STARWAY_DEVPULL_MIN=1``, so the norms' small leaves are pulled
too).  With ``--device cpu`` the leaves ride staged frames.

Run:  python examples/torch/dp_training_2proc.py [--steps 3] [--device cpu]
"""

import argparse
import asyncio
import hashlib
import multiprocessing as mp
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

GRAD_TAG = 0x6000
STEPS_DEFAULT = 3


def _build(device: str, params=None):
    from starway_tpu_torch.models import LlamaConfig, init_params
    from starway_tpu_torch.utils.tree import tree_map
    from starway_tpu_torch.utils.optim import adamw

    cfg = LlamaConfig.preset("debug")
    if params is None:
        params = init_params(cfg, seed=0, device=device)  # same on both ranks
    else:
        # A copy of its own: tensors handed to a spawned process share the
        # parent's memory, and each rank updates its tree in place.
        params = tree_map(lambda t: t.to(device, copy=True), params)
    tx = adamw(1e-3)
    opt_state = tx.init(params)
    return cfg, params, tx, opt_state


async def _train(rank: int, port_file: str, steps: int, device: str,
                 params=None) -> dict:
    import numpy as np
    import torch

    from starway_tpu_torch import Client, Server
    from starway_tpu_torch.models.llama import apply_updates, value_and_grad
    from starway_tpu_torch.parallel import (ClientPort, ServerPort,
                                            recv_pytree, send_pytree)
    from starway_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg, params, tx, opt_state = _build(device, params)

    if rank == 0:
        server = Server()
        blob = server.listen_address()
        with open(port_file, "wb") as f:
            f.write(blob)
        while not server.list_clients():
            await asyncio.sleep(0.05)
        port = ServerPort(server)
        endpoint, worker = server, server._server
    else:
        for _ in range(100):
            if os.path.exists(port_file) and os.path.getsize(port_file):
                break
            await asyncio.sleep(0.1)
        blob = open(port_file, "rb").read()
        client = Client()
        for i in range(40):
            try:
                await client.aconnect_address(blob)
                break
            except Exception:
                client = Client()
                await asyncio.sleep(0.25)
        port = ClientPort(client)
        endpoint, worker = client, client._client

    rng = np.random.default_rng(100 + rank)  # different data per rank
    losses = []
    for step in range(steps):
        batch = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 33),
                                             dtype=np.int32),
                                device=device).long()
        loss, grads = value_and_grad(params, batch, cfg)

        # DP boundary: exchange gradient trees and average.
        base = GRAD_TAG + step * 256
        send_task = asyncio.ensure_future(send_pytree(port, grads,
                                                      base_tag=base))
        peer_grads = await recv_pytree(port, like=grads, base_tag=base)
        await send_task
        grads = tree_map(lambda a, b: (a + b) / 2, grads, peer_grads)

        params, opt_state = apply_updates(tx, params, opt_state, grads)
        losses.append(float(loss))
        print(f"[rank {rank}] step {step}: loss={losses[-1]:.4f}", flush=True)

    leaves = tree_leaves(params)
    digest = hashlib.sha256()
    for x in leaves:
        digest.update(x.detach().cpu().contiguous().view(torch.uint8)
                      .numpy().tobytes())
    mgr = worker.transfer_manager()
    pulls = mgr.counts["pulled_ipc"] if mgr is not None else 0
    await endpoint.aclose()
    return {"digest": digest.hexdigest(), "losses": losses,
            "ipc_pulls": pulls, "leaves_received": steps * len(leaves)}


def _rank_main(rank: int, port_file: str, steps: int, device: str, params,
               out_q) -> None:
    # Every gradient leaf by the pull, the norms' too: below 64 KiB
    # (STARWAY_DEVPULL_MIN's default) a device payload rides staged frames.
    os.environ["STARWAY_DEVPULL_MIN"] = "1"
    try:
        res = asyncio.run(_train(rank, port_file, steps, device, params))
    except BaseException as e:  # the parent reports it, not a hang
        res = {"error": f"{type(e).__name__}: {e}"}
    out_q.put((rank, res))


def run(steps: int, device: str, params=None) -> dict:
    """Both ranks on ``device`` from ``params`` (default: ``init_params``
    at seed 0); returns each rank's result (losses, parameter digest, IPC
    pulls)."""
    from starway_tpu_torch.utils.tree import tree_map

    if params is not None:
        params = tree_map(lambda t: t.detach().cpu(), params)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as td:
        pf = os.path.join(td, "addr.bin")
        ps = [ctx.Process(target=_rank_main,
                          args=(r, pf, steps, device, params, q), daemon=True)
              for r in (0, 1)]
        for p in ps:
            p.start()
        ranks = dict(q.get(timeout=600) for _ in range(2))
        for p in ps:
            p.join()
    for r, res in sorted(ranks.items()):
        if "error" in res:
            raise RuntimeError(f"rank {r} failed: {res['error']}")
    assert ranks[0]["digest"] == ranks[1]["digest"], (
        "ranks diverged after averaged updates!")
    if device.startswith("cuda"):
        for r, res in sorted(ranks.items()):
            assert res["ipc_pulls"] == res["leaves_received"], (
                f"rank {r}: {res['ipc_pulls']} CUDA IPC pulls for "
                f"{res['leaves_received']} gradient leaves")
        print(f"every gradient leaf crossed by CUDA IPC: "
              f"{ranks[0]['ipc_pulls']} pulls a rank")
    print(f"OK: {steps} DP steps, parameters identical across ranks")
    return ranks


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS_DEFAULT)
    ap.add_argument("--device", default="cuda",
                    help="where both ranks run (default: the card)")
    args = ap.parse_args(argv)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    device = "cuda:0" if args.device == "cuda" else args.device
    return run(args.steps, device)


if __name__ == "__main__":
    main()
