"""Helpers shared by the tests that hold the PyTorch port
(starway_tpu_torch) against the JAX package: arrays cross between the two
as numpy, on the CPU."""

import numpy as np
import torch

from starway_tpu_torch.models.convert import params_from_numpy

# The shapes here are tiny: one intra-op thread keeps these tests from
# oversubscribing the cores that the suite's parallel workers share with
# the timing-sensitive transport tests.
torch.set_num_threads(1)


def to_torch(x) -> torch.Tensor:
    """A JAX or numpy array as a CPU torch tensor (bfloat16 bit for bit)."""
    return params_from_numpy(np.asarray(x), device="cpu")


def to_numpy(t) -> np.ndarray:
    """A torch tensor as float32/int numpy (bfloat16 widens exactly)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def tree_to_numpy(tree):
    """A JAX parameter tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def ring_worker(rank: int, world: int, port: int, folder: str) -> None:
    """One process of a ``torch.distributed`` (gloo) ring-attention run:
    reads ``in.npz`` from ``folder`` (global q, k, v and the output
    cotangent vd, and the zigzag-ordered copies), runs ring attention and
    zigzag ring attention over its slice on a mesh ``{"sp": n}`` split
    over ``world`` processes, and writes the output and the gradients of
    its slice to ``out<rank>.npz``."""
    import torch.distributed as dist

    from starway_tpu_torch.parallel import (make_mesh, ring_attention,
                                            zigzag_ring_attention)

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        data = np.load(f"{folder}/in.npz")
        n = int(data["n"])
        mesh = make_mesh({"sp": n}, device="cpu", group=dist.group.WORLD)
        out = {}
        for name, fn in (("ring", ring_attention),
                         ("zigzag", zigzag_ring_attention)):
            pre = "" if name == "ring" else "z"
            s = data[pre + "q"].shape[2] // world
            cut = slice(rank * s, (rank + 1) * s)
            leaves = [torch.from_numpy(data[pre + x][:, :, cut].copy())
                      .requires_grad_() for x in ("q", "k", "v")]
            o = fn(*leaves, mesh, "sp")
            (o * torch.from_numpy(data[pre + "vd"][:, :, cut].copy())
             ).sum().backward()
            out[name] = o.detach().numpy()
            for x, leaf in zip("qkv", leaves):
                out[f"{name}_d{x}"] = leaf.grad.numpy()
        np.savez(f"{folder}/out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- transport children
#
# Spawned across a real process boundary by tests/test_torch_transport.py
# (the flush semantics of tests/test_basic.py): they import only the port,
# and say so.

INFLIGHT_BYTES = 1 << 30  # 1 GiB: far beyond any socket buffer


def _assert_port_only() -> None:
    import sys

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "starway_tpu"))
    assert not bad, bad


def transport_child_server_send(port, with_flush, use_flush_ep):
    import asyncio
    import os

    os.environ["STARWAY_TLS"] = "tcp"
    from starway_tpu_torch import Server

    _assert_port_only()

    async def inner():
        server = Server()
        server.listen("127.0.0.1", port)
        connected = asyncio.Event()
        loop = asyncio.get_running_loop()
        server.set_accept_cb(
            lambda ep: loop.call_soon_threadsafe(connected.set))
        await asyncio.wait_for(connected.wait(), timeout=120)
        ep = next(iter(server.list_clients()))
        send_buf = np.arange(INFLIGHT_BYTES, dtype=np.uint8)
        await server.asend(ep, send_buf, 0)
        if with_flush:
            if use_flush_ep:
                await server.aflush_ep(ep)
            else:
                await server.aflush()
        await server.aclose()

    asyncio.run(inner())


def transport_child_client_send(port, with_flush):
    import asyncio
    import os

    os.environ["STARWAY_TLS"] = "tcp"
    from starway_tpu_torch import Client

    _assert_port_only()

    async def inner():
        client = None
        for i in range(60):
            client = Client()
            try:
                await client.aconnect("127.0.0.1", port)
                break
            except Exception:
                if i == 59:
                    raise
                await asyncio.sleep(0.25)
        send_buf = np.arange(INFLIGHT_BYTES, dtype=np.uint8)
        await client.asend(send_buf, 0)
        if with_flush:
            await client.aflush()
        await client.aclose()

    asyncio.run(inner())


# ------------------------------------------------- remote serving children
#
# Spawned by tests/test_torch_serve_remote.py across a real process
# boundary; they import only the port, and say so.

def serve_remote_child(role, port, arg, ready, stop, out_q) -> None:
    """``role="server"``: serve the debug model whose numpy weights are
    ``arg/params.npz`` (keys joined by '/') through a RemoteSlotServer on
    the CPU until ``stop``; ``role="client"``: run the requests ``arg``
    concurrently through one RemoteGenerateSession and put the streams (or
    the error) on ``out_q``."""
    import asyncio
    import os
    import sys

    os.environ["STARWAY_TLS"] = "tcp"
    torch.set_num_threads(1)

    from starway_tpu_torch.models import LlamaConfig, SlotServer
    from starway_tpu_torch.models.remote_serving import (
        RemoteGenerateSession, RemoteSlotServer)

    async def server():
        flat = np.load(os.path.join(arg, "params.npz"))
        tree: dict = {}
        for key in flat.files:
            *path, leaf = key.split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = flat[key]
        cfg = LlamaConfig.preset("debug")
        params = params_from_numpy(tree, device="cpu")
        bridge = RemoteSlotServer(SlotServer(params, cfg, n_slots=2,
                                             max_len=64, chunk=4))
        bridge.server.listen("127.0.0.1", port)
        ready.set()
        task = asyncio.create_task(bridge.serve())
        while not stop.is_set():
            await asyncio.sleep(0.05)
        bridge.stop()
        await task
        await bridge.aclose()

    async def client():
        session = None
        for _ in range(60):  # clients are connect-once: fresh per attempt
            try:
                session = await RemoteGenerateSession.aconnect("127.0.0.1",
                                                               port)
                break
            except Exception:
                await asyncio.sleep(0.25)
        assert session is not None, "could not connect to serving process"
        outs = await asyncio.gather(*(session.generate(p, m)
                                      for p, m in arg))
        await session.aclose()
        return [np.asarray(o).tolist() for o in outs]

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "starway_tpu"))
    if role == "server":
        assert not bad, bad
        asyncio.run(server())
        return
    try:
        assert not bad, bad
        out_q.put(asyncio.run(client()))
    except Exception as exc:  # the parent reports it
        out_q.put(f"client failed: {exc!r}")
