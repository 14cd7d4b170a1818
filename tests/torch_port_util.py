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


def ep_worker(rank: int, world: int, port: int, folder: str) -> None:
    """One process of a ``torch.distributed`` (gloo) expert-parallel run:
    reads ``in.npz`` from ``folder`` (the global tensors and the MoE
    layer), takes its ``n / world`` shards of a mesh ``{"ep": n}`` split
    over ``world`` processes, runs every collective and the sharded MoE
    dispatch over them, and writes its shards of each result to
    ``out<rank>.npz`` (see tests/test_torch_moe.py ``ep_runs``)."""
    import torch.distributed as dist

    from starway_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        data = {k: torch.from_numpy(v) for k, v in
                np.load(f"{folder}/in.npz").items()}
        n = int(data.pop("n"))
        mesh = make_mesh({"ep": n}, device="cpu", group=dist.group.WORLD)
        mine = mesh.local_range("ep")
        out = {}
        for name, shards in ep_runs(data, n, mesh, mine).items():
            for i, t in zip(mine, shards):
                out[f"{name}_{i}"] = t.numpy()
        np.savez(f"{folder}/out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def ep_runs(data: dict, n: int, mesh, mine) -> dict:
    """The collectives and the sharded MoE over the shards ``mine`` of
    ``mesh``'s ``"ep"`` axis: ``{name: this process's output shards}``.
    ``data`` holds ``x`` (cut on dim 0), ``u`` (cut on dim 0, its dim 1 of
    size n for the untiled all_to_all), and the MoE layer ``moe_x``
    (cut on the sequence), ``router``, ``w_in``, ``w_out``, ``w_gate``
    (cut on the experts)."""
    from starway_tpu_torch.models.moe import sharded_switch_moe
    from starway_tpu_torch.ops import collectives as col

    def cut(t, dim=0):
        return [t.chunk(n, dim=dim)[i].contiguous() for i in mine]

    x, u = cut(data["x"]), cut(data["u"])
    runs = {
        "all_to_all_tiled": col.all_to_all(x, mesh, "ep", 1, 0),
        "all_to_all_untiled": col.all_to_all(u, mesh, "ep", 1, 0,
                                             tiled=False),
        "all_gather": col.all_gather(x, mesh, "ep", 1),
        "psum": col.psum(x, mesh, "ep"),
        "pmean": col.pmean(x, mesh, "ep"),
        "reduce_scatter": col.reduce_scatter(x, mesh, "ep", 1),
        "ring_reduce": col.ring_reduce(x, mesh, "ep"),
    }
    ys, aux, stats = sharded_switch_moe(
        cut(data["moe_x"], 1), data["router"], cut(data["w_in"]),
        cut(data["w_out"]), mesh, "ep", capacity_factor=4.0, k=2,
        with_stats=True, w_gates=cut(data["w_gate"]))
    runs["moe_y"] = ys
    runs["moe_packed"] = [torch.cat([aux[None], stats["drop_fraction"][None],
                                     stats["expert_load"]])] * len(mine)
    return runs


def mesh_worker(rank: int, world: int, port: int, folder: str) -> None:
    """One process of a ``torch.distributed`` (gloo) run of the model over
    a mesh split over ``world`` processes: :func:`mesh_runs` with the
    default group, written to ``out<rank>.npz`` in ``folder``."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        np.savez(f"{folder}/out{rank}.npz", **mesh_runs(dist.group.WORLD))
    finally:
        dist.destroy_process_group()


def _record(out: dict, name: str, tree) -> None:
    """Every shard of a sharded tree (each slot's box) into ``out``."""
    from starway_tpu_torch.models.sharded import _paths
    from starway_tpu_torch.parallel.sharding import spec_axes

    for path, x in _paths(tree):
        key = f"{name}/{'.'.join(path)}"
        if hasattr(x, "shards"):
            for slot, t in x.shards.items():
                out[f"{key}/{slot.index}"] = to_numpy(t)
            out[f"{key}/held"] = np.int64(sum(
                t.numel() for t in x.tree_children()))
            out[f"{key}/total"] = np.int64(np.prod(x.shape))
            out[f"{key}/sharded"] = np.bool_(spec_axes(x.sharding.spec))
        else:
            out[key] = to_numpy(x)


def mesh_runs(group=None) -> dict:
    """The model over meshes of four slots (debug widths, float32, seeded
    weights and batch), ``group`` holding the slots (None: this process
    holds all four): a dp x tp forward, loss and gradients; an
    expert-parallel (dp x ep) AdamW step with ``make_sharded_moe``; the
    natural-order zigzag attention of a sequence over ``{"sp": 4}``, and
    the gradient of its q; and a ZeRO ``Trainer`` step over ``{"fsdp":
    4}``.  Returns ``{name:
    array}``, the shards of this process's slots."""
    from starway_tpu_torch.models import llama as tl
    from starway_tpu_torch.models.moe import make_sharded_moe
    from starway_tpu_torch.models.trainer import Trainer
    from starway_tpu_torch.parallel import (make_mesh,
                                            make_zigzag_ring_attention,
                                            shard_tree)
    from starway_tpu_torch.utils.optim import adamw

    out = {}
    batch = torch.as_tensor(np.random.default_rng(3).integers(
        0, 512, (4, 17))).long()
    cfg = tl.LlamaConfig.preset("debug", n_layers=1)
    mesh = make_mesh({"dp": 2, "tp": 2}, device="cpu", group=group)
    sh = shard_tree(tl.init_params(cfg, seed=0, device="cpu"), mesh,
                    tl.param_specs(cfg))
    out["dptp/logits"] = to_numpy(tl.forward(sh, batch[:, :-1], cfg))
    loss, grads = tl.value_and_grad(sh, batch, cfg)
    out["dptp/loss"] = to_numpy(loss)
    _record(out, "dptp/grad", grads)

    mcfg = tl.LlamaConfig.preset("debug", n_layers=1, n_experts=4,
                                 moe_top_k=2, moe_swiglu=True)
    mesh = make_mesh({"dp": 2, "ep": 2, "tp": 1}, device="cpu",
                     group=group)
    sh = shard_tree(tl.init_params(mcfg, seed=1, device="cpu"), mesh,
                    tl.param_specs(mcfg))
    tx = adamw(1e-3)
    step = tl.make_train_step(mcfg, tx, moe_fn=make_sharded_moe(
        mesh, k=2, swiglu=True, capacity_factor=1.25))
    sh, opt, loss = step(sh, tx.init(sh), batch)
    out["ep/loss"] = to_numpy(loss)
    _record(out, "ep/params", sh)

    q, k, v, vd = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (1, 2, 32, 16)).astype(np.float32)) for i in range(4))
    mesh = make_mesh({"sp": 4}, device="cpu", group=group)
    rows = 32 // mesh.world
    cut = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    leaves = [x[:, :, cut].clone().requires_grad_() for x in (q, k, v)]
    o = make_zigzag_ring_attention(mesh)(*leaves)
    (o * vd[:, :, cut]).sum().backward()
    out["zigzag/out"] = to_numpy(o)
    out["zigzag/dq"] = to_numpy(leaves[0].grad)

    fcfg = tl.LlamaConfig.preset("debug", n_layers=1, d_model=64, n_heads=4,
                                 n_kv_heads=4, d_ff=128, vocab_size=256)
    mesh = make_mesh({"fsdp": 4}, device="cpu", group=group)
    t = Trainer(fcfg, adamw(3e-3), tl.init_params(fcfg, seed=2, device="cpu"),
                mesh=mesh, fsdp_axis="fsdp")
    out["fsdp/loss"] = np.float32(t.step_sync(batch % 256))
    _record(out, "fsdp/params", t.state.params)
    _record(out, "fsdp/mu", t.state.opt_state.mu)
    _record(out, "fsdp/nu", t.state.opt_state.nu)
    return out


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


# ------------------------------------------------------- reshard children
#
# Spawned by tests/test_torch_reshard.py across a real process boundary;
# they import only the port, and say so.

RESHARD_SHAPE = (16, 4096)


def reshard_child_rank1(port, folder, q, release) -> None:
    """Rank 1 of a redistribution in its own process: a pure receiver on
    its OWN mesh of 8 CPU slots (columns over 8), with the spec exchange
    over the fabric as the only coordination; checks its shards against
    the checkpoint the parent saved of the source, box by box, and its
    staging peak against the plan's bound.

    The parent listens before it starts this process, so one connect
    attempt suffices; the child says ``"connected"`` on ``q`` once it is
    in.  It keeps its connection open until the parent sets ``release``:
    a receiver has nothing to flush, and closing as soon as its last
    round has arrived resets the link under the sender's flush of that
    round (``peer reset during flush``) whenever the sender's flush
    comes later than the receiver's checks, as it does on a loaded
    host."""
    import asyncio
    import os
    import traceback

    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_NATIVE"] = "0"
    try:
        from starway_tpu_torch import Client
        from starway_tpu_torch.reshard import (ArrayRef, SlotMesh,
                                               SlotSharding, executor,
                                               redistribute)
        from starway_tpu_torch.utils.checkpoint import restore_pytree

        _assert_port_only()
        mesh = SlotMesh({"x": 8}, devices="cpu", ranks=1)
        dst = SlotSharding(mesh, (None, "x"))

        async def run():
            client = Client()
            await client.aconnect("127.0.0.1", port)
            q.put("connected")
            res = await redistribute(
                ArrayRef(RESHARD_SHAPE, torch.float32), dst, {0: client},
                rank=1, lease_slot=3, round_timeout=60)
            oracle = restore_pytree(
                os.path.join(folder, "ck"),
                {"w": torch.zeros(RESHARD_SHAPE, dtype=torch.float32)})["w"]
            boxes = dst.indices_map(RESHARD_SHAPE)
            for slot, t in res.array.shards.items():
                want = oracle[tuple(slice(lo, hi) for lo, hi in boxes[slot])]
                if not torch.equal(t, want):
                    raise AssertionError(f"slot {slot.index}: redistributed "
                                         f"!= checkpoint restore")
            peak = executor.staging_snapshot()["peak"]
            bound = res.stats["peak_staging_bound"]
            if peak > bound:
                raise AssertionError(f"staging {peak} > bound {bound}")
            q.put({"ok": True, "peak": peak, "bound": bound,
                   "rounds": res.stats["rounds"]})
            await asyncio.get_running_loop().run_in_executor(
                None, release.wait, 120)
            await client.aclose()

        asyncio.run(run())
    except Exception:
        q.put({"ok": False, "error": traceback.format_exc()})


def reshard_dtensor_worker(rank, gloo_port, sw_port, q) -> None:
    """One of two processes of a gloo group: lowers DTensor layouts over a
    ``DeviceMesh("cpu", [0, 1])`` and redistributes an unevenly sharded
    DTensor over the fabric (rank 0 serves, rank 1 connects), held against
    DTensor's own ``redistribute`` over gloo."""
    import asyncio
    import os
    import traceback

    import torch.distributed as dist

    os.environ["STARWAY_TLS"] = "tcp"
    os.environ["STARWAY_NATIVE"] = "0"
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard, distribute_tensor)

        from starway_tpu_torch import Client, Server
        from starway_tpu_torch.parallel.dp_exchange import (ClientPort,
                                                            ServerPort)
        from starway_tpu_torch.reshard import (SlotMesh, SlotSharding,
                                               redistribute,
                                               spec_from_sharding)

        _assert_port_only()
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{gloo_port}",
                                world_size=2, rank=rank)
        mesh = init_device_mesh("cpu", (2,))
        out = {}
        # Even layouts lower to the same spec as the slot description.
        slots = SlotMesh({"x": 2}, devices="cpu", ranks=[0, 1])
        for pl, spec in (([Shard(0)], ("x",)), ([Shard(1)], (None, "x")),
                         ([Replicate()], ())):
            got = spec_from_sharding((mesh, pl), (8, 6), 4, only_rank=rank)
            want = spec_from_sharding(SlotSharding(slots, spec), (8, 6), 4,
                                      only_rank=rank)
            if got.to_dict() != want.to_dict():
                raise AssertionError(f"{pl}: {got.to_dict()} != "
                                     f"{want.to_dict()}")
        out["lowering"] = "equal"

        x = torch.arange(5 * 7, dtype=torch.float32).reshape(5, 7)
        src = distribute_tensor(x, mesh, [Shard(0)])  # rows 3 + 2
        dst = (mesh, (Shard(1),))                     # columns 4 + 3
        partial = DTensor.from_local(torch.ones(5, 7), mesh, [Partial()],
                                     run_check=False)

        async def run():
            try:
                await redistribute(partial, dst, rank=rank, lease_slot=4)
                raise AssertionError("a Partial placement was accepted")
            except ValueError:
                out["partial"] = "refused"
            if rank == 0:
                server = Server()
                server.listen("127.0.0.1", sw_port)
                for _ in range(24000):
                    if server.list_clients():
                        break
                    await asyncio.sleep(0.005)
                link, closer = ServerPort(server), server
            else:
                for _ in range(240):
                    client = Client()
                    try:
                        await client.aconnect("127.0.0.1", sw_port)
                        break
                    except Exception:
                        await asyncio.sleep(0.25)
                link, closer = ClientPort(client), client
            res = await redistribute(src, dst, {1 - rank: link}, rank=rank,
                                     lease_slot=5, round_timeout=60)
            await link.aflush()
            await closer.aclose()
            return res

        res = asyncio.run(run())
        got = res.to_dtensor()
        want = src.redistribute(mesh, [Shard(1)])
        if tuple(got.to_local().shape) != tuple(want.to_local().shape):
            raise AssertionError(f"local {tuple(got.to_local().shape)} != "
                                 f"DTensor's {tuple(want.to_local().shape)}")
        if not torch.equal(got.to_local(), want.to_local()):
            raise AssertionError("local shard differs from DTensor's own")
        if not torch.equal(got.full_tensor(), x):
            raise AssertionError("full tensor differs")
        out["local_shape"] = tuple(got.to_local().shape)
        out["rounds"] = res.stats["rounds"]
        q.put({"ok": True, "rank": rank, **out})
    except Exception:
        q.put({"ok": False, "rank": rank, "error": traceback.format_exc()})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
