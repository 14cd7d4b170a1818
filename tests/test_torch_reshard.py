"""``redistribute()`` on the port: the twins of tests/test_reshard.py.

The same numpy inputs go through the JAX package's ``redistribute`` (on
its virtual 8-device CPU mesh) and the port's (on a ``SlotMesh`` of 8 CPU
slots), and the results are held equal byte for byte: local retiles
against the checkpoint oracle, partial replication, two simulated ranks
over every engine pairing, device payloads, two OS processes, a killed
connection under a session, the counters and gauges, and HELLO parity.
The port's slot description is held against JAX's ``devices_indices_map``
box for box; a DTensor layout is lowered and redistributed in a
two-process gloo group; and a JAX rank and a port rank redistribute one
array together, on both engines."""

import asyncio
import json
import multiprocessing as mp
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import starway_tpu
import starway_tpu.reshard as jax_reshard
import starway_tpu_torch
from starway_tpu_torch import Client, Server
from starway_tpu_torch.core import frames
from starway_tpu_torch.parallel.dp_exchange import ServerPort
from starway_tpu_torch.reshard import (
    ArrayRef,
    ShardedTensor,
    SlotMesh,
    SlotSharding,
    executor,
    lease,
    redistribute,
)
from starway_tpu_torch.testing.faults import FaultProxy
from starway_tpu_torch.utils.checkpoint import restore_pytree, save_pytree
from torch_port_util import (RESHARD_SHAPE, reshard_child_rank1,
                             reshard_dtensor_worker)

pytestmark = pytest.mark.asyncio

ADDR = "127.0.0.1"
MASK = (1 << 64) - 1
CPU = "cpu"
ENGINE_PAIRS = ["py-py", "native-native", "py-native", "native-py"]


def test_lazy_names_resolve():
    """The package's lazy names resolve to api.py's (they raised
    ImportError while the module was missing)."""
    from starway_tpu_torch.reshard import api

    import starway_tpu_torch.reshard as reshard

    for name in ("redistribute", "ArrayRef", "ReshardResult",
                 "spec_from_sharding", "default_rank_of", "Slot",
                 "SlotMesh", "SlotSharding", "ShardedTensor"):
        assert getattr(reshard, name) is getattr(api, name)
        assert name in reshard.__all__
    with pytest.raises(AttributeError):
        reshard.no_such_name


# ----------------------------------------------------- slot descriptions


def _jax_mesh(shape, names, first=0):
    n = int(np.prod(shape))
    devs = np.array(jax.devices()[first:first + n]).reshape(shape)
    return Mesh(devs, names)


def _slot_mesh(shape, names, ranks=0):
    return SlotMesh(dict(zip(names, shape)), devices=CPU, ranks=ranks)


def _spec_tuple(spec: P) -> tuple:
    return tuple(spec)


def _jax_boxes(sharding, shape, mesh) -> list:
    """JAX's devices_indices_map as boxes in the mesh's row-major order."""
    idx = sharding.devices_indices_map(shape)
    out = []
    for dev in mesh.devices.reshape(-1):
        box = []
        for sl, dim in zip(idx[dev], shape):
            lo = 0 if sl.start is None else sl.start
            hi = dim if sl.stop is None else sl.stop
            box.append((lo, hi))
        out.append(tuple(box))
    return out


# Every (mesh, spec, shape) tests/test_reshard.py uses, and an axis pair.
INDEX_CASES = [
    ((8,), ("x",), spec, shape)
    for spec in (P(None, None), P("x", None), P(None, "x"), P("x"))
    for shape in ((16, 64), (16, 4096), (8, 8), (8, 1024))
] + [
    ((2, 4), ("x", "y"), P("x"), (8, 12)),
    ((2, 4), ("x", "y"), P(None, "y"), (8, 12)),
    ((2, 4), ("x", "y"), P(("y", "x")), (16, 4)),
    ((2, 4), ("x", "y"), P("y", "x"), (8, 6)),
    ((2, 4), ("x", "y"), P(None, ("x", "y")), (2, 16)),
    ((4,), ("x",), P("x", None), (16, 4096)),
    ((4,), ("x",), P(None, "x"), (16, 1 << 20)),
    ((4,), ("x",), P(None, "x"), (8, 512)),
]


@pytest.mark.parametrize("mesh_shape,names,spec,shape", INDEX_CASES)
def test_indices_map_matches_jax(mesh_shape, names, spec, shape):
    jmesh = _jax_mesh(mesh_shape, names)
    want = _jax_boxes(NamedSharding(jmesh, spec), shape, jmesh)
    sh = SlotSharding(_slot_mesh(mesh_shape, names), _spec_tuple(spec))
    got = sh.indices_map(shape)
    assert [got[s] for s in sh.slots] == want


@pytest.mark.parametrize("spec,shape", [(P("x"), (10,)), (P("x"), (3,)),
                                        (P(None, "x"), (7, 5))])
def test_uneven_split_refused_as_jax_does(spec, shape):
    jmesh = _jax_mesh((8,), ("x",))
    with pytest.raises(ValueError):
        NamedSharding(jmesh, spec).devices_indices_map(shape)
    with pytest.raises(ValueError, match="even"):
        SlotSharding(_slot_mesh((8,), ("x",)), _spec_tuple(spec)
                     ).indices_map(shape)


def test_bad_specs_refused():
    mesh = _slot_mesh((2, 4), ("x", "y"))
    with pytest.raises(ValueError, match="twice"):
        SlotSharding(mesh, ("x", "x"))
    with pytest.raises(ValueError, match="not in the mesh"):
        SlotSharding(mesh, ("z",))
    with pytest.raises(ValueError, match="more dimensions"):
        SlotSharding(mesh, (None, "x")).indices_map((8,))
    with pytest.raises(ValueError, match="slots"):
        SlotMesh({"x": 4}, devices=[CPU] * 3)


def test_sharded_tensor_round_trip():
    x = torch.arange(8 * 12, dtype=torch.int32).reshape(8, 12)
    sh = SlotSharding(_slot_mesh((2, 4), ("x", "y")), ("x",))
    st = ShardedTensor.from_tensor(x, sh)
    assert len(st.shards) == 8
    assert torch.equal(st.full(), x)
    part = ShardedTensor(x.shape, x.dtype, sh,
                         {s: t for s, t in st.shards.items() if s.index % 4 == 0})
    assert torch.equal(part.full(), x)  # one copy of each replicated box
    with pytest.raises(ValueError, match="cover"):
        ShardedTensor(x.shape, x.dtype, sh,
                      {s: st.shards[s] for s in sh.slots[:1]}).full()
    with pytest.raises(ValueError, match="box"):
        ShardedTensor(x.shape, torch.int32, sh,
                      {sh.slots[0]: torch.zeros(3, 12, dtype=torch.int32)})


# ------------------------------------------------- local retile vs oracle

LOCAL_PAIRS = [
    (P(None, None), P("x", None)),
    (P("x", None), P(None, None)),
    (P("x", None), P(None, "x")),
    (P(None, "x"), P("x", None)),
]


def _torch_of(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _assert_shards(res, sharding, full: np.ndarray):
    """Every destination shard equals its box of ``full``, byte for byte."""
    boxes = sharding.indices_map(full.shape)
    assert set(res.shards) == set(sharding.slots)
    for slot, t in res.shards.items():
        want = full[tuple(slice(lo, hi) for lo, hi in boxes[slot])]
        assert t.device == slot.device
        got = t.contiguous().view(torch.uint8).numpy().tobytes()
        assert got == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("src_spec,dst_spec", LOCAL_PAIRS)
async def test_local_retile_matches_jax_and_checkpoint_oracle(
        tmp_path, src_spec, dst_spec):
    """Single-process retile over 8 slots: the port's shards equal the
    JAX package's retile on its 8-device mesh, and both equal the
    checkpoint oracle (the port's npz save of the source, restored and cut
    into the destination's boxes)."""
    x = np.arange(16 * 64, dtype=np.float32).reshape(16, 64)
    jmesh = _jax_mesh((8,), ("x",))
    jres = await jax_reshard.redistribute(
        jax.device_put(jnp.asarray(x), NamedSharding(jmesh, src_spec)),
        NamedSharding(jmesh, dst_spec))
    jout = np.asarray(jres.array)

    mesh = _slot_mesh((8,), ("x",))
    src_sh = SlotSharding(mesh, _spec_tuple(src_spec))
    dst_sh = SlotSharding(mesh, _spec_tuple(dst_spec))
    st = ShardedTensor.from_tensor(_torch_of(x), src_sh)
    save_pytree(str(tmp_path / "ck"), {"w": st.full()})
    res = await redistribute(st, dst_sh)

    oracle = restore_pytree(str(tmp_path / "ck"),
                            {"w": torch.zeros(16, 64)})["w"].numpy()
    _assert_shards(res, dst_sh, oracle)
    _assert_shards(res, dst_sh, jout)
    assert res.array.full().numpy().tobytes() == jout.tobytes()


async def test_partial_replication_retile():
    """2x4 slots, ('x',) -> (None, 'y'): partially replicated source blocks
    pick one holder per piece; the result equals the JAX package's."""
    x = np.arange(8 * 12, dtype=np.int32).reshape(8, 12)
    jmesh = _jax_mesh((2, 4), ("x", "y"))
    jres = await jax_reshard.redistribute(
        jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("x"))),
        NamedSharding(jmesh, P(None, "y")))
    mesh = _slot_mesh((2, 4), ("x", "y"))
    dst_sh = SlotSharding(mesh, (None, "y"))
    res = await redistribute(
        ShardedTensor.from_tensor(_torch_of(x), SlotSharding(mesh, ("x",))),
        dst_sh)
    _assert_shards(res, dst_sh, np.asarray(jres.array))
    assert res.stats["rounds"] == 0  # every piece is a local copy


# ------------------------------------- cross-rank over the fabric (1 proc)


def _need_native(*engines):
    if "native" in engines:
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")


async def _connect(client, server, port):
    """``client.aconnect`` and then wait, as long again, for the server to
    list the client: the connect can return before the server's worker
    has registered the endpoint that ``ServerPort`` binds to."""
    await asyncio.wait_for(client.aconnect(ADDR, port), 30)
    for _ in range(6000):
        if server.list_clients():
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the server never listed the client")


def _two_rank_shardings():
    """Rank 0's 4 slots hold rows; rank 1's 4 slots take columns (the JAX
    test's devices 0-3 and 4-7 under its split rank_of)."""
    src = SlotSharding(_slot_mesh((4,), ("x",), ranks=0), ("x", None))
    dst = SlotSharding(_slot_mesh((4,), ("x",), ranks=1), (None, "x"))
    return src, dst


def _jax_two_rank_shardings():
    devs = jax.devices()
    return (NamedSharding(Mesh(np.array(devs[:4]), ("x",)), P("x", None)),
            NamedSharding(Mesh(np.array(devs[4:]), ("x",)), P(None, "x")))


async def _jax_twin(x: np.ndarray, via: str = "host") -> np.ndarray:
    """The JAX package's retile of ``x`` between the two-rank shardings."""
    src_sh, dst_sh = _jax_two_rank_shardings()
    res = await jax_reshard.redistribute(
        jax.device_put(jnp.asarray(x), src_sh), dst_sh, via=via)
    return np.asarray(res.array)


@pytest.mark.parametrize("pairing", ENGINE_PAIRS)
async def test_cross_rank_redistribute_all_pairings(pairing, port,
                                                    monkeypatch):
    """Two simulated ranks over a real TCP conn, all four engine
    pairings: rows on rank 0 land column-sharded on rank 1, equal to the
    JAX package's result byte for byte, with peak staging inside the
    bound (both ranks in one process: 2 x the plan's)."""
    s_eng, c_eng = pairing.split("-")
    _need_native(s_eng, c_eng)
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    src_sh, dst_sh = _two_rank_shardings()
    shape = (16, 4096)
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    st = ShardedTensor.from_tensor(_torch_of(x), src_sh)

    monkeypatch.setenv("STARWAY_NATIVE", "1" if s_eng == "native" else "0")
    server = Server()
    server.listen(ADDR, port)
    monkeypatch.setenv("STARWAY_NATIVE", "1" if c_eng == "native" else "0")
    client = Client()
    try:
        await _connect(client, server, port)
        executor.reset_staging_peak()
        with lease() as L:
            res0, res1 = await asyncio.gather(
                redistribute(st, None, {1: client}, rank=0, lease=L),
                redistribute(ArrayRef(shape, torch.float32), dst_sh,
                             {0: ServerPort(server)}, rank=1, lease=L))
        _assert_shards(res1, dst_sh, await _jax_twin(x))
        peak = executor.staging_snapshot()["peak"]
        assert peak <= 2 * res1.stats["peak_staging_bound"], res1.stats
        assert res1.stats["rx_bytes"] == res0.stats["tx_bytes"] \
            == x.nbytes
        with pytest.raises(ValueError, match="pure sender"):
            res0.array
    finally:
        try:
            await asyncio.wait_for(client.aclose(), 15)
        finally:
            await asyncio.wait_for(server.aclose(), 15)


@pytest.mark.parametrize("engine", ["python", "native"])
async def test_cross_rank_via_device_payloads(port, monkeypatch, engine):
    """via='device': each transfer's slice of the source goes out as a
    device payload and lands in a DeviceBuffer by the pull (two workers of
    one process: its local route), on both engines; bf16 bytes equal the
    JAX package's via='device' result."""
    _need_native(engine)
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if engine == "native" else "0")
    monkeypatch.setenv("STARWAY_DEVPULL_MIN", "1")  # 1 KiB transfers pull
    src_sh, dst_sh = _two_rank_shardings()
    shape = (8, 1024)
    bits = np.random.default_rng(7).integers(0, 1 << 16, shape,
                                             dtype=np.uint16)
    x = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    st = ShardedTensor.from_tensor(x, src_sh)
    server = Server()
    server.listen(ADDR, port)
    client = Client()
    try:
        await _connect(client, server, port)
        with lease() as L:
            _, res1 = await asyncio.gather(
                redistribute(st, None, {1: client}, rank=0, lease=L,
                             via="device"),
                redistribute(ArrayRef(shape, torch.bfloat16), dst_sh,
                             {0: ServerPort(server)}, rank=1, lease=L,
                             via="device"))
        jout = await _jax_twin(jnp.asarray(bits).view(jnp.bfloat16),
                               via="device")
        assert jout.view(np.uint16).tobytes() == bits.tobytes()
        _assert_shards(res1, dst_sh, jout)
        mgr = server._server.transfer_manager()
        assert mgr.counts["pulled_local"] == res1.stats["rounds"] > 0
    finally:
        try:
            await asyncio.wait_for(client.aclose(), 15)
        finally:
            await asyncio.wait_for(server.aclose(), 15)


async def test_local_retile_via_device_copies_on_the_device():
    """A local retile via='device' never stages: the pieces are copied
    between the shards where they live."""
    x = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64)
    mesh = _slot_mesh((8,), ("x",))
    dst_sh = SlotSharding(mesh, (None, "x"))
    res = await redistribute(
        ShardedTensor.from_tensor(x, SlotSharding(mesh, ("x", None))),
        dst_sh, via="device")
    _assert_shards(res, dst_sh, x.numpy())
    assert res.stats["tx_bytes"] == res.stats["rx_bytes"] == 0


# ------------------------------------------------ two real processes


async def test_redistribute_across_two_processes(port, tmp_path,
                                                 monkeypatch):
    """A tensor moves between two shardings across 2 OS processes over
    the fabric: the child (port only, its own 8-slot mesh) checks its
    shards against the checkpoint the parent saved, and each side's peak
    staging against the bound."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    shape = RESHARD_SHAPE
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    src_sh = SlotSharding(_slot_mesh((8,), ("x",)), ("x", None))
    st = ShardedTensor.from_tensor(x, src_sh)
    save_pytree(str(tmp_path / "ck"), {"w": st.full()})

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    release = ctx.Event()
    proc = ctx.Process(target=reshard_child_rank1,
                       args=(port, str(tmp_path), q, release), daemon=True)
    server = Server()
    server.listen(ADDR, port)
    proc.start()
    loop = asyncio.get_running_loop()
    try:
        # Readiness is the child's word that it connected; the server then
        # lists it a moment later (aconnect returns before the listing).
        said = await loop.run_in_executor(None, lambda: q.get(timeout=120))
        assert said == "connected", said
        async def listed():
            while not server.list_clients():
                await asyncio.sleep(0.01)

        await asyncio.wait_for(listed(), 60)
        executor.reset_staging_peak()
        res0 = await redistribute(st, None, {1: ServerPort(server)}, rank=0,
                                  lease_slot=3, round_timeout=60)
        assert res0.stats["tx_bytes"] == x.numel() * 4
        peak = executor.staging_snapshot()["peak"]
        assert peak <= res0.stats["peak_staging_bound"], res0.stats
        verdict = await loop.run_in_executor(None,
                                             lambda: q.get(timeout=120))
        assert verdict.get("ok"), verdict.get("error")
        assert verdict["rounds"] > 1
    finally:
        release.set()
        proc.join(15)
        proc.terminate()
        proc.join(10)
        await asyncio.wait_for(server.aclose(), 15)


async def test_dtensor_lowering_in_a_gloo_group(port, port2):
    """Two processes of a gloo group: Shard/Replicate layouts over a
    DeviceMesh lower to the slot description's specs, Partial is refused,
    and an unevenly sharded DTensor (rows 3 + 2) redistributed over the
    fabric to columns (4 + 3) equals DTensor's own redistribute."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=reshard_dtensor_worker,
                         args=(r, port, port2, q), daemon=True)
             for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        loop = asyncio.get_running_loop()
        out = [await loop.run_in_executor(None, lambda: q.get(timeout=150))
               for _ in procs]
        for o in out:
            assert o["ok"], o.get("error")
            assert o["lowering"] == "equal" and o["partial"] == "refused"
        assert sorted(o["local_shape"] for o in out) == [(5, 3), (5, 4)]
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
                p.join(5)


# ------------------------------------------------ chaos: session resume


async def test_schedule_survives_conn_kill_with_session(port, monkeypatch):
    """STARWAY_SESSION=1 and a connection reset mid-transfer: the session
    layer redials and replays, the rounds complete exactly once, and the
    retile is still exact."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    monkeypatch.setenv("STARWAY_SESSION", "1")
    src_sh, dst_sh = _two_rank_shardings()
    shape = (16, 1 << 20)  # 16 MiB: four rounds of 4 MiB transfers
    x = (np.arange(int(np.prod(shape)), dtype=np.uint32) % 251).astype(
        np.uint8).reshape(shape)
    st = ShardedTensor.from_tensor(_torch_of(x), src_sh)
    server = Server()
    server.listen(ADDR, port)
    proxy = FaultProxy(ADDR, port).start()
    client = Client()
    try:
        await _connect(client, server, proxy.port)
        proxy.reset_mid_message(proxy.forwarded_bytes + (2 << 20))
        with lease() as L:
            _, res1 = await asyncio.wait_for(asyncio.gather(
                redistribute(st, None, {1: client}, rank=0, lease=L),
                redistribute(ArrayRef(shape, torch.uint8), dst_sh,
                             {0: ServerPort(server)}, rank=1, lease=L)), 120)
        _assert_shards(res1, dst_sh, x)
        assert client._client.counters_snapshot()["sessions_resumed"] >= 1
    finally:
        try:
            await asyncio.wait_for(client.aclose(), 15)
        finally:
            await asyncio.wait_for(server.aclose(), 15)
            proxy.stop()


def test_conn_io_skips_a_conn_its_write_suspended():
    """A reset peer makes a socket writable and readable in one event.
    The failed write suspends a session's conn, which stays alive without
    its socket; the read half of the event must then leave it alone
    (reading from the dropped socket crashed the engine thread, the rare
    red of the conn-kill case above)."""
    import selectors

    from starway_tpu_torch.core.engine import Worker

    class SuspendedOnWrite:
        alive = True

        def __init__(self):
            self.sock, self.reads = object(), 0

        def on_writable(self, fires):
            self.sock = None  # _conn_broken -> suspend() of a session

        def on_readable(self, fires):
            self.reads += 1
            self.sock.recv_into(bytearray(1))

    conn = SuspendedOnWrite()
    Worker._on_conn_io(None, conn, selectors.EVENT_READ
                       | selectors.EVENT_WRITE, [])
    assert conn.sock is None and conn.reads == 0
    # A readiness left in the selector's batch after the conn lost its
    # socket earlier in that batch is not acted on either.
    Worker._on_conn_io(None, conn, selectors.EVENT_READ, [])
    assert conn.reads == 0


# ----------------------------------------- observability + wire parity


async def test_counters_and_gauges_surface(port, monkeypatch):
    """reshard_bytes/reshard_rounds ride the shared counter vocabulary and
    the staging gauge rides gauges_snapshot."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    from starway_tpu_torch.core import swtrace

    before_b = swtrace.GLOBAL.reshard_bytes
    before_r = swtrace.GLOBAL.reshard_rounds
    src_sh, dst_sh = _two_rank_shardings()
    shape = (8, 512)
    st = ShardedTensor.from_tensor(
        torch.arange(8 * 512, dtype=torch.float32).reshape(shape), src_sh)
    server = Server()
    server.listen(ADDR, port)
    client = Client()
    try:
        await _connect(client, server, port)
        with lease() as L:
            await asyncio.gather(
                redistribute(st, None, {1: client}, rank=0, lease=L),
                redistribute(ArrayRef(shape, torch.float32), dst_sh,
                             {0: ServerPort(server)}, rank=1, lease=L))
        assert swtrace.GLOBAL.reshard_bytes > before_b
        assert swtrace.GLOBAL.reshard_rounds > before_r
        snap = client._client.counters_snapshot()
        assert snap["reshard_bytes"] == swtrace.GLOBAL.reshard_bytes
        gauges = client._client.gauges_snapshot()
        assert gauges["reshard_staging_peak"] >= 0
        assert gauges["reshard_staging_bytes"] == 0
    finally:
        try:
            await asyncio.wait_for(client.aclose(), 15)
        finally:
            await asyncio.wait_for(server.aclose(), 15)


async def _capture_hello(port):
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((ADDR, port))
    listener.listen(4)
    client = Client()
    try:
        fut = client.aconnect(ADDR, port)
        conn, _ = listener.accept()
        conn.settimeout(10)
        hdr = b""
        while len(hdr) < frames.HEADER_SIZE:
            hdr += conn.recv(frames.HEADER_SIZE - len(hdr))
        ftype, _a, blen = frames.unpack_header(hdr)
        assert ftype == frames.T_HELLO
        body = b""
        while len(body) < blen:
            body += conn.recv(blen - len(body))
        conn.sendall(frames.pack_hello_ack("seedpeer"))
        await asyncio.wait_for(fut, 30)
        conn.close()
        return json.loads(body.decode())
    finally:
        listener.close()
        try:
            await asyncio.wait_for(client.aclose(), 10)
        except Exception:
            pass


async def test_hello_parity_reshard_is_not_a_wire_feature(port, port2,
                                                          monkeypatch):
    """Reshard rides the existing wire: the HELLO a client offers is the
    same (but for its worker id) before and after a schedule ran."""
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "0")
    before = await _capture_hello(port)
    mesh = _slot_mesh((8,), ("x",))
    await redistribute(
        ShardedTensor.from_tensor(
            torch.arange(64, dtype=torch.float32).reshape(8, 8),
            SlotSharding(mesh, ("x",))),
        SlotSharding(mesh, (None, "x")))
    after = await _capture_hello(port2)
    scrub = lambda h: {k: v for k, v in h.items()
                       if k not in ("worker_id", "name")}
    assert scrub(before) == scrub(after)


# -------------------------------------------- across the two packages


class _JaxServerPort:
    def __init__(self, server):
        self._s = server
        self._ep = next(iter(server.list_clients()))

    def asend(self, buf, tag):
        return self._s.asend(self._ep, buf, tag)

    def arecv(self, buf, tag, mask=MASK):
        return self._s.arecv(buf, tag, mask)

    def aflush(self):
        return self._s.aflush_ep(self._ep)


@pytest.mark.parametrize("engine", ["python", "native"])
@pytest.mark.parametrize("sender", ["jax", "port"])
async def test_mixed_package_redistribute(port, monkeypatch, engine,
                                          sender):
    """A JAX rank and a port rank redistribute one bf16 array over tcp
    (via='host'): the spec exchange's JSON and the schedule's tags are the
    same bytes in both packages, so the receiver's shards equal the
    sender's boxes exactly, whichever package sends."""
    if engine == "native":
        from starway_tpu.core import native as jax_native

        _need_native("native")
        if not jax_native.available():
            pytest.skip("native engine unavailable (no toolchain)")
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if engine == "native" else "0")
    shape = (16, 256)
    bits = np.random.default_rng(13).integers(0, 1 << 16, shape,
                                              dtype=np.uint16)
    jx = jnp.asarray(bits).view(jnp.bfloat16)
    tx = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    j_src, j_dst = _jax_two_rank_shardings()
    p_src, p_dst = _two_rank_shardings()
    split = lambda d: 0 if d.id < 4 else 1
    # The JAX rank serves, the port rank connects.
    server = starway_tpu.Server()
    server.listen(ADDR, port)
    client = starway_tpu_torch.Client()
    try:
        await asyncio.wait_for(client.aconnect(ADDR, port), 30)
        for _ in range(400):
            if server.list_clients():
                break
            await asyncio.sleep(0.005)
        jport = _JaxServerPort(server)
        if sender == "jax":
            jres, pres = await asyncio.gather(
                jax_reshard.redistribute(
                    jax.device_put(jx, j_src), None, {1: client}, rank=0,
                    rank_of=split, lease_slot=6),
                redistribute(ArrayRef(shape, torch.bfloat16), p_dst,
                             {0: jport}, rank=1, lease_slot=6))
            assert pres.stats["rx_bytes"] == jres.stats["tx_bytes"] > 0
            _assert_shards(pres, p_dst, bits)
        else:
            pres, jres = await asyncio.gather(
                redistribute(ShardedTensor.from_tensor(tx, p_src), None,
                             {1: client}, rank=0, lease_slot=6),
                jax_reshard.redistribute(
                    jax_reshard.ArrayRef(shape, jnp.bfloat16), j_dst,
                    {0: jport}, rank=1, rank_of=split, lease_slot=6))
            assert jres.stats["rx_bytes"] == pres.stats["tx_bytes"] > 0
            got = np.asarray(jres.array).view(np.uint16)
            assert got.tobytes() == bits.tobytes()
    finally:
        try:
            await asyncio.wait_for(client.aclose(), 15)
        finally:
            await asyncio.wait_for(server.aclose(), 15)
