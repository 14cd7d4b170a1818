"""Serving over the transport on the port (models/remote_serving.py), the
twin of tests/test_serve_remote.py: requests arrive as tagged messages on
a port ``Server``, the port's ``SlotServer`` admits them, tokens stream
back per request -- and every greedy stream equals the JAX package's
``generate()`` token for token, on the same numpy weights
(``params_from_numpy``).

Matrix: the in-process fast path, real TCP sockets and the port's build of
the C++ engine, plus serving and client processes across a real process
boundary (they import only the port).  Beyond the twins: a JAX client
against a port server and a port client against a JAX server on one wire,
and the nonce, which the port masks to 32 bits where the JAX package
reflects the signed word (a nonce above the int32 range round-trips; one
wider than 32 bits is refused by the client at once, and the session keeps
serving).
"""

import asyncio
import functools
import multiprocessing as mp

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models.generate import generate as jax_generate
from starway_tpu_torch.models import LlamaConfig, SlotServer
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.remote_serving import (
    _ID_MASK, FULL_MASK, TAG_REQUEST, TAG_TOKENS, RemoteGenerateSession,
    RemoteSlotServer, _recv_buf, _wire)
from torch_port_util import serve_remote_child, tree_to_numpy

pytestmark = pytest.mark.asyncio

ADDR = "127.0.0.1"


@pytest.fixture(params=["inproc", "tcp", "native"])
def transport(request, monkeypatch):
    if request.param == "inproc":
        monkeypatch.delenv("STARWAY_TLS", raising=False)
        monkeypatch.delenv("STARWAY_NATIVE", raising=False)
    elif request.param == "tcp":
        monkeypatch.setenv("STARWAY_TLS", "tcp")
        monkeypatch.setenv("STARWAY_NATIVE", "0")
    else:
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
        monkeypatch.setenv("STARWAY_TLS", "tcp")
        monkeypatch.setenv("STARWAY_NATIVE", "1")
    return request.param


@functools.lru_cache(maxsize=None)
def _jax_model():
    jcfg = JaxConfig.preset("debug")
    return jcfg, jax_init_params(jax.random.PRNGKey(0), jcfg)


@functools.lru_cache(maxsize=None)
def _numpy_params():
    return tree_to_numpy(_jax_model()[1])


@pytest.fixture(scope="module")
def cfg():
    return LlamaConfig.preset("debug")


@pytest.fixture(scope="module")
def params():
    return params_from_numpy(_numpy_params(), device="cpu")


@functools.lru_cache(maxsize=None)
def _oracle_cached(prompt: tuple, max_new: int) -> tuple:
    jcfg, jparams = _jax_model()
    out = jax_generate(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                       max_new)
    return tuple(int(t) for t in np.asarray(out[0, len(prompt):]))


def _oracle(prompt, max_new) -> np.ndarray:
    """The JAX package's greedy generate() on the same weights."""
    return np.asarray(_oracle_cached(tuple(int(t) for t in prompt),
                                     int(max_new)), np.int32)


async def _bridge(params, cfg, port, **kw):
    slot_kw = dict(n_slots=1, max_len=64, chunk=4)
    slot_kw.update({k: kw.pop(k) for k in list(kw) if k in slot_kw})
    bridge = RemoteSlotServer(SlotServer(params, cfg, **slot_kw), **kw)
    bridge.server.listen(ADDR, port)
    return bridge, asyncio.create_task(bridge.serve())


async def _shutdown(bridge, serve_task, *sessions):
    bridge.stop()
    await serve_task
    for s in sessions:
        await s.aclose()
    await bridge.aclose()


async def _serve_and_query(cfg, params, reqs, port, n_sessions=1):
    bridge, serve_task = await _bridge(params, cfg, port, n_slots=2)
    sessions = [await RemoteGenerateSession.aconnect(ADDR, port)
                for _ in range(n_sessions)]
    try:
        return await asyncio.gather(*(
            sessions[i % n_sessions].generate(p, m)
            for i, (p, m) in enumerate(reqs)))
    finally:
        await _shutdown(bridge, serve_task, *sessions)


async def test_remote_matches_generate(cfg, params, transport, port):
    """More requests than slots through one remote session: every greedy
    continuation equals the JAX package's generate()."""
    rng = np.random.default_rng(1)
    reqs = [(list(rng.integers(1, cfg.vocab_size, n)), m)
            for n, m in [(3, 6), (7, 4), (12, 9), (5, 1), (2, 11)]]
    outs = await _serve_and_query(cfg, params, reqs, port)
    for (prompt, max_new), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _oracle(prompt, max_new))


async def test_remote_concurrent_sessions(cfg, params, transport, port):
    """Three sessions interleaving requests on one bridge: tag routing
    keeps every stream on its own request."""
    rng = np.random.default_rng(2)
    reqs = [(list(rng.integers(1, cfg.vocab_size, n)), m)
            for n, m in [(4, 5), (9, 7), (2, 3), (6, 8), (3, 4), (8, 2)]]
    outs = await _serve_and_query(cfg, params, reqs, port, n_sessions=3)
    for (prompt, max_new), got in zip(reqs, outs):
        np.testing.assert_array_equal(got, _oracle(prompt, max_new))


async def test_remote_streaming_chunks(cfg, params, transport, port):
    """The per-chunk callback sees the same tokens, in order, as the final
    result, in more than one message."""
    bridge, serve_task = await _bridge(params, cfg, port, chunk=3)
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    try:
        seen: list = []
        chunks: list = []
        out = await session.generate(
            [4, 2, 8, 1], 10, on_tokens=lambda c: (seen.extend(c),
                                                   chunks.append(c)))
        assert seen == list(out) and len(out) == 10 and len(chunks) > 1
        np.testing.assert_array_equal(out, _oracle([4, 2, 8, 1], 10))
    finally:
        await _shutdown(bridge, serve_task, session)


async def test_remote_rejects_oversized(cfg, params, transport, port):
    """A request past the server's max_len comes back as a rejection and
    the serve loop keeps working."""
    bridge, serve_task = await _bridge(params, cfg, port, max_len=32)
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    try:
        with pytest.raises(ValueError, match="rejected"):
            await session.generate(list(range(1, 20)), 100)
        out = await session.generate([4, 2, 8], 5)
        np.testing.assert_array_equal(out, _oracle([4, 2, 8], 5))
    finally:
        await _shutdown(bridge, serve_task, session)


async def test_remote_client_rejects_oversized_prompt_locally(cfg, params,
                                                              port):
    """ASSIGN carries the server's request-size limit; generate() raises
    client-side instead of sending an unanswerable truncated request."""
    bridge, serve_task = await _bridge(params, cfg, port,
                                       max_prompt_tokens=16)
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    try:
        assert session.server_max_prompt == 16
        with pytest.raises(ValueError, match="request limit"):
            await session.generate(list(range(1, 30)), 4)
    finally:
        await _shutdown(bridge, serve_task, session)


async def test_remote_intake_survives_truncated_request(cfg, params, port):
    """An oversized raw request truncates the server's wildcard recv; the
    bridge re-posts and keeps serving."""
    bridge, serve_task = await _bridge(params, cfg, port,
                                       max_prompt_tokens=16)
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    try:
        big = np.concatenate([np.asarray([0, 4, 64], np.int32),
                              np.ones(64, np.int32)])
        await session.client.asend(_wire(big),
                                   TAG_REQUEST | session.client_id)
        await asyncio.sleep(0.2)
        out = await session.generate([4, 2, 8], 5)
        np.testing.assert_array_equal(out, _oracle([4, 2, 8], 5))
    finally:
        await _shutdown(bridge, serve_task, session)


async def _await_stream(session, nonce, n_words=8):
    buf = _recv_buf(n_words)
    await session.client.arecv(buf, TAG_TOKENS | nonce, FULL_MASK)
    return buf.view(np.int32)


async def test_remote_malformed_request_is_rejected(cfg, params, port):
    """A length-inconsistent request gets a fatal empty stream back and
    service continues."""
    bridge, serve_task = await _bridge(params, cfg, port)
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    try:
        nonce = 7777
        bad = np.asarray([nonce, 4, 99, 1, 2, 3], np.int32)  # n=99, 3 sent
        await session.client.asend(_wire(bad),
                                   TAG_REQUEST | session.client_id)
        words = await _await_stream(session, nonce)
        assert int(words[1]) == 2 and int(words[2]) == 0  # aborted, empty
        out = await session.generate([9, 1], 4)
        np.testing.assert_array_equal(out, _oracle([9, 1], 4))
    finally:
        await _shutdown(bridge, serve_task, session)


def test_remote_multiprocess(cfg, port, tmp_path):
    """One serving process, two concurrent client processes over real TCP,
    each importing only the port: every stream matches its oracle
    computed in this process by the JAX package."""
    np.savez(tmp_path / "params.npz", **_flat(_numpy_params()))
    ctx = mp.get_context("spawn")
    ready, stop = ctx.Event(), ctx.Event()
    srv = ctx.Process(target=serve_remote_child,
                      args=("server", port, str(tmp_path), ready, stop, None))
    srv.start()
    try:
        assert ready.wait(120), "serving process never came up"
        rng = np.random.default_rng(3)
        all_reqs = [[(list(map(int, rng.integers(1, cfg.vocab_size, n))), m)
                     for n, m in [(3, 6), (8, 4)]]
                    for _ in range(2)]
        qs, clients = [], []
        for reqs in all_reqs:
            q = ctx.Queue()
            c = ctx.Process(target=serve_remote_child,
                            args=("client", port, reqs, None, None, q))
            c.start()
            qs.append(q)
            clients.append(c)
        results = [q.get(timeout=300) for q in qs]
        for c in clients:
            c.join(timeout=60)
    finally:
        stop.set()
        srv.join(timeout=60)
        if srv.is_alive():
            srv.terminate()
    for reqs, outs in zip(all_reqs, results):
        assert not isinstance(outs, str), outs
        for (prompt, max_new), got in zip(reqs, outs):
            np.testing.assert_array_equal(np.asarray(got, np.int32),
                                          _oracle(prompt, max_new))


def _flat(tree, prefix=""):
    """A nested dict of arrays as one level, keys joined by '/'."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


async def test_remote_cancel_frees_slot_and_aborts_stream(cfg, params,
                                                          port):
    """Client-initiated CANCEL: the awaiting generate() raises, the slot
    frees for waiting work, and later requests still match their oracle."""
    bridge, serve_task = await _bridge(params, cfg, port, chunk=2)
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    try:
        handle = RemoteGenerateSession.Handle()
        first_chunk = asyncio.Event()

        async def doomed():
            with pytest.raises(ValueError, match="rejected or cancelled"):
                await session.generate(
                    [4, 2, 8, 1], 40, handle=handle,
                    on_tokens=lambda c: first_chunk.set())

        task = asyncio.create_task(doomed())
        await asyncio.wait_for(first_chunk.wait(), 120)
        await session.cancel(handle)
        await asyncio.wait_for(task, 120)
        out = await asyncio.wait_for(session.generate([9, 1, 5], 6), 120)
        np.testing.assert_array_equal(out, _oracle([9, 1, 5], 6))
    finally:
        await _shutdown(bridge, serve_task, session)


async def test_remote_cancel_overtaking_request(cfg, params, port):
    """A CANCEL drained before its REQUEST still aborts the request: the
    stash rejects it at submit time."""
    bridge, serve_task = await _bridge(params, cfg, port)
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    bridge.stop()
    await serve_task
    bridge._stopping = False  # re-arm (white-box: serve() is re-entrant)
    try:
        nonce = 0
        bridge._requests.append((session.client_id, np.asarray(
            [nonce, 30, 4, 4, 2, 8, 1], np.int32)))
        bridge._cancels.append((session.client_id, nonce))
        session._nonce = 1  # nonce 0 is taken by the hand-crafted request
        task = asyncio.create_task(_await_stream(session, nonce))
        serve_task = asyncio.create_task(bridge.serve())
        words = await asyncio.wait_for(task, 120)
        assert int(words[1]) == 2  # aborted, never decoded
        out = await asyncio.wait_for(session.generate([9, 1, 5], 6), 120)
        np.testing.assert_array_equal(out, _oracle([9, 1, 5], 6))
    finally:
        await _shutdown(bridge, serve_task, session)


# ----------------------------------------------------------------- nonce


async def test_remote_nonce_is_32_bits(cfg, params, transport, port):
    """The nonce is an unsigned 32-bit word.  Nonces above the int32 range
    round-trip -- a stream, a raw request whose word is negative, and a
    cancel -- because the server masks what it parses; a nonce wider than
    32 bits is refused by the client at once (no request is sent, nothing
    hangs) and the session keeps serving."""
    bridge, serve_task = await _bridge(params, cfg, port, chunk=2)
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    try:
        session._nonce = _ID_MASK - 15
        out = await asyncio.wait_for(session.generate([4, 2, 8], 5), 120)
        np.testing.assert_array_equal(out, _oracle([4, 2, 8], 5))
        assert session._nonce == _ID_MASK - 14
        # A raw request with the word -1: its stream is tagged _ID_MASK.
        raw = np.asarray([-1, 3, 2, 9, 1], np.int32)
        await session.client.asend(_wire(raw),
                                   TAG_REQUEST | session.client_id)
        got: list = []
        while True:
            words = await asyncio.wait_for(
                _await_stream(session, _ID_MASK), 120)
            assert int(words[0]) == -1
            got += [int(t) for t in words[3:3 + int(words[2])]]
            if int(words[1]) != 0:
                assert int(words[1]) == 1
                break
        np.testing.assert_array_equal(got, _oracle([9, 1], 3))
        # A cancel of a stream above the int32 range reaches its request.
        session._nonce = _ID_MASK - 1
        handle = RemoteGenerateSession.Handle()
        first = asyncio.Event()

        async def doomed():
            with pytest.raises(ValueError, match="rejected or cancelled"):
                await session.generate([4, 2], 40, handle=handle,
                                       on_tokens=lambda c: first.set())

        task = asyncio.create_task(doomed())
        await asyncio.wait_for(first.wait(), 120)
        assert handle.nonce == _ID_MASK - 1
        await session.cancel(handle)
        await asyncio.wait_for(task, 120)
        # Wider than 32 bits: refused before anything is sent.
        session._nonce = _ID_MASK + 1
        with pytest.raises(ValueError, match="does not fit 32 bits"):
            await asyncio.wait_for(session.generate([4, 2, 8], 5), 5)
        with pytest.raises(ValueError, match="does not fit 32 bits"):
            wide = RemoteGenerateSession.Handle()
            wide.nonce = (_ID_MASK + 1) * 256 + 3
            await session.cancel(wide)
        session._nonce = 5
        out = await asyncio.wait_for(session.generate([9, 1, 5], 6), 120)
        np.testing.assert_array_equal(out, _oracle([9, 1, 5], 6))
    finally:
        await _shutdown(bridge, serve_task, session)


# -------------------------------------------------------- across packages


@pytest.mark.parametrize("engine", ["py", "native"])
async def test_jax_client_against_port_server(cfg, params, port, monkeypatch,
                                              engine):
    """The JAX package's RemoteGenerateSession against the port's
    RemoteSlotServer over tcp: one wire protocol, greedy tokens equal to
    the JAX generate()."""
    from starway_tpu.models.remote_serving import \
        RemoteGenerateSession as JaxSession

    _mixed_env(monkeypatch, engine)
    bridge, serve_task = await _bridge(params, cfg, port, n_slots=2)
    session = await JaxSession.aconnect(ADDR, port)
    try:
        reqs = [([4, 2, 8, 1], 7), ([9, 1], 5), ([3, 3, 3, 7, 5], 9)]
        outs = await asyncio.wait_for(asyncio.gather(
            *(session.generate(p, m) for p, m in reqs)), 300)
        for (prompt, max_new), got in zip(reqs, outs):
            np.testing.assert_array_equal(got, _oracle(prompt, max_new))
    finally:
        await _shutdown(bridge, serve_task, session)


@pytest.mark.parametrize("engine", ["py", "native"])
async def test_port_client_against_jax_server(port, monkeypatch, engine):
    """The port's RemoteGenerateSession against the JAX package's
    RemoteSlotServer over its SlotServer: the streams equal the JAX
    generate()."""
    from starway_tpu.models import SlotServer as JaxSlotServer
    from starway_tpu.models.remote_serving import \
        RemoteSlotServer as JaxBridge

    _mixed_env(monkeypatch, engine)
    jcfg, jparams = _jax_model()
    bridge = JaxBridge(JaxSlotServer(jparams, jcfg, n_slots=2, max_len=64,
                                     chunk=4))
    bridge.server.listen(ADDR, port)
    serve_task = asyncio.create_task(bridge.serve())
    session = await RemoteGenerateSession.aconnect(ADDR, port)
    try:
        reqs = [([4, 2, 8, 1], 7), ([9, 1], 5), ([3, 3, 3, 7, 5], 9)]
        outs = await asyncio.wait_for(asyncio.gather(
            *(session.generate(p, m) for p, m in reqs)), 300)
        for (prompt, max_new), got in zip(reqs, outs):
            np.testing.assert_array_equal(got, _oracle(prompt, max_new))
    finally:
        await _shutdown(bridge, serve_task, session)


def _mixed_env(monkeypatch, engine):
    if engine == "native":
        from starway_tpu.core import native as jax_native
        from starway_tpu_torch.core import native as port_native

        if not (jax_native.available() and port_native.available()):
            pytest.skip("native engine unavailable (no toolchain)")
    monkeypatch.setenv("STARWAY_TLS", "tcp")
    monkeypatch.setenv("STARWAY_NATIVE", "1" if engine == "native" else "0")
