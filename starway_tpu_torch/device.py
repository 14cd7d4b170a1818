"""Device data plane: torch.Tensor payloads over the fabric.

Every ``torch.Tensor``, on any device, and every :class:`DeviceBuffer` is a
device payload.  The tag matcher stays byte-oriented; device awareness
enters through the same two duck-typed protocols as in the JAX package
(no torch import in the core):

* :class:`DevicePayload` -- wraps a tensor for sending (``nbytes``,
  ``as_host_view()``, ``chunked()``/``host_chunk()``, ``.array``).
* :class:`DeviceRecvSink` -- wraps a :class:`DeviceBuffer` for receiving
  (``nbytes``, ``host_staging()``, ``staged()``, ``finalize_from_host()``,
  ``accept_host()``, ``accept_device()``).

Four transfer paths, chosen per connection and payload:

* **in-process, device payload -> device sink**: the sender's tensor is
  snapshotted on the card and the receiver copies the snapshot into its
  sink's tensor (a peer copy between cards) -- no host staging.
* **in-process, mixed host/device**: one copy at the boundary.
* **pulled (tcp, sm; Python engine)**: when both peers negotiated the
  pull (the ``cudaipc`` HELLO key), a small descriptor rides the stream
  and the receiver copies the sender's snapshot straight from its card
  (CUDA IPC; a process-wide table when both workers share the process):
  no host staging.  See "cross-process pull" below.
* **staged (tcp, sm)**: otherwise the payload is staged to pinned host
  memory chunk by chunk, streamed, and placed chunk by chunk into the
  sink's tensor on the receiver's card (DESIGN.md §12).

A ``jax.Array`` is immutable; a tensor is mutable and ordered by streams.
So this plane differs from the JAX package's in five rules:

* **In place.**  :class:`DeviceBuffer` preallocates its tensor and every
  receive writes into it: ``data_ptr()`` never changes.  A receive shorter
  than the buffer fills the first ``length`` bytes of the tensor's flat
  ``uint8`` view and leaves the rest alone.  (The JAX package swaps a new
  array into ``.array`` instead.)
* **Stream order.**  Every copy runs on a side stream, one per card and
  direction, which first waits on an event recorded on the caller's
  current stream when the send or the receive was posted: a kernel the
  caller queued just before ``asend`` has written the payload before it is
  read, and one queued before ``arecv`` has read the sink before it is
  overwritten.  Tensors that cross streams get ``record_stream``.
* **Snapshot.**  An in-process or pulled device send delivers a clone
  made on the card at send time, and completes once the clone is
  resident; the matcher may park the message before a receive claims it,
  so the caller may overwrite its tensor as soon as the send completes.
* **Completion means resident.**  A receive completes only after the
  event of its last copy has completed.
* **Pinned staging.**  Staging for a card is pinned host memory and goes
  back to the pool only once the copies reading it have completed.

Every copy runs where its tensors are: nothing here carries a transfer on
through the CPU when a card is missing or a copy fails.  A chunked
placement that fails falls back to one full-buffer copy on the same card,
with a warning logged.
"""

from __future__ import annotations

import base64
import itertools
import logging
import mmap
import os
import queue
import socket
import threading
import time
from typing import Optional

import torch

logger = logging.getLogger("starway_tpu_torch")


def _record_stage(name: str, seconds: float, nbytes: int, scope=None) -> None:
    from . import perf

    perf.record_stage(name, seconds, nbytes, scope)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or scalar type
    (``jnp.bfloat16`` and the other ml_dtypes included) or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np

    try:
        name = np.dtype(dtype).name
    except TypeError:  # a name numpy does not know, such as "bfloat16"
        name = str(dtype)
    found = getattr(torch, name, None)
    if not isinstance(found, torch.dtype):
        raise TypeError(f"no torch dtype for {dtype!r}")
    return found


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """The flat ``uint8`` view of a contiguous tensor of any dtype."""
    return t.reshape(-1).view(torch.uint8)


def _host_bytes(view, length: int) -> torch.Tensor:
    """The first ``length`` bytes of a host buffer as a CPU tensor aliasing
    it (a copy when the buffer is read-only, which torch cannot alias)."""
    if length == 0:
        return torch.empty(0, dtype=torch.uint8)
    mv = memoryview(view).cast("B")[:length]
    if mv.readonly:
        mv = memoryview(bytearray(mv))
    return torch.frombuffer(mv, dtype=torch.uint8)


# ----------------------------------------------------------- side streams

_streams: dict = {}
_streams_lock = threading.Lock()


def _side_stream(device: torch.device, role: str):
    """The side stream for ``role`` ("tx": device to host, "rx": into a
    sink) on ``device``, created on first use."""
    key = (device.index, role)
    with _streams_lock:
        stream = _streams.get(key)
        if stream is None:
            stream = _streams[key] = torch.cuda.Stream(device=device)
        return stream


def _posted_event(t: torch.Tensor):
    """An event on the caller's current stream of ``t``'s card: the point
    in the caller's work at which a transfer of ``t`` was posted.  None on
    the CPU, where there is no stream to order against."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _copy(dst: torch.Tensor, src: torch.Tensor, role: str, after=None):
    """``dst.copy_(src)``.  With a card on either side: queued on the
    ``role`` side stream of that card (the destination's when both are
    cards) after the event ``after``; returns the copy's event.  Between
    CPU tensors: done at once; returns None."""
    dev = dst.device if dst.device.type == "cuda" else src.device
    if dev.type != "cuda":
        dst.copy_(src)
        return None
    stream = _side_stream(dev, role)
    if after is not None:
        stream.wait_event(after)
    with torch.cuda.stream(stream):
        dst.copy_(src, non_blocking=True)
    for t in (dst, src):
        if t.device == dev:  # another card's tensor: copy_ syncs with it
            t.record_stream(stream)
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


# ------------------------------------------------------- staging buffer pool
#
# Host staging buffers for streamed (tcp/sm) receives are reused across
# transfers: first-touch page faults on a fresh multi-MiB buffer, and a
# fresh pinned allocation even more, cost more than the copy they serve.
# Exact-size buckets, bounded total bytes.  A buffer whose copies to the
# card are still in flight waits beside the pool with its event and joins
# a bucket only once the event has completed.


class _StagingPool:
    def __init__(self, cap_bytes: int = 64 << 20):
        self._lock = threading.Lock()
        self._buckets: dict[tuple, list] = {}  # (nbytes, pinned) -> buffers
        self._inflight: list = []  # (buffer, event): copies still read it
        self._held = 0
        self._cap = cap_bytes
        self.hits = 0
        self.misses = 0

    def get(self, nbytes: int, pinned: bool = False) -> torch.Tensor:
        from .core import swtrace

        with self._lock:
            self._reap()
            bucket = self._buckets.get((nbytes, pinned))
            if bucket:
                self._held -= nbytes
                self.hits += 1
                swtrace.GLOBAL.staging_hits += 1
                return bucket.pop()
            self.misses += 1
            swtrace.GLOBAL.staging_misses += 1
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)

    def put(self, buf: torch.Tensor, event=None) -> None:
        """Return ``buf`` to the pool; with ``event`` (of the last copy
        reading it), only once that event has completed."""
        with self._lock:
            if event is not None and not event.query():
                self._inflight.append((buf, event))
                return
            self._add(buf)

    @property
    def inflight(self) -> int:
        """Buffers waiting for their copies before they can be reused."""
        with self._lock:
            return len(self._inflight)

    def _reap(self) -> None:
        waiting = []
        for buf, event in self._inflight:
            if event.query():
                self._add(buf)
            else:
                waiting.append((buf, event))
        self._inflight = waiting

    def _add(self, buf: torch.Tensor) -> None:
        n = buf.numel()
        if self._held + n > self._cap:
            return  # dropped: the pool stays bounded
        self._buckets.setdefault((n, buf.is_pinned()), []).append(buf)
        self._held += n


_staging_pool = _StagingPool()


def _rx_overlap_ok(device) -> bool:
    """Chunked receive placement (a copy to the card per completed chunk)
    only pays where the copy overlaps the remaining stream reads: on a
    card.  Module-level so tests can force the path on CPU tensors."""
    return device is not None and device.type == "cuda"


def is_device_payload(buffer) -> bool:
    return isinstance(buffer, (DeviceBuffer, torch.Tensor))


def _target_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("DeviceBuffer: no CUDA device is available; "
                               "pass device='cpu' for a tensor in host "
                               "memory")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceBuffer:
    """A receive target in device memory, written in place.

    The tensor is allocated once (or given as ``array``, contiguous) and
    every receive writes into it; ``array.data_ptr()`` never changes.  A
    receive of ``length`` bytes fills the first ``length`` bytes of the
    tensor's flat ``uint8`` view.  ``device=None`` means the current CUDA
    device, and raises where there is none.

    >>> sink = DeviceBuffer((1024,), torch.bfloat16, device="cuda:1")
    >>> tag, length = await server.arecv(sink, tag=7, tag_mask=MASK)
    >>> sink.array  # the received payload, resident on cuda:1
    """

    def __init__(self, shape, dtype, device=None, array=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _torch_dtype(dtype)
        if array is None:
            array = torch.empty(self.shape, dtype=self.dtype,
                                device=_target_device(device))
        elif (tuple(array.shape) != self.shape or array.dtype != self.dtype
              or not array.is_contiguous()):
            raise ValueError(f"array {tuple(array.shape)} {array.dtype} does "
                             f"not match a contiguous {self.shape} "
                             f"{self.dtype}")
        self.array = array
        self.device = array.device
        # How the last receive landed: "device" (in-process copy on the
        # card) or "staged" (bytes streamed through host staging).
        self.last_transport = None

    @classmethod
    def like(cls, array, device=None) -> "DeviceBuffer":
        """A sink shaped like ``array``, on ``device`` (default: the device
        ``array`` lives on)."""
        return cls(array.shape, array.dtype,
                   device=array.device if device is None else device)

    @property
    def nbytes(self) -> int:
        return self.array.numel() * self.array.element_size()


class DevicePayload:
    """Send-side wrapper: a tensor, read through its flat ``uint8`` view.

    Two staging modes feed the framed stream:

    * ``as_host_view()`` -- one full-payload copy to host memory (the
      in-process path to a host receive, and the fallback for engines
      without chunked TX support).
    * ``chunked(chunk_bytes)`` + ``host_chunk(pos)`` -- incremental copies
      to host memory: the TX pump asks for the chunk containing byte
      ``pos`` and the payload starts the copy of the NEXT chunk before
      returning, so staging chunk k+1 overlaps the transport write of
      chunk k (DESIGN.md §12).

    Every copy of a card's tensor runs on its card's "tx" side stream after
    the event recorded at construction, i.e. after the work the caller had
    queued on its current stream when it sent.
    """

    __slots__ = ("array", "nbytes", "scope", "_posted", "_host_view",
                 "_chunk_b", "_pending", "_host_chunks")

    def __init__(self, array: torch.Tensor):
        if not array.is_contiguous():
            array = array.contiguous()  # queued on the caller's stream
        self.array = _flat_bytes(array)
        self.nbytes = self.array.numel()
        self.scope = None  # owning worker's perf.StageScope (send_device)
        self._posted = _posted_event(array)
        self._host_view: Optional[memoryview] = None
        self._chunk_b = 0  # >0 = chunked mode (see chunked())
        self._pending: Optional[dict] = None  # chunk -> (host, event)
        self._host_chunks: Optional[dict] = None  # chunk -> host view

    def snapshot(self) -> "DevicePayload":
        """Replace the tensor by a clone made on its card and wait until
        the clone is resident (in-process sends: send completion then
        licenses the caller to overwrite its tensor)."""
        clone = torch.empty_like(self.array)
        event = _copy(clone, self.array, "tx", self._posted)
        if event is not None:
            event.synchronize()
        self.array, self._posted = clone, None
        return self

    def _to_host(self, off: int, nbytes: int):
        """Start the copy of bytes [off, off + nbytes) into fresh host
        memory (pinned for a card's tensor); returns (host, event)."""
        host = torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=self.array.device.type == "cuda")
        return host, _copy(host, self.array[off:off + nbytes], "tx",
                           self._posted)

    def as_host_view(self) -> memoryview:
        if self._host_view is None:
            t0 = time.perf_counter()
            host, event = self._to_host(0, self.nbytes)
            if event is not None:
                event.synchronize()
            self._host_view = memoryview(host.numpy())
            _record_stage("stage", time.perf_counter() - t0, self.nbytes,
                          self.scope)
        return self._host_view

    # ------------------------------------------------------- chunked D2H
    def chunked(self, chunk_bytes: int) -> Optional["DevicePayload"]:
        """Arm incremental staging, or None when it cannot help (payload
        smaller than two chunks, or pipelining disabled).  Arming starts
        chunk 0's copy so it runs while the header is still being
        written."""
        if chunk_bytes <= 0 or self.nbytes < 2 * chunk_bytes:
            return None
        self._chunk_b = chunk_bytes
        self._pending = {}
        self._host_chunks = {}
        self._prefetch(0)
        return self

    def _prefetch(self, k: int) -> None:
        """Start the copy of chunk ``k``; no-op past the end or when it is
        already started."""
        off = k * self._chunk_b
        if off >= self.nbytes or k in self._pending or k in self._host_chunks:
            return
        self._pending[k] = self._to_host(off, min(self._chunk_b,
                                                  self.nbytes - off))

    def host_chunk(self, pos: int) -> tuple[int, memoryview]:
        """(chunk_start, host_view) for the chunk containing byte ``pos``,
        starting the following chunk's copy before waiting for this one."""
        k = pos // self._chunk_b
        self._prefetch(k)
        self._prefetch(k + 1)
        view = self._host_chunks.get(k)
        if view is None:
            t0 = time.perf_counter()
            host, event = self._pending.pop(k)
            if event is not None:
                event.synchronize()
            view = memoryview(host.numpy())
            _record_stage("stage", time.perf_counter() - t0, len(view),
                          self.scope)
            self._host_chunks[k] = view
            # The pump only moves forward: chunk k-1 is fully on the wire.
            self._host_chunks.pop(k - 1, None)
        return k * self._chunk_b, view


class DeviceRecvSink:
    """Receive-side adapter bridging the byte matcher to a DeviceBuffer.

    Streamed (tcp/sm) payloads land in a pooled host staging buffer; on a
    card the conn's RX pump reports progress via :meth:`staged` and every
    completed chunk is copied into its slice of the sink's tensor while
    later chunks are still on the wire; :meth:`finalize_from_host` copies
    the rest and waits for the last copy (DESIGN.md §12)."""

    __slots__ = ("devbuf", "scope", "_dst", "_posted", "_staging",
                 "_staging_view", "_chunk_b", "_done_b", "_last")

    def __init__(self, devbuf: DeviceBuffer):
        self.devbuf = devbuf
        self.scope = None  # owning worker's perf.StageScope (post_device_recv)
        self._dst = _flat_bytes(devbuf.array)
        self._posted = _posted_event(devbuf.array)
        self._staging: Optional[torch.Tensor] = None
        self._staging_view: Optional[memoryview] = None
        self._chunk_b = 0  # >0 = chunked placement armed
        self._done_b = 0  # bytes whose copy into the tensor is queued
        self._last = None  # event of the last copy queued on the card

    @property
    def nbytes(self) -> int:
        return self.devbuf.nbytes

    def host_staging(self) -> memoryview:
        """Host bounce buffer for streamed payloads (pooled; pinned for a
        card)."""
        if self._staging_view is None:
            from . import config

            device = self.devbuf.device
            self._staging = _staging_pool.get(self.nbytes,
                                              pinned=device.type == "cuda")
            self._staging_view = memoryview(self._staging.numpy())
            chunk = config.chunk_bytes()
            if (chunk > 0 and self.nbytes >= 2 * chunk
                    and _rx_overlap_ok(device)):
                self._chunk_b = chunk
        return self._staging_view

    def staged(self, received: int) -> None:
        """RX progress hook (engine thread): copy every fully-arrived chunk
        into the tensor.  No-op unless chunked placement is armed.

        Chunked placement is purely an overlap optimisation -- the staging
        buffer receives every byte regardless -- so a failure here disarms
        it and the finalize copies the whole payload instead of killing
        the engine thread."""
        if not self._chunk_b:
            return
        try:
            while self._done_b + self._chunk_b <= received:
                self._place_chunk(self._done_b, self._chunk_b)
        except Exception:
            logger.warning("chunked H2D placement failed; falling back to "
                           "full-buffer placement", exc_info=True)
            self._chunk_b = self._done_b = 0

    def _place_chunk(self, off: int, nbytes: int) -> None:
        t0 = time.perf_counter()
        self._last = _copy(self._dst[off:off + nbytes],
                           self._staging[off:off + nbytes], "rx",
                           self._posted)
        self._done_b = off + nbytes
        _record_stage("place", time.perf_counter() - t0, nbytes, self.scope)

    def finalize_from_host(self, length: int) -> None:
        """Staged bytes fully arrived: copy what is not yet placed, wait for
        the copies, recycle the staging buffer."""
        if self._done_b < length:
            try:
                self._place_chunk(self._done_b, length - self._done_b)
            except Exception:
                if not self._done_b:
                    raise
                logger.warning("chunked H2D placement failed; falling back "
                               "to full-buffer placement", exc_info=True)
                self._place_chunk(0, length)
        self.devbuf.last_transport = "staged"
        self._complete()

    def _complete(self) -> None:
        """Receive completion means resident: wait for the last copy.  The
        staging buffer goes back to the pool with that copy's event."""
        event, self._last = self._last, None
        if self._staging is not None:
            _staging_pool.put(self._staging, event)
        self._staging = self._staging_view = None
        self._chunk_b = self._done_b = 0
        if event is not None:
            event.synchronize()

    def accept_host(self, view, length: int) -> None:
        """Complete host bytes already in hand (in-process delivery, or an
        owned unexpected-queue spill): one copy from the source straight
        into the tensor, complete before this returns -- so the source,
        which send completion licenses the sender to reuse, is never
        aliased."""
        t0 = time.perf_counter()
        self._last = _copy(self._dst[:length], _host_bytes(view, length),
                           "rx", self._posted)
        self.devbuf.last_transport = "staged"
        self._complete()
        _record_stage("place", time.perf_counter() - t0, length, self.scope)

    def accept_device(self, array: torch.Tensor) -> None:
        """In-process delivery of a sender's snapshot: a copy on the card
        (a peer copy between cards) into the tensor; never an alias."""
        src = _flat_bytes(array)
        self._last = _copy(self._dst[:src.numel()], src, "rx", self._posted)
        self.devbuf.last_transport = "device"
        self._complete()


# ------------------------------------------------------ cross-process pull
#
# The JAX package pulls a device payload across processes through the PJRT
# transfer server: the sender registers the array for pull, a small
# descriptor rides the framed stream (T_DEVPULL) for tag matching, and the
# receiver pulls the buffer device to device.  Here the sender offers a
# snapshot of its tensor and the receiver copies it into memory it owns,
# on one of two routes chosen per offer from the peer's identity:
#
# * "local" -- the peer is this process (two workers over tcp): the
#   snapshot waits in a process-wide table until the receiver takes it.
#   CUDA IPC cannot open a handle in the process that exported it, and the
#   table serves CPU tensors as well.
# * "ipc" -- the peer is another process on this host and boot, and the
#   tensor is on a card: the snapshot is exported as a CUDA IPC handle
#   (torch.multiprocessing's storage sharing), opened by the receiver, and
#   copied on the receiver's side stream after the export's IPC event.
#
# Anything else (another host, a CPU tensor across processes) is not
# offered: the send rides staged DATA frames.
#
# The capability is negotiated per connection under the port-only HELLO
# key "cudaipc", whose value names the host, the boot and the process.
# "devpull" stays the JAX package's and the C++ engine's key: a peer that
# answered it would exchange descriptors that neither side can pull.

_uids = itertools.count(1)  # offer ids, unique in the process
_local_offers: dict = {}  # uid -> snapshot awaiting a "local" pull
_local_lock = threading.Lock()
_boot_id: Optional[str] = None


def devpull_supported() -> bool:
    """False: this plane never offers nor accepts ``devpull`` (PJRT
    descriptors, which the JAX package and the C++ engine speak); its own
    pull is negotiated under ``cudaipc`` (:func:`cudaipc_identity`)."""
    return False


def cudaipc_identity() -> Optional[str]:
    """This process's value of the ``cudaipc`` HELLO key,
    ``host|boot_id|pid``; None when ``STARWAY_DEVPULL=0`` (nothing is
    offered, device payloads ride staged frames)."""
    global _boot_id
    from . import config

    if not config.devpull_enabled():
        return None
    if _boot_id is None:
        try:
            with open("/proc/sys/kernel/random/boot_id") as f:
                _boot_id = f.read().strip()
        except OSError:
            _boot_id = ""  # no boot id: no IPC route (same pid still works)
    return f"{socket.gethostname()}|{_boot_id}|{os.getpid()}"


def pull_route(peer: Optional[str], tensor: torch.Tensor) -> Optional[str]:
    """The route of an offer of ``tensor`` to the peer whose ``cudaipc``
    value is ``peer``: "local", "ipc" or None (staged frames)."""
    me = cudaipc_identity()
    if not peer or me is None:
        return None
    theirs, mine = peer.rsplit("|", 2), me.rsplit("|", 2)
    if len(theirs) != 3 or theirs[:2] != mine[:2]:
        return None  # another host or another boot
    if theirs[2] == mine[2]:
        return "local"
    return "ipc" if mine[1] and tensor.device.type == "cuda" else None


class _IpcCounter:
    """The int64 reference count torch keeps for one CUDA IPC export, in its
    shared-memory counters file (``/dev/shm/<handle>``, the values after a
    64-byte header), mapped for as long as this object lives.  The
    exporter sets it to 1; the consumer's release of its mapping takes it
    to 0, after which ``torch.cuda.ipc_collect()`` frees the exported
    memory."""

    HEADER = 64

    def __init__(self, handle: bytes, offset: int):
        path = os.path.join("/dev/shm", handle.decode().lstrip("/"))
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        self._at = self.HEADER + 8 * int(offset)

    def get(self) -> int:
        return int.from_bytes(self._mm[self._at:self._at + 8], "little",
                              signed=True)

    def revoke(self) -> None:
        """Count the consumer's reference as released: the export is freed
        at the next ``ipc_collect()``, and a consumer that still opens it
        finds the count below 1 after its copy and fails the pull."""
        self._mm[self._at:self._at + 8] = (0).to_bytes(8, "little")


def _b64(raw) -> str:
    return base64.b64encode(raw or b"").decode()


def _unb64(text: str) -> bytes:
    return base64.b64decode(text.encode())


class TransferManager:
    """Per-worker pull service.

    Owned by a worker and closed with it: unpulled "local" offers leave the
    table and unpulled "ipc" exports are revoked, so their memory is freed
    (the close-cancels-in-flight contract).  Pulls run on one daemon thread
    so the engine thread never blocks on a copy.  ``counts`` tallies the
    offers and the completed pulls of each route."""

    def __init__(self, host: Optional[str] = None):
        # ``host``: the engines pass their advertised host (the JAX
        # package's transfer server binds it); CUDA IPC needs none.
        self._lock = threading.Lock()
        self._offers: dict = {}  # uid -> None ("local") or _IpcCounter
        self._q: "queue.Queue" = queue.Queue()
        self._thread = None
        self._closed = False
        self.counts = {"offered_local": 0, "offered_ipc": 0,
                       "pulled_local": 0, "pulled_ipc": 0}

    # -------------------------------------------------------------- sender
    def offer(self, payload: "DevicePayload", conn, shape=None,
              dtype=None) -> Optional[dict]:
        """Offer ``payload`` to the receiver at the other end of ``conn``:
        snapshot it on its card and return the descriptor, or None when
        no route reaches that peer (the caller stages instead)."""
        route = pull_route(getattr(conn, "cudaipc_peer", None), payload.array)
        if route is None:
            return None
        t0 = time.perf_counter()
        if route == "ipc":
            # Exports the receivers have released go back to the allocator
            # first, so the snapshot can reuse one of their blocks.
            torch.cuda.ipc_collect()
        snap = payload.snapshot().array
        uid = next(_uids)
        desc = {"u": uid, "n": payload.nbytes,
                "s": list(shape if shape is not None else (payload.nbytes,)),
                "d": str(dtype or torch.uint8).removeprefix("torch."),
                "r": route}
        if route == "local":
            with _local_lock:
                _local_offers[uid] = snap
            counter = None
        else:
            (dev, handle, size, off, rc_handle, rc_off, ev_handle,
             ev_sync) = snap.untyped_storage()._share_cuda_()
            counter = _IpcCounter(rc_handle, rc_off)
            if counter.get() != 1:
                raise RuntimeError(
                    f"CUDA IPC export: reference counter reads "
                    f"{counter.get()}, not 1; this torch build's counters "
                    f"file layout is not the one this plane reads")
            desc.update(dev=int(dev), h=_b64(handle), sz=int(size),
                        so=int(off), rh=_b64(rc_handle), ro=int(rc_off),
                        eh=_b64(ev_handle), es=bool(ev_sync))
        with self._lock:
            if self._closed:
                raise RuntimeError("transfer manager closed")
            self._prune()
            self._offers[uid] = counter
            self.counts["offered_" + route] += 1
        _record_stage("offer", time.perf_counter() - t0, payload.nbytes,
                      payload.scope)
        return desc

    def _prune(self) -> None:
        """Forget offers already pulled (under the lock)."""
        with _local_lock:
            done = [uid for uid, c in self._offers.items()
                    if c is None and uid not in _local_offers]
        # The IPC counters are read outside _local_lock: they are shared
        # memory and need none of it.
        done += [uid for uid, c in self._offers.items()
                 if c is not None and c.get() <= 0]
        for uid in done:
            del self._offers[uid]

    # ------------------------------------------------------------ receiver
    def pull(self, desc: dict, device, on_done, on_fail, scope=None) -> None:
        """Pull ``desc`` (onto ``device``; None = where the sender's tensor
        lives), asynchronously: exactly one of the callbacks fires, on the
        manager's thread.  ``scope`` is the receiving worker's
        perf.StageScope (the "pull" stage)."""
        self._submit(lambda: self._do_pull(desc, device, on_done, on_fail,
                                           scope))

    def _do_pull(self, desc: dict, device, on_done, on_fail, scope=None):
        t0 = time.perf_counter()
        try:
            route = desc.get("r")
            if route == "local":
                with _local_lock:
                    arr = _local_offers.pop(int(desc["u"]), None)
                if arr is None:
                    raise RuntimeError("the sender no longer offers this "
                                       "payload (closed)")
            elif route == "ipc":
                arr = self._pull_ipc(desc, device)
            else:
                raise RuntimeError(f"unknown pull route {route!r}")
        except Exception as exc:
            logger.error("cross-process device pull failed: %s", exc)
            on_fail(f"devpull failed: {exc}")
            return
        with self._lock:
            self.counts["pulled_" + route] += 1
        _record_stage("pull", time.perf_counter() - t0, int(desc["n"]), scope)
        on_done(arr)

    @staticmethod
    def _pull_ipc(desc: dict, device) -> torch.Tensor:
        """Open the exported snapshot, copy it into a tensor this process
        owns on its side stream after the export's event, wait for the
        copy, and release the mapping (the sender's count reaches 0)."""
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        n = int(desc["n"])
        src_dev = torch.device("cuda", int(desc["dev"]))
        dst_dev = device if device is not None else src_dev
        counter = _IpcCounter(_unb64(desc["rh"]), int(desc["ro"]))
        stream = _side_stream(dst_dev, "pull")
        with torch.cuda.device(src_dev), torch.cuda.stream(stream):
            src = rebuild_cuda_tensor(
                torch.Tensor, (n,), (1,), 0, torch.UntypedStorage,
                torch.uint8, int(desc["dev"]), _unb64(desc["h"]),
                int(desc["sz"]), int(desc["so"]), False,
                _unb64(desc["rh"]), int(desc["ro"]), _unb64(desc["eh"]),
                bool(desc["es"]))
            dst = torch.empty(n, dtype=torch.uint8, device=dst_dev)
            dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()
        live = counter.get()
        del src
        if live < 1:
            raise RuntimeError("the sender revoked the payload during the "
                               "copy (closed)")
        return dst

    def _submit(self, thunk) -> None:
        # Only the check-and-set needs the lock; the thread starts outside
        # it (thunks queued meanwhile wait in the queue), so nothing is
        # ever called with the manager's lock held.
        with self._lock:
            thread = None
            if self._thread is None:
                thread = self._thread = threading.Thread(
                    target=self._run, name="starway-devpull", daemon=True)
        if thread is not None:
            thread.start()
        self._q.put(thunk)

    def _run(self):
        while True:
            thunk = self._q.get()
            if thunk is None:
                return
            try:
                thunk()
            except Exception:
                logger.exception("devpull completion callback failed")
            # A finished pull's closure reaches its message and, through the
            # posted receive, the caller's sink: drop it before waiting for
            # the next pull, or the sink outlives its receive until then.
            thunk = None

    def close(self) -> None:
        """Unpulled offers die with the worker: "local" ones leave the
        table, "ipc" ones are revoked and collected."""
        with self._lock:
            self._closed = True
            offers, self._offers = self._offers, {}
        with _local_lock:
            for uid, counter in offers.items():
                if counter is None:
                    _local_offers.pop(uid, None)
        ipc = [c for c in offers.values() if c is not None]
        for counter in ipc:
            if counter.get() > 0:
                counter.revoke()
        if ipc:
            torch.cuda.ipc_collect()
        self._q.put(None)


class PulledPayload:
    """Duck-typed payload for a pulled tensor (matcher contract): a flat
    ``uint8`` tensor the receiver owns."""

    __slots__ = ("array", "nbytes", "_host_view")

    def __init__(self, array: torch.Tensor):
        self.array = array
        self.nbytes = array.numel() * array.element_size()
        self._host_view = None

    def as_host_view(self) -> memoryview:
        if self._host_view is None:
            self._host_view = memoryview(
                _flat_bytes(self.array).cpu().numpy()).cast("B")
        return self._host_view


class RemoteMsg:
    """Receiver-side handle for one DEVPULL descriptor.

    Owned by the conn that received it (flush accounting) and referenced by
    the matcher's InboundMsg (``msg.remote``).  ``start(msg)`` is invoked by
    matcher fire thunks -- after the worker lock is released -- once the
    message is claimed by a receive (or force-started by a FLUSH barrier).
    """

    __slots__ = ("desc", "conn", "manager", "started")

    def __init__(self, desc: dict, conn, manager: TransferManager):
        self.desc = desc
        self.conn = conn
        self.manager = manager
        self.started = False

    @property
    def nbytes(self) -> int:
        return int(self.desc["n"])

    def start(self, msg) -> None:
        worker = self.conn.worker
        # Start thunks can be queued from two paths concurrently (a
        # post_recv claim and a FLUSH force-start): the check-and-set must
        # be atomic or the uid gets pulled twice.
        with worker.lock:
            if self.started:
                return
            self.started = True
            pr = msg.posted
        device = None
        if pr is not None and isinstance(pr.buf, DeviceRecvSink):
            device = pr.buf.devbuf.device
        self.manager.pull(
            self.desc, device,
            lambda arr, m=msg: worker._on_pull_done(m, PulledPayload(arr), None),
            lambda err, m=msg: worker._on_pull_done(m, None, err),
            getattr(worker, "stage_scope", None),
        )


def send_device(worker, conn, buffer, tag, done, fail):
    """Route a device payload: a snapshot handed over in-process, a pull
    when the peer negotiated one and a route reaches it, host staging
    otherwise."""
    from . import config

    src = buffer.array if isinstance(buffer, DeviceBuffer) else buffer
    payload = DevicePayload(src)
    payload.scope = getattr(worker, "stage_scope", None)
    if conn is not None and conn.kind == "inproc":
        worker.submit_send(conn, payload.snapshot(), tag, done, fail, payload)
        return
    if (conn is not None and getattr(conn, "devpull_ok", False)
            and payload.nbytes >= config.devpull_threshold()):
        mgr = worker.transfer_manager()
        desc = (mgr.offer(payload, conn, src.shape, src.dtype)
                if mgr is not None else None)
        if desc is not None:
            worker.submit_devpull(conn, desc, tag, done, fail, payload)
            return
    # A session conn's replay journal must OWN every eager frame's bytes
    # past local completion (core/conn.py sess_wrap snapshots flat host
    # views), but a chunked payload is re-staged lazily from the device
    # buffer -- which the eager contract lets the caller overwrite once
    # ``done`` fires.  Journaled eager sends therefore take the full host
    # snapshot below instead of the chunked pipeline.
    journaled = (config.session_enabled() if conn is None
                 else getattr(conn, "sess", None) is not None)
    # §19 integrity conns checksum at framing time, which needs the whole
    # payload resident: device sends on them take the flat host snapshot
    # too (the CRC folds once over the full view; DESIGN.md §19).
    journaled = journaled or (
        config.integrity_enabled() if conn is None
        else bool(getattr(conn, "csum_ok", False)))
    # Multi-rail striping (DESIGN.md §17) needs a flat host view -- chunks
    # are random-offset slices, and the §12 lazy-chunked pipeline stages
    # strictly in order.
    stripe_thr = config.stripe_threshold()
    striped = (stripe_thr > 0 and payload.nbytes >= stripe_thr
               and bool(getattr(conn, "rails", None)))
    if (getattr(worker, "supports_chunked_tx", False)
            and not journaled and not striped
            and payload.nbytes <= config.rndv_threshold()):
        # Eager payloads only: an eager send completes when the LAST chunk
        # is staged and written, so completion still licenses the caller
        # to overwrite the tensor.  A rendezvous send completes at
        # header-on-wire with lazy staging still reading the tensor
        # afterwards, which would revoke that license -- rndv payloads
        # keep the full up-front host snapshot instead.
        chunked = payload.chunked(config.chunk_bytes())
        if chunked is not None:
            worker.submit_send(conn, chunked, tag, done, fail, payload)
            return
    view = payload.as_host_view()
    worker.submit_send(conn, view, tag, done, fail, payload)


def post_device_recv(worker, buffer, tag, mask, done, fail):
    if not isinstance(buffer, DeviceBuffer):
        raise TypeError("device receives require a DeviceBuffer sink")
    sink = DeviceRecvSink(buffer)
    sink.scope = getattr(worker, "stage_scope", None)
    worker.post_recv(sink, tag, mask, done, fail, owner=sink)
