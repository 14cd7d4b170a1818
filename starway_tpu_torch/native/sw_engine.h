/* starway-tpu native engine — public C ABI.
 *
 * This header is the contract between the C++ engine (sw_engine.cpp) and the
 * Python ctypes bridge (starway_tpu/core/native.py).  It plays the role the
 * reference's hand-written type stub plays for its nanobind module
 * (reference: src/starway/_bindings.pyi — "the contract the Python layer
 * codes against"): a single authoritative description of every function,
 * callback signature, and lifetime rule crossing the language boundary.
 * The ctypes argtypes/restype declarations in core/native.py:load() must
 * mirror this file exactly.
 *
 * General rules:
 *  - sw_send/sw_recv/sw_flush/sw_close/sw_free are thread-safe entry points
 *    that enqueue work for the worker's engine thread and return
 *    immediately.  sw_status/sw_primary_conn/sw_list_conns/sw_conn_info are
 *    synchronous thread-safe queries.  sw_server_listen runs
 *    socket/bind/listen synchronously (returns the bound port);
 *    sw_server_set_accept_cb and sw_client_connect are setup calls that
 *    must happen-before listen / are once-only respectively.
 *  - Callbacks fire on the engine thread with NO engine lock held (the
 *    FireList discipline, DESIGN.md §2).  The ctypes trampoline re-acquires
 *    the GIL.  A callback may re-enter any sw_* function.
 *  - `ctx` values are opaque cookies round-tripped to the callbacks; the
 *    Python side uses integer keys into a registry that keeps buffers and
 *    closures alive (core/native.py:_register/_take).
 *  - Buffers are BORROWED: sw_send/sw_recv capture the raw pointer only.
 *    The caller must keep the memory alive until the op's release/done/fail
 *    callback fires (reference semantics: src/bindings/main.hpp:55-59).
 */

#ifndef STARWAY_TPU_SW_ENGINE_H_
#define STARWAY_TPU_SW_ENGINE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ----------------------------------------------------------- callbacks */

/* Op completed successfully (send local-complete, flush barrier reached,
 * close finished). */
typedef void (*sw_done_cb)(void* ctx);

/* Op failed; `reason` is a NUL-terminated human-readable string, valid only
 * for the duration of the call.  Cancellation reasons contain "cancel"
 * (the reference-pinned contract, tests/test_basic.py shutdown section). */
typedef void (*sw_fail_cb)(void* ctx, const char* reason);

/* Receive completed: `sender_tag` is the peer's send tag, `length` the
 * delivered payload size (<= posted capacity). */
typedef void (*sw_recv_cb)(void* ctx, uint64_t sender_tag, uint64_t length);

/* Server accepted a new handshaken connection. */
typedef void (*sw_accept_cb)(void* ctx, uint64_t conn_id);

/* Connect outcome: status == "" on success, error text otherwise. */
typedef void (*sw_status_cb)(void* ctx, const char* status);

/* Engine lifecycle event (resilient sessions, DESIGN.md §14): `event` is
 * a static string ("session-resume" / "session-expired"), valid for the
 * duration of the call.  The wrapper uses these as flight-recorder dump
 * triggers (core/swtrace.py). */
typedef void (*sw_event_cb)(void* ctx, const char* event, uint64_t conn_id);

/* ----------------------------------------------------------- lifecycle */

/* Engine identification string: op deadlines + PING/PONG peer liveness +
 * swtrace observability (sw_counters/sw_trace) + resilient sessions
 * (T_SEQ/T_ACK sequence-numbered exactly-once delivery, replay journal,
 * transparent resume -- negotiated via "sess", DESIGN.md §14) + swscope
 * (end-to-end EV_E2E ordinals via the "tr" handshake key, timestamped
 * PING/PONG clock samples, per-conn gauges via sw_gauges -- DESIGN.md
 * §15) + multi-rail striping (T_SDATA/T_SACK chunk frames, the
 * "rails"/"rail_of" handshake keys, chunk-level work stealing with
 * offset-dedup reassembly and SACK-covered flush barriers -- DESIGN.md
 * §17) + the end-to-end integrity plane (T_CSUM per-frame CRC32C
 * prefixes, T_SNACK chunk-level retransmit, checksummed sm slot records,
 * the "csum" handshake key and the stable "corrupt" poison reason --
 * DESIGN.md §19) + the swcompose decode-contract hardening (zero and
 * oversized ctl bodies and zero-length striped chunks are protocol
 * violations in both engines; T_CSUM prefixes truncate to the 32-bit
 * CRC -- DESIGN.md §21) + the swrefine protocol-event channel (EV_PROTO
 * events on the swtrace ring, armed by STARWAY_PROTO_TRACE /
 * STARWAY_MONITOR; no wire change -- DESIGN.md §22) + swpulse always-on
 * latency/size histograms and the opt-in stall sentinel (sw_hists,
 * STARWAY_STALL_MS, EV_STALL -- DESIGN.md §25).  The annotation
 * below is machine-checked against the sw_engine.cpp implementation by
 * the contract checker (python -m starway_tpu.analysis, rule
 * contract-version) -- bump BOTH when the protocol changes.
 * swcheck: engine-version "starway-native-14" */
const char* sw_version(void);

/* swfast capability probe (DESIGN.md §24).  Bitmask of the levers this
 * build+kernel can actually engage: bit0 io_uring (compiled in AND the
 * runtime NOP probe succeeds; honors STARWAY_IOURING_PROBE_FAIL so the
 * fallback ladder is testable), bit1 MSG_ZEROCOPY (SO_ZEROCOPY settable),
 * bit2 bounded busy-poll (always available).  Pure probe -- no worker,
 * no persistent fds, callable from any thread.  The levers themselves
 * are armed per-worker from STARWAY_IOURING / STARWAY_ZEROCOPY /
 * STARWAY_BUSYPOLL_US at engine-thread start; a probe failure at arm
 * time silently falls back to the seed epoll path. */
uint64_t sw_fast_probe(void);

/* Allocate a client/server worker in the VOID state.  `worker_id` is the
 * UUID hex advertised in the HELLO handshake.  Returned handle must be
 * released with sw_free(). */
void* sw_client_new(const char* worker_id);
void* sw_server_new(const char* worker_id);

/* Start the client engine thread and connect to host:port ("socket" mode)
 * or to a peer advertised by a worker-address blob ("address" mode — the
 * Python layer resolves the blob to host/port first).  Once-only: returns
 * -1 if the worker ever left VOID.  `cb` fires with "" or an error. */
int sw_client_connect(void* h, const char* host, int port, const char* mode,
                      sw_status_cb cb, void* ctx);

/* Install the accept callback (before listen).  Persistent registration:
 * fires once per accepted connection until close. */
int sw_server_set_accept_cb(void* h, sw_accept_cb cb, void* ctx);

/* Bind + listen (synchronously) and start the server engine thread.
 * port 0 = ephemeral.  Returns the bound port (>0) or -errno; any failure
 * rolls the worker back to VOID so a corrected retry is allowed.  A second
 * call while listening returns -EALREADY. */
int sw_server_listen(void* h, const char* addr, int port);

/* ------------------------------------------------------- data-plane ops */

/* Tag-matched send of `len` bytes to `conn_id` (0 = the client's primary
 * connection).  Local-completion semantics: `done` fires when the payload
 * is handed to the transport (eager, len <= STARWAY_RNDV_THRESHOLD) or when
 * transmission has begun (rendezvous); delivery needs sw_flush.  `release`
 * fires exactly once when the engine is finished with the buffer (fully
 * written OR cancelled) — the buffer-keepalive signal, distinct from `done`
 * because rendezvous sends stream on after local completion.
 * Returns 0, or -1 if the worker is not RUNNING (no callback fires). */
/* `timeout_s` (here and on sw_recv/sw_flush): optional deadline in
 * seconds; <= 0 means no deadline.  An op that has not settled when the
 * deadline fires fails with the stable "timed out" reason and releases its
 * resources (a send partially on the wire also tears the connection down —
 * the frame stream cannot be resumed past a withdrawn fragment; a receive
 * claimed mid-stream redirects the remaining payload to scratch so the
 * caller's buffer is immediately repostable). */
int sw_send(void* h, uint64_t conn_id, const void* buf, uint64_t len,
            uint64_t tag, sw_done_cb done, sw_fail_cb fail, void* ctx,
            sw_done_cb release, void* release_ctx, double timeout_s);

/* Post a receive: worker-wide (any connection), matched by
 * (sender_tag & mask) == (tag & mask); mask 0 = wildcard.  FIFO against
 * both the posted queue and the unexpected-message queue.  A matching
 * message larger than `cap` fails the recv ("truncated").
 * Returns 0, or -1 if not RUNNING. */
int sw_recv(void* h, void* buf, uint64_t cap, uint64_t tag, uint64_t mask,
            sw_recv_cb done, sw_fail_cb fail, void* ctx, double timeout_s);

/* Delivery barrier: `done` fires when every DATA frame sent so far on the
 * selected connections has been acknowledged by the peer's engine
 * (FLUSH/FLUSH_ACK round trip).  conn_scoped != 0 limits the barrier to
 * `conn_id` (the reference's flush_ep); otherwise all connections.
 * Fails if a dirty peer died ("peer reset").  Returns 0 or -1. */
int sw_flush(void* h, uint64_t conn_id, int conn_scoped,
             sw_done_cb done, sw_fail_cb fail, void* ctx, double timeout_s);

/* Graceful close: RUNNING -> CLOSING; the engine thread cancels queued and
 * in-flight ops (reason contains "cancel"), closes sockets (RST if a data
 * frame was partially written), fires `done`, and parks in CLOSED.
 * Returns 0, or -1 if not RUNNING (double close). */
int sw_close(void* h, sw_done_cb done, void* ctx);

/* ------------------------------------------------------------- queries */

/* Lifecycle status: 0 VOID, 1 INIT, 2 RUNNING, 3 CLOSING, 4 CLOSED
 * (mirrors the reference's 5-state atomic, src/bindings/main.hpp). */
int sw_status(void* h);

/* The client's single connection id (0 until connected). */
uint64_t sw_primary_conn(void* h);

/* Copy up to `cap` handshaken conn ids into `out`; returns the total count
 * (which may exceed `cap` — call again with a larger buffer). */
int sw_list_conns(void* h, uint64_t* out, int cap);

/* Write a JSON object {name, mode, alive, local_addr, local_port,
 * remote_addr, remote_port} for `conn_id` into `out` (NUL-terminated).
 * Returns the body length, or -1 if unknown/too small. */
int sw_conn_info(void* h, uint64_t conn_id, char* out, int cap);

/* ------------------------------------------------------ swtrace (observability)
 *
 * The engine implements the swtrace counter registry and per-op trace ring
 * (starway_tpu/core/swtrace.py is the Python twin; DESIGN.md §13).  The
 * counter vocabulary (kCounterNames in sw_engine.cpp) and the trace
 * event-type literals (kEv*) are part of the two-engine contract,
 * machine-checked by `python -m starway_tpu.analysis` (rule
 * contract-trace).  Recording is lock-free (atomic counters; atomic ring
 * index) and compiled down to one `enabled` test per event when tracing
 * is off (STARWAY_TRACE / STARWAY_FLIGHT_DIR both unset). */

/* Counter snapshot as a JSON object {"sends_posted": N, ...} over the
 * shared vocabulary (NUL-terminated).  Thread-safe; callable in any
 * lifecycle state until sw_free.  Returns the body length, or -1 when
 * `cap` is too small. */
int sw_counters(void* h, char* out, int cap);

/* swpulse histogram snapshot (DESIGN.md §25): a JSON object
 * {"<name>": [64 bucket counts], ...} over the kHistNames vocabulary
 * (the core/swtrace.py HIST_NAMES twin, machine-checked by rule
 * contract-trace).  Log-bucketed: bucket i counts values of bit-length i
 * (zero -> bucket 0); latencies in microseconds, sizes in bytes.
 * Always live (the taps are unconditional, like the counters);
 * thread-safe relaxed loads.  Returns the body length, or -1 when `cap`
 * is too small. */
int sw_hists(void* h, char* out, int cap);

/* Trace-ring dump as a JSON array, oldest event first, each
 * {"t": seconds, "ev": "...", "tag": N, "conn": N, "n": N, "reason": "..."}
 * with `t` on the CLOCK_MONOTONIC timeline (comparable with the Python
 * ring's time.perf_counter stamps).  "[]" when tracing is off.  Returns
 * the body length, or -1 when `cap` is too small.  Thread-safe; an event
 * being overwritten concurrently may render garbled but never corrupts
 * the JSON framing. */
int sw_trace(void* h, char* out, int cap);

/* swscope live-gauge snapshot (DESIGN.md §15): a JSON object
 * {"conns": {"<conn_id>": {"tx_queue_depth": N, "tx_queue_bytes": N,
 * "inflight_sends": N, "inflight_recvs": N, "journal_bytes": N,
 * "journal_frames": N}}, "posted_recvs": N} over the kGaugeNames
 * vocabulary (the core/telemetry.py GAUGE_NAMES twin, machine-checked by
 * rule contract-trace).  Values are instantaneous and drain to zero on
 * an idle, flushed worker.  Thread-safe: the call marshals to the engine
 * thread (gauges read live engine-owned queues) and blocks briefly;
 * callable from engine-thread callbacks (renders directly).  Returns the
 * body length; -(needed bytes) when `cap` is too small (retry with that
 * capacity); -1 when the engine did not answer within the internal
 * deadline. */
int sw_gauges(void* h, char* out, int cap);

/* ------------------------------------------------------------- devpull
 *
 * The device pull extension (wire: T_DEVPULL, see core/frames.py).  The
 * engine owns the wire + matching; the embedder (the port's
 * core/native.py) owns the pulls, which run on torch (CUDA IPC).
 *
 * Setup: call sw_set_cudaipc and sw_set_devpull BEFORE listen/connect.
 * When `advertise` is non-zero the handshake offers/accepts "cudaipc"
 * with the identity sw_set_cudaipc gave (never "devpull": a JAX peer
 * would send PJRT descriptors); sw_conn_info reports the peer's value
 * as "cudaipc" (empty when not negotiated).  ALL matching lives in
 * the engine's matcher (descriptor records share the one FIFO unexpected
 * stream with staged DATA, so same-tag ordering is identical to the
 * Python engine's):
 *
 *   - `cb` fires on the engine thread for every descriptor received, with
 *     the raw JSON body, an engine-assigned msg_id, and the match result:
 *     rc 1 = a posted receive was claimed (recv_ctx = its ctx, removed
 *     from the matcher; the embedder completes it after pulling), rc -1 =
 *     matched but the receive was too small (recv_ctx set; the EMBEDDER
 *     fires the truncation failure), rc 0 = queued in the unexpected
 *     stream.
 *   - `claim_cb` fires when a LATER sw_recv claims a queued descriptor:
 *     flags 0 = claimed (recv_ctx = the receive's ctx, not posted to the
 *     matcher), flags 1 = the receive was too small (engine already fired
 *     its failure; recv_ctx is 0; the record is consumed).
 *
 * The embedder pulls the payload eagerly whatever the match outcome (the
 * sender's buffer must be released and flush must be able to complete)
 * and calls sw_devpull_resolved(conn_id, msg_id) when the pull lands or
 * fails.  FLUSH_ACKs for barriers that arrived after the descriptor are
 * withheld until every such descriptor resolves (the sender's flush means
 * "payload resident at the receiver").
 *
 * KNOWN LIMITATION: a receive claimed by a devpull descriptor leaves this
 * engine's matcher (the embedder owns its completion), so a `timeout_s`
 * armed on it and the keepalive fail-pending sweep cannot reach it from
 * here; if the pull itself stalls forever the receive hangs.  The Python
 * engine keeps such claims in its inflight set and expires them.  Bounding
 * pull time natively needs a wrapper-side deadline (core/native.py). */
typedef void (*sw_devpull_cb)(void* ctx, uint64_t conn_id, uint64_t tag,
                              const char* body, uint64_t len,
                              uint64_t msg_id, int rc, uint64_t recv_ctx);
typedef void (*sw_devpull_claim_cb)(void* ctx, uint64_t remote_id,
                                    uint64_t recv_ctx, int flags);
void sw_set_devpull(void* h, int advertise, sw_devpull_cb cb,
                    sw_devpull_claim_cb claim_cb, void* ctx);

/* This process's "cudaipc" HELLO value (host|boot|pid; the port's
 * device.py cudaipc_identity()), copied by the engine. */
void sw_set_cudaipc(void* h, const char* identity);

/* `ok` nonzero = the pull landed: a still-queued descriptor record becomes
 * `ready` and survives the sender's death, like a complete staged message
 * (one peer-death contract with the Python engine). */
void sw_devpull_resolved(void* h, uint64_t conn_id, uint64_t msg_id, int ok);

/* A pull failed while its conn is still alive: remove the matcher's queued
 * descriptor record so it cannot consume future receives (records of a
 * dead conn are purged automatically).  Thread-safe; applied on the engine
 * thread. */
void sw_devpull_purge(void* h, uint64_t remote_id);

/* Queue a DEVPULL descriptor send (counts as tagged data for flush/dirty
 * accounting; `done` fires at local completion = descriptor handed to the
 * transport).  Returns 0, or nonzero when the worker is not running. */
int sw_send_devpull(void* h, uint64_t conn_id, uint64_t tag,
                    const char* body, uint64_t len,
                    sw_done_cb done, sw_fail_cb fail, void* ctx);

/* ------------------------------------------------------------- sessions
 *
 * Resilient sessions (DESIGN.md §14; negotiated via the "sess" handshake
 * key when STARWAY_SESSION=1).  The engine implements the whole state
 * machine internally -- sequence-numbered delivery (T_SEQ), cumulative
 * ACKs (T_ACK), the bounded replay journal, transparent suspend/redial/
 * resume -- and surfaces only two observable edges to the wrapper:
 * op failures carrying the stable "session expired" reason, and the
 * lifecycle events below.  Install before listen/connect; persistent
 * registration, fired on the engine thread with no locks held.  The
 * wrapper (core/native.py) uses them as flight-recorder dump triggers. */
void sw_set_event_cb(void* h, sw_event_cb cb, void* ctx);

/* Destructor path: never blocks, never fails.  Signals close if RUNNING
 * and drops the caller's reference; the engine thread frees the worker
 * when it finishes (reference analogue: destructor-without-close must not
 * hang, tests/test_basic.py implicit-destruction test). */
void sw_free(void* h);

/* Portable shared-memory cursor atomics for the PYTHON engine's sm ring.
 *
 * The pure-Python ring (core/shmring.py) depends on x86-TSO store ordering
 * for its data-before-tail publication; Python cannot emit fences, so on
 * other architectures it routes every cursor access through these two
 * functions instead (ctypes call per cursor op -- slower than a mmap read,
 * far faster than losing sm to TCP).  `p` must be 8-byte aligned and point
 * into the mapped segment.  Acquire load / release store, matching the
 * C++ engine's own SmRing accessors -- one memory-ordering contract for
 * both engines on the same segment layout. */
uint64_t sw_atomic_load_u64(const void* p);
void sw_atomic_store_u64(void* p, uint64_t v);

/* CRC32C (Castagnoli) over `n` bytes at `p`, chained onto a previous
 * call's RESULT via `seed` (the zlib.crc32 calling convention: pass 0 to
 * start, the last return value to continue).  Hardware SSE4.2 / ARMv8
 * CRC instructions when the host supports them, software slicing-by-8
 * otherwise.  This is the §19 integrity plane's checksum; the PYTHON
 * engine calls this same export (core/frames.py crc32c), so both engines
 * -- and both ends of a mixed pair -- agree bit-for-bit. */
uint32_t sw_crc32c(const void* p, uint64_t n, uint32_t seed);

/* swcompose differential decode harness (DESIGN.md §21): run the
 * engine's structural frame decoder over a flat buffer and render the
 * canonical outcome string (status, consumed bytes, frame entries --
 * the byte-identical format of core/frames.py decode_stream /
 * core/shmring.py decode_sm_records).  `mode`: 0 = plain stream,
 * 1 = §19 integrity stream, 2 = sm slot records.  Pure function -- no
 * worker, no I/O, callable from any thread.  Returns the full outcome
 * length (output truncated to cap-1 + NUL when longer), or -1 on a bad
 * argument.  Consumed by `python -m starway_tpu.analysis` (wirefuzz). */
int sw_wire_decode(const void* p, uint64_t n, int mode, char* out, int cap);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* STARWAY_TPU_SW_ENGINE_H_ */
