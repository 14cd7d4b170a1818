// starway-tpu native host engine (C++20).
//
// The PyTorch port's copy of native/sw_engine.cpp.  It differs in one
// respect: the device pull is negotiated under the HELLO key "cudaipc",
// whose value is the process's identity (host|boot|pid, given by
// sw_set_cudaipc), and never under "devpull", whose peers send PJRT
// descriptors that the port cannot pull.  Descriptor frames, matching
// and flush deferral are the original's.
//
// The TPU-native counterpart of the reference's C++ binding core
// (reference: src/bindings/main.cpp -- UCX workers driven by busy-poll
// progress threads).  This engine keeps the reference's ownership model
// (one engine thread owns all socket I/O per worker; the application thread
// only enqueues ops) but is event-driven: epoll + eventfd wakeup, zero CPU
// when idle, instead of a 100% busy-poll loop.
//
// Wire protocol: identical to the Python engine (starway_tpu/core/frames.py)
// -- 17-byte little-endian header {u8 type, u64 a, u64 b}; HELLO/HELLO_ACK
// carry a tiny JSON body; DATA streams `b` payload bytes; FLUSH/FLUSH_ACK
// carry a sequence number.  Native and Python workers interoperate across
// processes.
//
// Exposed as a plain extern "C" surface consumed through ctypes
// (starway_tpu/core/native.py).  Callbacks are invoked from the engine
// thread with no locks held; the ctypes trampoline re-acquires the GIL.

#include "sw_engine.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <linux/errqueue.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/random.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <unistd.h>
#if defined(__aarch64__)
#include <sys/auxv.h>
#endif

// DESIGN.md §24 swfast: the io_uring lever is compiled from the raw
// kernel uapi header (the image carries no liburing); kernels or build
// environments without it degrade to the epoll core at compile time,
// and a failed runtime probe degrades at worker start.
#if defined(__linux__) && __has_include(<linux/io_uring.h>) && \
    defined(__NR_io_uring_setup)
#include <linux/io_uring.h>
#define SW_HAVE_IOURING 1
#else
#define SW_HAVE_IOURING 0
#endif

// MSG_ZEROCOPY shipped in 4.14 but some libc headers lag the kernel.
#ifndef SO_ZEROCOPY
#define SO_ZEROCOPY 60
#endif
#ifndef MSG_ZEROCOPY
#define MSG_ZEROCOPY 0x4000000
#endif
#ifndef SO_EE_ORIGIN_ZEROCOPY
#define SO_EE_ORIGIN_ZEROCOPY 5
#endif
#ifndef SO_EE_CODE_ZEROCOPY_COPIED
#define SO_EE_CODE_ZEROCOPY_COPIED 1
#endif

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

// C ABI (functions + callback typedefs) is declared in sw_engine.h — the
// authoritative contract the ctypes bridge mirrors.

// Debug/fatal print macros: debug output compiled out under NDEBUG (release
// builds are silent); fatal always reaches stderr.  Mirrors the reference's
// macro pair (src/bindings/main.cpp debug_print/fatal_print).
#ifdef NDEBUG
#define SW_DEBUG(...) ((void)0)
#else
#define SW_DEBUG(...)                        \
  do {                                       \
    fprintf(stderr, "[sw-engine] " __VA_ARGS__); \
    fputc('\n', stderr);                     \
  } while (0)
#endif
#define SW_FATAL(...)                        \
  do {                                       \
    fprintf(stderr, "[sw-engine FATAL] " __VA_ARGS__); \
    fputc('\n', stderr);                     \
  } while (0)

namespace {

constexpr uint8_t T_HELLO = 1;
constexpr uint8_t T_HELLO_ACK = 2;
constexpr uint8_t T_DATA = 3;
constexpr uint8_t T_FLUSH = 4;
constexpr uint8_t T_FLUSH_ACK = 5;
constexpr uint8_t T_DEVPULL = 6;  // negotiated PJRT-pull descriptor (frames.py)
constexpr uint8_t T_PING = 7;     // negotiated peer-liveness probe (frames.py)
constexpr uint8_t T_PONG = 8;
constexpr uint8_t T_SEQ = 9;      // session layer: next frame's sequence number
constexpr uint8_t T_ACK = 10;     // session layer: cumulative received seq
constexpr uint8_t T_BYE = 11;     // session layer: peer's clean local close
constexpr uint8_t T_SDATA = 12;   // multi-rail striped chunk (DESIGN.md §17)
constexpr uint8_t T_SACK = 13;    // striped-message assembly complete
constexpr uint8_t T_CREDIT = 14;  // flow control: receiver window grant (§18)
constexpr uint8_t T_RTS = 15;     // flow control: rendezvous announcement
constexpr uint8_t T_CTS = 16;     // flow control: receiver pull grant
constexpr uint8_t T_CSUM = 17;    // integrity: next frame's CRC32C (§19)
constexpr uint8_t T_SNACK = 18;   // integrity: corrupt-chunk retransmit req
constexpr size_t HEADER_SIZE = 17;
// Rendezvous (RTS/CTS) msg-id namespace bit: fc ids carry the top bit so
// they can never collide with stripe msg ids on a railed+fc conn (the
// frames.py FC_MSG_BIT twin; both families share the receiver's assembly
// table and completed-id LRU).
constexpr uint64_t FC_MSG_BIT = 1ull << 63;
// Striped-DATA sub-header: u64 msg_id, u64 offset, u64 total (LE) --
// the core/frames.py SDATA_SUB twin, machine-checked by swcheck.
constexpr size_t SDATA_SUB_SIZE = 24;

// §19/§21 decode-contract tables, shared between the live parser
// (pump_frames) and the sw_wire_decode differential harness so the two
// can never drift from each other.  The Python twins are
// frames.CSUM_EXEMPT / frames.CSUM_BODY / frames.HEADER_ONLY /
// frames.CTL_MAX; membership and value are diffed by the `wirefuzz`
// analysis pass (DESIGN.md §21).
constexpr uint8_t kCsumExempt[] = {T_HELLO, T_HELLO_ACK, T_SEQ};
constexpr uint8_t kCsumBody[] = {T_DATA, T_DEVPULL, T_RTS};
constexpr uint8_t kHeaderOnly[] = {T_FLUSH, T_FLUSH_ACK, T_PING, T_PONG,
                                   T_SEQ,   T_ACK,       T_BYE,  T_SACK,
                                   T_CREDIT, T_CTS,      T_SNACK};
// Ctl (JSON-body) frames are tiny; their length field is otherwise a
// remote allocation primitive, and b == 0 was a cross-engine divergence
// (silent drop here, conn-death/stall in the Python engine).
constexpr uint64_t CTL_MAX = 1ull << 20;

inline bool csum_exempt(uint8_t t) {
  for (uint8_t e : kCsumExempt)
    if (t == e) return true;
  return false;
}
inline bool csum_body(uint8_t t) {
  for (uint8_t e : kCsumBody)
    if (t == e) return true;
  return false;
}
inline bool header_only_frame(uint8_t t) {
  for (uint8_t e : kHeaderOnly)
    if (t == e) return true;
  return false;
}

constexpr int ST_VOID = 0, ST_INIT = 1, ST_RUNNING = 2, ST_CLOSING = 3, ST_CLOSED = 4;

const char* kCancelled = "Operation cancelled (local endpoint closed before completion)";
const char* kNotConnected = "Endpoint is not connected";
const char* kTruncated = "Message truncated: payload larger than posted receive buffer";
const char* kTimedOut = "Operation timed out (deadline exceeded before completion)";
const char* kSessionExpired = "Session expired (resume window elapsed or peer restarted)";
const char* kCorrupt = "Data integrity violation (corrupt frame detected)";

using Clock = std::chrono::steady_clock;

// --------------------------------------------------- swtrace (observability)
//
// Counter registry + per-op trace ring (DESIGN.md §13), the C++ twin of
// starway_tpu/core/swtrace.py.  The event-type literals and the counter
// vocabulary are cross-engine contract surface: `python -m
// starway_tpu.analysis` (rule contract-trace) diffs them against the
// Python EV_* constants and COUNTER_NAMES tuple -- keep the two in
// lockstep when adding either.

const char* kEvSendPost = "send_post";
const char* kEvSendDone = "send_done";
const char* kEvRecvPost = "recv_post";
const char* kEvRecvMatch = "recv_match";
const char* kEvRecvDone = "recv_done";
const char* kEvFlushPost = "flush_post";
const char* kEvFlushDone = "flush_done";
const char* kEvOpFail = "op_fail";
const char* kEvConnUp = "conn_up";
const char* kEvConnDown = "conn_down";
[[maybe_unused]] const char* kEvStage = "stage_span";  // recorded by the
//               Python data plane only; declared for vocabulary parity
const char* kEvSessResume = "sess_resume";
const char* kEvSessExpire = "sess_expire";
// swscope (DESIGN.md §15): tag = per-conn per-direction wire ordinal,
// reason = "<trace-conn id>:tx|rx|sup"; equal (id, ordinal) at the two
// ends of a conn is ONE message (trace --merge pairs them).
const char* kEvE2e = "e2e";
// Clock-offset sample from a timestamped PING/PONG round trip:
// reason = "<trace-conn id>:<offset_us>:<err_us>".
const char* kEvClock = "clock_sample";
// swrefine protocol event (DESIGN.md §22): conn = conn id, reason = the
// canonical event -- "rx:<FRAME>" at inbound dispatch, "tx:<FRAME>" at
// ctl-plane handoff, "st:hello-sent"/"st:estab" at conn creation,
// "lost"/"resume"/"expire"/"down" for the lifecycle.  Armed only by
// STARWAY_PROTO_TRACE / STARWAY_MONITOR (TraceRing::proto); replayed
// through the monitor automaton by `python -m starway_tpu.analysis
// refine --replay` and core/monitor.py.
const char* kEvProto = "proto";
// swpulse stall-sentinel alert (DESIGN.md §25): conn = suspect conn id
// (0 = worker-wide), nbytes = condition age in ms, reason = one of
// kStallReasons.  Armed only by STARWAY_STALL_MS.
const char* kEvStall = "stall";

// Canonical frame-type -> protocol-event name table (the T_* suffix).
// Cross-engine contract surface: frames.py FRAME_NAMES is the Python
// twin, diffed entry-by-entry by the `refine` analysis pass.  Unknown
// types render as "OTHER" -- the unknown-frame dispatch arm.
const char* proto_frame_name(uint8_t t) {
  switch (t) {
    case T_HELLO: return "HELLO";
    case T_HELLO_ACK: return "HELLO_ACK";
    case T_DATA: return "DATA";
    case T_FLUSH: return "FLUSH";
    case T_FLUSH_ACK: return "FLUSH_ACK";
    case T_DEVPULL: return "DEVPULL";
    case T_PING: return "PING";
    case T_PONG: return "PONG";
    case T_SEQ: return "SEQ";
    case T_ACK: return "ACK";
    case T_BYE: return "BYE";
    case T_SDATA: return "SDATA";
    case T_SACK: return "SACK";
    case T_CREDIT: return "CREDIT";
    case T_RTS: return "RTS";
    case T_CTS: return "CTS";
    case T_CSUM: return "CSUM";
    case T_SNACK: return "SNACK";
    default: return "OTHER";
  }
}

// Counter vocabulary, same order as the Counters fields and the values
// array in sw_counters() below (and as core/swtrace.py COUNTER_NAMES).
// staging_* / reconnects live in the Python wrapper (process-global
// staging pool / api-layer reconnect loop) and stay 0 here; the wrapper
// overlays them at snapshot time.
const char* kCounterNames[] = {
    "sends_posted",      "sends_completed",
    "recvs_posted",      "recvs_completed",
    "flushes_posted",    "flushes_completed",
    "ops_timed_out",     "ops_cancelled",
    "bytes_tx",          "bytes_rx",
    "gather_passes",     "gather_items",
    "staging_hits",      "staging_misses",
    "ka_misses",         "reconnects",
    "sessions_resumed",  "frames_replayed",
    "dup_frames_dropped",
    "acks_tx",           "acks_rx",
    "stripe_chunks_tx",  "stripe_chunks_rx",
    "rail_resteals",
    "sends_parked",      "sheds",
    "csum_fail",         "chunk_retx",
    "reshard_bytes",     "reshard_rounds",
    "io_syscalls",       "hot_copies",
    "uring_submits",     "uring_sqes",
    "zc_sends",          "zc_notifies",
    "busypoll_hits",
    "stall_alerts",
};

// swscope per-conn gauge vocabulary, same order as the values rendered by
// sw_gauges() below (and as core/telemetry.py GAUGE_NAMES -- swcheck's
// contract-trace rule diffs the two).  Instantaneous values, computed ON
// the engine thread (sw_gauges marshals through the op queue), so the
// data path carries no shadow state for them.  `posted_recvs` rides
// alongside at worker level; `staging_pool_bytes` is wrapper-global and
// overlaid by core/native.py, like the staging counters.
const char* kGaugeNames[] = {
    "tx_queue_depth",  "tx_queue_bytes",
    "inflight_sends",  "inflight_recvs",
    "journal_bytes",   "journal_frames",
    "stripe_pending",
    "unexp_bytes",     "credits_avail",
    "retx_pending",    "zc_pending",
};

struct Counters {
  std::atomic<uint64_t> sends_posted{0}, sends_completed{0};
  std::atomic<uint64_t> recvs_posted{0}, recvs_completed{0};
  std::atomic<uint64_t> flushes_posted{0}, flushes_completed{0};
  std::atomic<uint64_t> ops_timed_out{0}, ops_cancelled{0};
  std::atomic<uint64_t> bytes_tx{0}, bytes_rx{0};
  std::atomic<uint64_t> gather_passes{0}, gather_items{0};
  std::atomic<uint64_t> staging_hits{0}, staging_misses{0};  // wrapper-owned
  std::atomic<uint64_t> ka_misses{0}, reconnects{0};         // reconnects: wrapper
  std::atomic<uint64_t> sessions_resumed{0}, frames_replayed{0};
  std::atomic<uint64_t> dup_frames_dropped{0};
  std::atomic<uint64_t> acks_tx{0}, acks_rx{0};
  std::atomic<uint64_t> stripe_chunks_tx{0}, stripe_chunks_rx{0};
  std::atomic<uint64_t> rail_resteals{0};
  std::atomic<uint64_t> sends_parked{0}, sheds{0};
  std::atomic<uint64_t> csum_fail{0}, chunk_retx{0};
  // §20 swshard schedule accounting: wrapper-owned (the executor runs
  // above the workers), overlaid at snapshot time like staging_*.
  std::atomic<uint64_t> reshard_bytes{0}, reshard_rounds{0};
  // §23 swcost runtime twin: the dynamic shadow of the static ledger
  // (analysis/cost_budgets.txt).  Unconditional relaxed increments at
  // the data-plane syscall/copy sites -- zero branches on the seed path.
  std::atomic<uint64_t> io_syscalls{0}, hot_copies{0};
  // §24 swfast levers (native-only; the Python engine declares the same
  // names for vocabulary parity and leaves them 0, like staging_* here).
  // zc_notifies counts every errqueue completion, including the ones the
  // kernel flagged SO_EE_CODE_ZEROCOPY_COPIED (fell back to a copy).
  std::atomic<uint64_t> uring_submits{0}, uring_sqes{0};
  std::atomic<uint64_t> zc_sends{0}, zc_notifies{0};
  std::atomic<uint64_t> busypoll_hits{0};
  // §25 swpulse stall sentinel: alerts raised (0 unless STARWAY_STALL_MS
  // armed it -- the sentinel itself never runs on the seed path).
  std::atomic<uint64_t> stall_alerts{0};
};

inline void bump(std::atomic<uint64_t>& c, uint64_t n = 1) {
  c.fetch_add(n, std::memory_order_relaxed);
}

// ------------------------------------------------ swpulse (DESIGN.md §25)
//
// Always-on log-bucketed latency/size distributions, bumped
// unconditionally at the contract points.  Vocabulary AND bucket layout
// are cross-engine contract surface: core/swtrace.py HIST_NAMES /
// HIST_BUCKETS / hist_bucket are the Python twins, diffed by swcheck's
// contract-trace pass.  Latencies in MICROSECONDS, sizes in BYTES;
// bucket i holds values of bit-length i (0 -> bucket 0), so boundaries
// are powers of two and percentiles derive from bucket upper bounds at
// read time.  One bump = one clock read + one relaxed increment into a
// fixed per-worker array: no allocation, no lock, no branch.

const char* kHistNames[] = {
    "send_local_us",  // send post -> local completion (§10 contract)
    "recv_wait_us",   // recv post -> matcher claim
    "flush_us",       // flush barrier post -> all-target acknowledgement
    "park_us",        // §18 credit-window park residency
    "pin_us",         // §17 stripe / §24 zerocopy payload-pin residency
    "msg_bytes",      // payload size per posted send
};

constexpr int kHistBuckets = 64;

// Twin of swtrace.hist_bucket: value.bit_length() clamped to the last
// bucket, 0/negative -> bucket 0 (the argument is unsigned here).
inline int hist_bucket(uint64_t v) {
  if (v == 0) return 0;
  int b = 64 - __builtin_clzll(v);
  return b < kHistBuckets ? b : kHistBuckets - 1;
}

// Same field order as kHistNames and the sw_hists render below.
struct Hists {
  std::atomic<uint64_t> send_local_us[kHistBuckets] = {};
  std::atomic<uint64_t> recv_wait_us[kHistBuckets] = {};
  std::atomic<uint64_t> flush_us[kHistBuckets] = {};
  std::atomic<uint64_t> park_us[kHistBuckets] = {};
  std::atomic<uint64_t> pin_us[kHistBuckets] = {};
  std::atomic<uint64_t> msg_bytes[kHistBuckets] = {};
};

inline void hbump(std::atomic<uint64_t>* h, uint64_t v) {
  h[hist_bucket(v)].fetch_add(1, std::memory_order_relaxed);
}

// Stall-reason vocabulary (§25 sentinel), carried verbatim as the
// EV_STALL reason.  Cross-engine contract surface: swtrace.STALL_REASONS
// is the Python twin, diffed by contract-pulse.
const char* kStallReasons[] = {
    "stall-flush",   // flush barrier outlived the threshold, no progress
    "stall-credit",  // §18 parked sends aged out with no credit arrival
    "stall-pin",     // stripe/zerocopy/journal pins undrained
    "stall-unexp",   // unexpected-queue residency with no recv progress
};

struct TraceEvent {
  double t = 0.0;
  const char* ev = nullptr;  // one of the kEv* literals (static storage)
  uint64_t tag = 0, conn = 0, nbytes = 0;
  char reason[48] = {0};
};

// Bounded lock-free per-worker event ring: writers bump an atomic index
// and fill their slot; no lock is ever taken, so recording is legal from
// any context, including under the matcher's mutex (it is a data write,
// not a callback -- the FireList discipline concerns user code).  A slot
// being overwritten while sw_trace reads it may render garbled; the dump
// is post-mortem/bench tooling and tolerates that.
struct TraceRing {
  bool enabled = false;
  // swrefine protocol-event channel (DESIGN.md §22): armed separately so
  // plain STARWAY_TRACE runs keep their seed event streams; the env-unset
  // path pays one bool test per frame and emits nothing.
  bool proto = false;
  uint64_t cap = 0;
  std::vector<TraceEvent> buf;
  std::atomic<uint64_t> widx{0};

  // Armed per worker at creation: STARWAY_TRACE on, a flight-recorder
  // directory configured, the swrefine protocol channel requested, or the
  // §25 stall sentinel armed (EV_STALL alerts need a ring to land in)
  // (core/swtrace.py active()/proto_active() are the Python twins).
  void init() {
    const char* t = getenv("STARWAY_TRACE");
    const char* f = getenv("STARWAY_FLIGHT_DIR");
    const char* p = getenv("STARWAY_PROTO_TRACE");
    const char* m = getenv("STARWAY_MONITOR");
    const char* s = getenv("STARWAY_STALL_MS");
    proto = (p && *p && strcmp(p, "0") != 0) ||
            (m && *m && strcmp(m, "0") != 0);
    enabled = (t && *t && strcmp(t, "0") != 0) || (f && *f) || proto ||
              (s && strtod(s, nullptr) > 0);
    if (!enabled) return;
    const char* rs = getenv("STARWAY_TRACE_RING");
    uint64_t c = rs ? strtoull(rs, nullptr, 10) : 4096;
    if (c < 16) c = 16;
    if (c > (1u << 20)) c = 1u << 20;
    cap = c;
    buf.resize((size_t)c);
  }

  void rec(const char* ev, uint64_t tag = 0, uint64_t conn = 0,
           uint64_t nbytes = 0, const char* reason = nullptr) {
    if (!enabled) return;
    uint64_t i = widx.fetch_add(1, std::memory_order_relaxed);
    TraceEvent& e = buf[(size_t)(i % cap)];
    e.t = std::chrono::duration<double>(Clock::now().time_since_epoch()).count();
    e.tag = tag;
    e.conn = conn;
    e.nbytes = nbytes;
    if (reason) {
      size_t j = 0;
      for (; reason[j] && j < sizeof(e.reason) - 1; j++) {
        char c = reason[j];
        e.reason[j] = (c < 0x20 || c == '"' || c == '\\') ? ' ' : c;
      }
      e.reason[j] = 0;
    } else {
      e.reason[0] = 0;
    }
    e.ev = ev;  // written last: a nonnull ev marks the slot renderable
  }

  // swrefine taps (no-ops unless the protocol channel is armed).
  void proto_ev(uint64_t conn, const char* ev) {
    if (proto) rec(kEvProto, 0, conn, 0, ev);
  }
  // 32 bytes: longest current name is HELLO_ACK (9 + "rx:" + NUL = 13);
  // headroom so a future long frame name cannot silently truncate into
  // a spurious bad-event at replay (the reason slot itself holds 48).
  void proto_rx(uint64_t conn, uint8_t type) {
    if (!proto) return;
    char r[32];
    snprintf(r, sizeof(r), "rx:%s", proto_frame_name(type));
    rec(kEvProto, 0, conn, 0, r);
  }
  void proto_tx(uint64_t conn, uint8_t type) {
    if (!proto) return;
    char r[32];
    snprintf(r, sizeof(r), "tx:%s", proto_frame_name(type));
    rec(kEvProto, 0, conn, 0, r);
  }
};

// CLOCK_MONOTONIC nanoseconds -- the same epoch the trace ring's `t`
// stamps use (steady_clock), wire format of the PING/PONG clock channel.
uint64_t now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             Clock::now().time_since_epoch())
      .count();
}

// Monotonic seconds (the trace ring's `t` epoch): the §25 histogram taps
// stamp origins and diff against this.
inline double mono_s() {
  return std::chrono::duration<double>(Clock::now().time_since_epoch())
      .count();
}

// §25 stall-sentinel threshold (STARWAY_STALL_MS, ms; 0/unset = off).
// Sampled once per worker at engine start, like the §24 levers.
double stall_ms_env() {
  const char* e = getenv("STARWAY_STALL_MS");
  double v = e ? strtod(e, nullptr) : 0.0;
  return v > 0 ? v : 0.0;
}

uint64_t rndv_threshold() {
  // Read per send like the Python engine's config.rndv_threshold() --
  // the test matrix (and the §18 fc gate) flip it between workers, and
  // a process-cached value would make the two engines disagree on the
  // eager/rndv split for identical submissions.
  const char* e = getenv("STARWAY_RNDV_THRESHOLD");
  return e ? strtoull(e, nullptr, 10) : (uint64_t)(8u << 20);
}

// Per-attempt connect + handshake deadline (config.py STARWAY_CONNECT_TIMEOUT,
// seconds).  Read per connect, not cached: tests flip it between workers.
int connect_timeout_ms() {
  const char* e = getenv("STARWAY_CONNECT_TIMEOUT");
  double s = e ? strtod(e, nullptr) : 0.0;
  return s > 0 ? (int)(s * 1000.0) : 3000;
}

// Peer-liveness keepalive (config.py STARWAY_KEEPALIVE[_MISSES]).  0 =
// disabled, the reference-parity default (peer death leaves recvs pending).
double ka_interval_env() {
  const char* e = getenv("STARWAY_KEEPALIVE");
  double s = e ? strtod(e, nullptr) : 0.0;
  return s > 0 ? s : 0.0;
}

int ka_misses_env() {
  const char* e = getenv("STARWAY_KEEPALIVE_MISSES");
  int v = e ? atoi(e) : 3;
  return v > 0 ? v : 3;
}

// Resilient-session knobs (config.py STARWAY_SESSION*).  Off by default:
// seed parity is "a dropped conn cancels every in-flight op".  Read per
// handshake, like sm_enabled().
bool session_enabled() {
  const char* e = getenv("STARWAY_SESSION");
  return e && *e && strcmp(e, "0") != 0;
}

uint64_t session_journal_bytes_env() {
  const char* e = getenv("STARWAY_SESSION_JOURNAL_BYTES");
  uint64_t v = e ? strtoull(e, nullptr, 10) : (uint64_t)(16u << 20);
  return v < 4096 ? 4096 : v;
}

double session_grace_env() {
  const char* e = getenv("STARWAY_SESSION_GRACE");
  double s = e ? strtod(e, nullptr) : 0.0;
  return s > 0 ? s : 30.0;
}

// ------------------------------------------------- swfast (DESIGN.md §24)
// Three independently-gated opt-in levers on the native data path.  All
// are sampled ONCE per worker at engine-thread start: they are process-
// local accelerations with no wire/HELLO surface, so (unlike
// rndv_threshold) the two peers never need to agree on them.

bool iouring_enabled() {
  const char* e = getenv("STARWAY_IOURING");
  return e && *e && strcmp(e, "0") != 0;
}

bool zerocopy_enabled() {
  const char* e = getenv("STARWAY_ZEROCOPY");
  return e && *e && strcmp(e, "0") != 0;
}

uint64_t busypoll_us_env() {
  const char* e = getenv("STARWAY_BUSYPOLL_US");
  uint64_t v = e ? strtoull(e, nullptr, 10) : 0;
  // Bound the spin budget: this is a latency lever, not a license to
  // burn a core for seconds (the reference's 100%-spin made safe).
  return v > 1000000 ? 1000000 : v;
}

#if SW_HAVE_IOURING
// Raw-syscall shims (no liburing in the image).  Named after the
// syscalls so the §23 cost extractor classifies their call sites.
int io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}

int io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                   unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete, flags,
                      nullptr, 0);
}
#endif

// Minimal single-threaded io_uring wrapper: SQ/CQ rings mapped once per
// worker, used in a strictly synchronous batch model (submit N, wait N)
// so every buffer an SQE references lives on the submitting frame's
// stack/queue and the conn-state machine is identical to the epoll
// core's.  init() failing for ANY reason (old kernel, seccomp, RLIMIT)
// just leaves ok() false and the worker on the epoll core.
struct UringCore {
  int ring_fd = -1;
  unsigned sq_entries = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
#if SW_HAVE_IOURING
  io_uring_sqe* sqes = nullptr;
  io_uring_cqe* cqes = nullptr;
  void* sq_ring = nullptr;
  void* cq_ring = nullptr;
  size_t sq_ring_sz = 0, cq_ring_sz = 0, sqes_sz = 0;
#endif

  bool ok() const { return ring_fd >= 0; }

#if SW_HAVE_IOURING
  bool init(unsigned entries) {
    io_uring_params p{};
    int fd = io_uring_setup(entries, &p);
    if (fd < 0) return false;
    sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
    cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    bool single = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;
    if (single) {
      if (cq_ring_sz > sq_ring_sz) sq_ring_sz = cq_ring_sz;
      cq_ring_sz = sq_ring_sz;
    }
    sq_ring = mmap(nullptr, sq_ring_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
    if (sq_ring == MAP_FAILED) {
      sq_ring = nullptr;
      close(fd);
      return false;
    }
    cq_ring = single ? sq_ring
                     : mmap(nullptr, cq_ring_sz, PROT_READ | PROT_WRITE,
                            MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
    if (cq_ring == MAP_FAILED) {
      cq_ring = nullptr;
      teardown_maps();
      close(fd);
      return false;
    }
    sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
    sqes = (io_uring_sqe*)mmap(nullptr, sqes_sz, PROT_READ | PROT_WRITE,
                               MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES);
    if (sqes == MAP_FAILED) {
      sqes = nullptr;
      teardown_maps();
      close(fd);
      return false;
    }
    auto* sqp = (uint8_t*)sq_ring;
    auto* cqp = (uint8_t*)cq_ring;
    sq_head = (unsigned*)(sqp + p.sq_off.head);
    sq_tail = (unsigned*)(sqp + p.sq_off.tail);
    sq_mask = (unsigned*)(sqp + p.sq_off.ring_mask);
    sq_array = (unsigned*)(sqp + p.sq_off.array);
    cq_head = (unsigned*)(cqp + p.cq_off.head);
    cq_tail = (unsigned*)(cqp + p.cq_off.tail);
    cq_mask = (unsigned*)(cqp + p.cq_off.ring_mask);
    cqes = (io_uring_cqe*)(cqp + p.cq_off.cqes);
    sq_entries = p.sq_entries;
    ring_fd = fd;
    // Probe pass: one NOP through submit+reap proves io_uring_enter works
    // under whatever sandbox/seccomp profile this process runs (SENDMSG
    // itself is kernel 5.3+; anything older fails here, not mid-traffic).
    io_uring_sqe* sqe = get_sqe();
    if (!sqe) {
      shutdown();
      return false;
    }
    sqe->opcode = IORING_OP_NOP;
    int r = io_uring_enter(ring_fd, 1, 1, IORING_ENTER_GETEVENTS);
    bool nop_ok = false;
    reap([&](uint64_t, int) { nop_ok = true; });
    if (r != 1 || !nop_ok) {
      shutdown();
      return false;
    }
    return true;
  }

  // Next free SQE, zeroed, with its ring-array slot wired; caller fills
  // and publishes via the tail store here (single-threaded: no racing
  // producers, the kernel only reads up to the published tail).
  io_uring_sqe* get_sqe() {
    unsigned head = __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
    unsigned tail = *sq_tail;
    if (tail - head >= sq_entries) return nullptr;
    unsigned idx = tail & *sq_mask;
    io_uring_sqe* sqe = &sqes[idx];
    memset(sqe, 0, sizeof(*sqe));
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, tail + 1, __ATOMIC_RELEASE);
    return sqe;
  }

  template <typename F>
  void reap(F&& f) {
    unsigned head = *cq_head;
    unsigned tail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
    while (head != tail) {
      io_uring_cqe* cqe = &cqes[head & *cq_mask];
      f(cqe->user_data, cqe->res);
      head++;
    }
    __atomic_store_n(cq_head, head, __ATOMIC_RELEASE);
  }

  void teardown_maps() {
    if (sqes) munmap(sqes, sqes_sz);
    if (cq_ring && cq_ring != sq_ring) munmap(cq_ring, cq_ring_sz);
    if (sq_ring) munmap(sq_ring, sq_ring_sz);
    sqes = nullptr;
    cq_ring = nullptr;
    sq_ring = nullptr;
  }

  void shutdown() {
    teardown_maps();
    if (ring_fd >= 0) close(ring_fd);
    ring_fd = -1;
    sq_entries = 0;
  }
#else
  // Header absent: the lever compiles out; callers are all guarded.
  bool init(unsigned) { return false; }
  void shutdown() {}
#endif
};

// Multi-rail striping knobs (config.py STARWAY_RAILS / STRIPE_*;
// DESIGN.md §17).  Read per handshake / per send like the session knobs.
int stripe_rails_env() {
  const char* e = getenv("STARWAY_RAILS");
  int v = e ? atoi(e) : 1;
  if (v < 1) v = 1;
  if (v > 16) v = 16;
  return v;
}

uint64_t stripe_threshold_env() {
  const char* e = getenv("STARWAY_STRIPE_THRESHOLD");
  uint64_t v = e ? strtoull(e, nullptr, 10) : 0;
  return v;  // 0 = striping off (seed parity)
}

bool stripe_weighted_env() {
  // Lane-weighted tail claiming (config.py STARWAY_STRIPE_WEIGHTED;
  // DESIGN.md §17).  Off by default: pure work stealing.
  const char* e = getenv("STARWAY_STRIPE_WEIGHTED");
  return e && *e && strcmp(e, "0") != 0;
}

// EWMA smoothing / slow-lane fraction: core/lane.py EWMA_ALPHA and
// SLOW_FRACTION are the twins.
constexpr double kStripeEwmaAlpha = 0.3;
constexpr double kStripeSlowFraction = 0.5;

// Receiver-driven flow control (config.py STARWAY_FC_WINDOW /
// STARWAY_UNEXP_BYTES; DESIGN.md §18).  0 = off, seed parity.  Read per
// handshake / per conn like the session knobs.
uint64_t fc_window_env() {
  const char* e = getenv("STARWAY_FC_WINDOW");
  uint64_t v = e ? strtoull(e, nullptr, 10) : 0;
  return v;
}

uint64_t unexp_cap_env() {
  const char* e = getenv("STARWAY_UNEXP_BYTES");
  uint64_t v = e ? strtoull(e, nullptr, 10) : 0;
  return v;
}

// §19 end-to-end integrity plane (config.py STARWAY_INTEGRITY).  Off by
// default: seed parity (no "csum" handshake key, no checksum frames).
bool integrity_enabled() {
  const char* e = getenv("STARWAY_INTEGRITY");
  return e && *e && strcmp(e, "0") != 0;
}

uint64_t stripe_chunk_env() {
  const char* e = getenv("STARWAY_STRIPE_CHUNK");
  uint64_t v = e ? strtoull(e, nullptr, 10) : 0;
  if (v == 0) {
    // Default: 4x the §12 staging granularity = 1 MiB (config.py twin).
    const char* ch = getenv("STARWAY_CHUNK");
    uint64_t base = ch ? strtoull(ch, nullptr, 10) : (uint64_t)(256u << 10);
    if (base == 0) base = 256u << 10;
    v = 4 * base;
  }
  return v < 4096 ? 4096 : v;
}

// ----------------------------------------------------------------- crc32c
//
// CRC32C (Castagnoli): the §19 integrity plane's checksum.  Hardware
// SSE4.2 (x86) / ARMv8 CRC instructions when the host has them (runtime
// detected), software slicing-by-8 otherwise.  Chaining matches
// zlib.crc32: `seed` is the previous call's RESULT (each call re-inverts
// internally), so payloads fold incrementally.  Exported as sw_crc32c so
// the Python engine computes the identical function (core/frames.py).

uint32_t crc_tbl[8][256];
std::once_flag crc_tbl_once;

void crc_tbl_init() {
  for (int i = 0; i < 256; i++) {
    uint32_t c = (uint32_t)i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    crc_tbl[0][i] = c;
  }
  for (int t = 1; t < 8; t++)
    for (int i = 0; i < 256; i++)
      crc_tbl[t][i] = (crc_tbl[t - 1][i] >> 8) ^ crc_tbl[0][crc_tbl[t - 1][i] & 0xFF];
}

uint32_t crc32c_soft(const uint8_t* p, size_t n, uint32_t c) {
  std::call_once(crc_tbl_once, crc_tbl_init);
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);      // x86/ARM LE, like the wire header
    memcpy(&hi, p + 4, 4);
    c ^= lo;
    c = crc_tbl[7][c & 0xFF] ^ crc_tbl[6][(c >> 8) & 0xFF] ^
        crc_tbl[5][(c >> 16) & 0xFF] ^ crc_tbl[4][c >> 24] ^
        crc_tbl[3][hi & 0xFF] ^ crc_tbl[2][(hi >> 8) & 0xFF] ^
        crc_tbl[1][(hi >> 16) & 0xFF] ^ crc_tbl[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = crc_tbl[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c;
}

// GF(2) machinery for the 3-way interleaved hardware path: the CRC32
// instruction has 3-cycle latency at 1/cycle throughput, so a single
// dependency chain caps out near 8 bytes / 3 cycles.  Running three
// independent chains over adjacent blocks and recombining with
// precomputed shift-by-N tables (the classic crc32c technique) recovers
// the instruction's full throughput -- ~3x, which is what keeps the
// §19 overhead inside its bench gate on copy-saturated hosts.
uint32_t gf2_matrix_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  while (vec) {
    if (vec & 1) sum ^= *mat;
    vec >>= 1;
    mat++;
  }
  return sum;
}

void gf2_matrix_square(uint32_t* square, const uint32_t* mat) {
  for (int n = 0; n < 32; n++) square[n] = gf2_matrix_times(mat, mat[n]);
}

// Operator advancing a CRC over `len` zero bytes (len a power of two).
void crc32c_zeros_op(uint32_t* even, size_t len) {
  uint32_t odd[32];
  odd[0] = 0x82F63B78u;  // CRC-32C polynomial, reflected
  uint32_t row = 1;
  for (int n = 1; n < 32; n++) {
    odd[n] = row;
    row <<= 1;
  }
  gf2_matrix_square(even, odd);   // len == 2
  gf2_matrix_square(odd, even);   // len == 4
  do {
    gf2_matrix_square(even, odd);
    len >>= 1;
    if (len == 0) return;
    gf2_matrix_square(odd, even);
    len >>= 1;
  } while (len);
  for (int n = 0; n < 32; n++) even[n] = odd[n];
}

void crc32c_zeros(uint32_t zeros[4][256], size_t len) {
  uint32_t op[32];
  crc32c_zeros_op(op, len);
  for (uint32_t n = 0; n < 256; n++) {
    zeros[0][n] = gf2_matrix_times(op, n);
    zeros[1][n] = gf2_matrix_times(op, n << 8);
    zeros[2][n] = gf2_matrix_times(op, n << 16);
    zeros[3][n] = gf2_matrix_times(op, n << 24);
  }
}

inline uint32_t crc32c_shift(const uint32_t zeros[4][256], uint32_t crc) {
  return zeros[0][crc & 0xff] ^ zeros[1][(crc >> 8) & 0xff] ^
         zeros[2][(crc >> 16) & 0xff] ^ zeros[3][crc >> 24];
}

constexpr size_t CRC_LONG = 2048, CRC_SHORT = 256;
uint32_t crc_long_tbl[4][256], crc_short_tbl[4][256];
std::once_flag crc_hw_tbl_once;

void crc_hw_tbl_init() {
  crc32c_zeros(crc_long_tbl, CRC_LONG);
  crc32c_zeros(crc_short_tbl, CRC_SHORT);
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t c) {
  std::call_once(crc_hw_tbl_once, crc_hw_tbl_init);
  uint64_t crc0 = c;
  while (n && ((uintptr_t)p & 7)) {
    crc0 = __builtin_ia32_crc32qi((uint32_t)crc0, *p++);
    n--;
  }
  while (n >= 3 * CRC_LONG) {
    uint64_t crc1 = 0, crc2 = 0;
    const uint8_t* end = p + CRC_LONG;
    do {  // three independent dependency chains per iteration
      uint64_t a, b, d;
      memcpy(&a, p, 8);
      memcpy(&b, p + CRC_LONG, 8);
      memcpy(&d, p + 2 * CRC_LONG, 8);
      crc0 = __builtin_ia32_crc32di(crc0, a);
      crc1 = __builtin_ia32_crc32di(crc1, b);
      crc2 = __builtin_ia32_crc32di(crc2, d);
      p += 8;
    } while (p < end);
    crc0 = crc32c_shift(crc_long_tbl, (uint32_t)crc0) ^ crc1;
    crc0 = crc32c_shift(crc_long_tbl, (uint32_t)crc0) ^ crc2;
    p += 2 * CRC_LONG;
    n -= 3 * CRC_LONG;
  }
  while (n >= 3 * CRC_SHORT) {
    uint64_t crc1 = 0, crc2 = 0;
    const uint8_t* end = p + CRC_SHORT;
    do {
      uint64_t a, b, d;
      memcpy(&a, p, 8);
      memcpy(&b, p + CRC_SHORT, 8);
      memcpy(&d, p + 2 * CRC_SHORT, 8);
      crc0 = __builtin_ia32_crc32di(crc0, a);
      crc1 = __builtin_ia32_crc32di(crc1, b);
      crc2 = __builtin_ia32_crc32di(crc2, d);
      p += 8;
    } while (p < end);
    crc0 = crc32c_shift(crc_short_tbl, (uint32_t)crc0) ^ crc1;
    crc0 = crc32c_shift(crc_short_tbl, (uint32_t)crc0) ^ crc2;
    p += 2 * CRC_SHORT;
    n -= 3 * CRC_SHORT;
  }
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    crc0 = __builtin_ia32_crc32di(crc0, v);
    p += 8;
    n -= 8;
  }
  while (n--) crc0 = __builtin_ia32_crc32qi((uint32_t)crc0, *p++);
  return (uint32_t)crc0;
}

bool crc32c_hw_ok() {
  static const bool ok = __builtin_cpu_supports("sse4.2");
  return ok;
}
#elif defined(__aarch64__)
__attribute__((target("+crc")))
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t c) {
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    c = __builtin_aarch64_crc32cx(c, v);
    p += 8;
    n -= 8;
  }
  while (n--) c = __builtin_aarch64_crc32cb(c, *p++);
  return c;
}

bool crc32c_hw_ok() {
  static const bool ok = (getauxval(AT_HWCAP) & (1ul << 7)) != 0;  // HWCAP_CRC32
  return ok;
}
#else
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t c) {
  return crc32c_soft(p, n, c);
}
bool crc32c_hw_ok() { return false; }
#endif

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t seed) {
  uint32_t c = seed ^ 0xFFFFFFFFu;
  c = crc32c_hw_ok() ? crc32c_hw(p, n, c) : crc32c_soft(p, n, c);
  return c ^ 0xFFFFFFFFu;
}

// ------------------------------------------------------- shared-memory rings
//
// Same-host fast path, wire-identical to the Python engine's
// starway_tpu/core/shmring.py (the layout there is the cross-engine
// contract).  The connector offers a /dev/shm segment in HELLO
// (sm_key/sm_nonce/sm_ring), the acceptor maps+validates it and confirms
// with "sm": "ok" in HELLO_ACK, and the framed byte stream moves onto two
// SPSC rings; the socket stays open as doorbell + liveness channel.  The
// analogue of UCX negotiating posix shm when UCX_TLS allows "sm"
// (reference: benchmark.md:114-126).

constexpr uint64_t SM_MAGIC = 0x31676E69726D7773ull;  // "swmring1" LE
constexpr size_t SM_GLOBAL_HDR = 64;
constexpr size_t SM_RING_HDR = 128;
constexpr size_t SM_DATA_OFF = SM_GLOBAL_HDR + 2 * SM_RING_HDR;  // 384
constexpr size_t SM_OFF_TAIL = 0, SM_OFF_HEAD = 64;  // +8: reserved (legacy flag)
// §19 integrity slot-record header inside the data ring: u32 payload len,
// u32 CRC32C(u64 slot seqno LE || payload) -- little-endian, leading
// every ring write once "csum" is negotiated (core/shmring.py REC_HDR is
// the Python twin; both sides flip framing at handshake).
constexpr size_t SM_REC_HDR = 8;

// Doorbell byte values on an sm-upgraded conn's socket (contract shared
// with the Python engine -- core/conn.py).  Any byte wakes the peer;
// DB_STARVING additionally asks it to reply with a doorbell after draining
// its rx ring -- the wakeup for a producer sleeping on a full ring.  All
// wakeups ride the socket: the send/recv syscall pair orders cursor stores
// between processes, so the sleep needs no shared flag (and works against
// a pure-Python peer that cannot fence).
constexpr uint8_t DB_DATA = 1, DB_STARVING = 2;

// Read the env per handshake (not cached): the embedding process may flip
// STARWAY_TLS between connections (the test matrix does), and handshakes
// are rare enough that getenv cost is irrelevant.
bool sm_enabled() {
  const char* e = getenv("STARWAY_TLS");
  std::string tls = e ? e : "inproc,sm,tcp,ici,dcn";
  tls = "," + tls + ",";
  return tls.find(",sm,") != std::string::npos;
}

uint64_t sm_ring_size() {
  const char* e = getenv("STARWAY_SM_RING");
  uint64_t r = e ? strtoull(e, nullptr, 10) : (uint64_t)(1u << 20);
  if (r < 4096) r = 4096;
  if (r > (1ull << 30)) r = 1ull << 30;
  // round up to a power of two
  uint64_t p = 4096;
  while (p < r) p <<= 1;
  return p;
}

// One direction of the segment viewed as a byte stream.  Producer writes
// data then publishes tail with release; consumer reads after an acquire
// load of tail -- the real-atomics version of the Python TSO protocol.
struct SmRing {
  uint8_t* hdr = nullptr;
  uint8_t* data = nullptr;
  uint64_t size = 0;
  // §19 integrity slot records (enabled at handshake once "csum" is
  // negotiated): producer/consumer slot counters + the record the
  // consumer is mid-way through.  These live in the per-conn copy of the
  // ring view, not the shared segment -- each side counts its own role.
  bool slotted = false;
  uint64_t tx_seq = 0, rx_seq = 0;
  uint32_t rec_left = 0, rec_crc = 0, rec_accum = 0;

  std::atomic<uint64_t>& tail() const { return *reinterpret_cast<std::atomic<uint64_t>*>(hdr + SM_OFF_TAIL); }
  std::atomic<uint64_t>& head() const { return *reinterpret_cast<std::atomic<uint64_t>*>(hdr + SM_OFF_HEAD); }

  uint64_t readable() const { return tail().load(std::memory_order_acquire) - head().load(std::memory_order_relaxed); }

  void put(uint64_t cursor, const uint8_t* src, size_t n) {
    uint64_t idx = cursor & (size - 1);
    size_t first = (size_t)(size - idx) < n ? (size_t)(size - idx) : n;
    memcpy(data + idx, src, first);
    if (n > first) memcpy(data, src + first, n - first);
  }

  void take(uint64_t cursor, uint8_t* dst, size_t n) {
    uint64_t idx = cursor & (size - 1);
    size_t first = (size_t)(size - idx) < n ? (size_t)(size - idx) : n;
    memcpy(dst, data + idx, first);
    if (n > first) memcpy(dst + first, data, n - first);
  }

  size_t write(const uint8_t* src, size_t len) {
    uint64_t t = tail().load(std::memory_order_relaxed);
    uint64_t h = head().load(std::memory_order_acquire);
    uint64_t free_b = size - (t - h);
    if (!slotted) {
      size_t n = len < free_b ? len : (size_t)free_b;
      if (n == 0) return 0;
      put(t, src, n);
      tail().store(t + n, std::memory_order_release);
      return n;
    }
    // Slotted: frame the accepted bytes as ONE checksummed record with a
    // single tail publication -- readers always see whole records.
    if (free_b <= SM_REC_HDR) return 0;
    size_t n = len < free_b - SM_REC_HDR ? len : (size_t)(free_b - SM_REC_HDR);
    if (n == 0) return 0;
    uint8_t seq8[8];
    memcpy(seq8, &tx_seq, 8);
    uint32_t crc = crc32c(src, n, crc32c(seq8, 8, 0));
    tx_seq++;
    uint8_t rec[SM_REC_HDR];
    uint32_t n32 = (uint32_t)n;
    memcpy(rec, &n32, 4);
    memcpy(rec + 4, &crc, 4);
    put(t, rec, SM_REC_HDR);
    put(t + SM_REC_HDR, src, n);
    tail().store(t + SM_REC_HDR + n, std::memory_order_release);
    return n;
  }

  // >=0 bytes read; -1 = a slot record failed verification at dequeue
  // (torn write / bit-flip / stale slot): the conn must poison "corrupt".
  ssize_t read_into(uint8_t* dst, size_t len) {
    if (!slotted) {
      uint64_t t = tail().load(std::memory_order_acquire);
      uint64_t h = head().load(std::memory_order_relaxed);
      uint64_t avail = t - h;
      size_t n = len < avail ? len : (size_t)avail;
      if (n == 0) return 0;
      take(h, dst, n);
      head().store(h + n, std::memory_order_release);
      return (ssize_t)n;
    }
    size_t total = 0;
    for (;;) {
      uint64_t t = tail().load(std::memory_order_acquire);
      uint64_t h = head().load(std::memory_order_relaxed);
      uint64_t avail = t - h;
      if (rec_left == 0) {
        if (avail < SM_REC_HDR) break;
        uint8_t rec[SM_REC_HDR];
        take(h, rec, SM_REC_HDR);
        uint32_t n32 = 0, crc = 0;
        memcpy(&n32, rec, 4);
        memcpy(&crc, rec + 4, 4);
        if (n32 == 0 || n32 > size) return -1;  // garbled record header
        head().store(h + SM_REC_HDR, std::memory_order_release);
        rec_left = n32;
        rec_crc = crc;
        uint8_t seq8[8];
        memcpy(seq8, &rx_seq, 8);
        rec_accum = crc32c(seq8, 8, 0);
        rx_seq++;
        continue;
      }
      if (total >= len || avail == 0) break;
      size_t n = len - total;
      if (n > rec_left) n = rec_left;
      if (n > avail) n = (size_t)avail;
      take(h, dst + total, n);
      rec_accum = crc32c(dst + total, n, rec_accum);
      head().store(h + n, std::memory_order_release);
      rec_left -= (uint32_t)n;
      total += n;
      if (rec_left == 0 && rec_accum != rec_crc) return -1;
    }
    return (ssize_t)total;
  }
};

struct SmSegment {
  std::string key;  // "sw-..." (no leading slash; shm_open adds it)
  uint64_t nonce = 0, ring_size = 0;
  uint8_t* base = nullptr;
  size_t total = 0;
  bool creator = false;

  static SmSegment* create(const std::string& hint) {
    uint64_t rsize = sm_ring_size();
    uint64_t nonce = 0, rand_tag = 0;
    if (getrandom(&nonce, 8, 0) != 8 || getrandom(&rand_tag, 8, 0) != 8) return nullptr;
    char keybuf[96];
    snprintf(keybuf, sizeof(keybuf), "sw-%s-%08x", hint.c_str(), (uint32_t)rand_tag);
    std::string shm_name = std::string("/") + keybuf;
    int fd = shm_open(shm_name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return nullptr;
    size_t total = SM_DATA_OFF + 2 * (size_t)rsize;
    if (ftruncate(fd, (off_t)total) != 0) {
      close(fd);
      shm_unlink(shm_name.c_str());
      return nullptr;
    }
    void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (base == MAP_FAILED) {
      shm_unlink(shm_name.c_str());
      return nullptr;
    }
    auto* seg = new SmSegment();
    seg->key = keybuf;
    seg->nonce = nonce;
    seg->ring_size = rsize;
    seg->base = (uint8_t*)base;
    seg->total = total;
    seg->creator = true;
    memcpy(seg->base + 0, &SM_MAGIC, 8);
    memcpy(seg->base + 8, &nonce, 8);
    memcpy(seg->base + 16, &rsize, 8);
    return seg;
  }

  static SmSegment* attach(const std::string& key, uint64_t nonce, uint64_t rsize) {
    if (key.rfind("sw-", 0) != 0 || key.find('/') != std::string::npos) return nullptr;
    if (rsize < 4096 || rsize > (1ull << 30) || (rsize & (rsize - 1))) return nullptr;
    std::string shm_name = std::string("/") + key;
    int fd = shm_open(shm_name.c_str(), O_RDWR, 0);
    if (fd < 0) return nullptr;
    size_t total = SM_DATA_OFF + 2 * (size_t)rsize;
    struct stat st{};
    // /dev/shm is world-writable: only map our own uid's segments, or a
    // hostile local peer could truncate the file under us later (SIGBUS).
    if (fstat(fd, &st) != 0 || st.st_uid != geteuid() || (size_t)st.st_size != total) {
      close(fd);
      return nullptr;
    }
    void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (base == MAP_FAILED) return nullptr;
    uint64_t magic = 0, got_nonce = 0, got_size = 0;
    memcpy(&magic, (uint8_t*)base + 0, 8);
    memcpy(&got_nonce, (uint8_t*)base + 8, 8);
    memcpy(&got_size, (uint8_t*)base + 16, 8);
    if (magic != SM_MAGIC || got_nonce != nonce || got_size != rsize) {
      munmap(base, total);
      return nullptr;
    }
    auto* seg = new SmSegment();
    seg->key = key;
    seg->nonce = nonce;
    seg->ring_size = rsize;
    seg->base = (uint8_t*)base;
    seg->total = total;
    seg->creator = false;
    return seg;
  }

  // (producer, consumer) rings for this side; ring 0 carries
  // connector->acceptor traffic.
  void tx_rx(bool is_creator, SmRing* tx, SmRing* rx) const {
    SmRing r0{base + SM_GLOBAL_HDR, base + SM_DATA_OFF, ring_size};
    SmRing r1{base + SM_GLOBAL_HDR + SM_RING_HDR, base + SM_DATA_OFF + ring_size, ring_size};
    *tx = is_creator ? r0 : r1;
    *rx = is_creator ? r1 : r0;
  }

  void unlink() { shm_unlink((std::string("/") + key).c_str()); }

  ~SmSegment() {
    if (base) munmap(base, total);
  }
};

void pack_header(uint8_t* out, uint8_t type, uint64_t a, uint64_t b) {
  out[0] = type;
  memcpy(out + 1, &a, 8);  // x86/ARM LE; matches struct.pack("<BQQ")
  memcpy(out + 9, &b, 8);
}

void unpack_header(const uint8_t* in, uint8_t* type, uint64_t* a, uint64_t* b) {
  *type = in[0];
  memcpy(a, in + 1, 8);
  memcpy(b, in + 9, 8);
}

// Minimal JSON string-field extractor for our fixed handshake bodies.
std::string json_field(const std::string& body, const std::string& key) {
  std::string pat = "\"" + key + "\"";
  size_t p = body.find(pat);
  if (p == std::string::npos) return "";
  p = body.find(':', p + pat.size());
  if (p == std::string::npos) return "";
  p = body.find('"', p);
  if (p == std::string::npos) return "";
  size_t q = body.find('"', p + 1);
  if (q == std::string::npos) return "";
  return body.substr(p + 1, q - p - 1);
}

// Numeric variant (JSON numbers are unquoted; json_field above only reads
// quoted strings).
uint64_t json_num_field(const std::string& body, const std::string& key) {
  std::string pat = "\"" + key + "\"";
  size_t p = body.find(pat);
  if (p == std::string::npos) return 0;
  p = body.find(':', p + pat.size());
  if (p == std::string::npos) return 0;
  p = body.find_first_not_of(" \t", p + 1);
  if (p == std::string::npos) return 0;
  return strtoull(body.c_str() + p, nullptr, 10);
}

using Fire = std::function<void()>;
using FireList = std::vector<Fire>;

bool tags_match(uint64_t stag, uint64_t rtag, uint64_t rmask) {
  return (stag & rmask) == (rtag & rmask);
}

// ------------------------------------------------------------- matcher

struct PostedRecv {
  uint8_t* buf = nullptr;
  uint64_t cap = 0;
  uint64_t tag = 0, mask = 0;
  sw_recv_cb done = nullptr;
  sw_fail_cb fail = nullptr;
  void* ctx = nullptr;
  bool claimed = false;
  double t_post = mono_s();  // swpulse recv_wait_us origin (§25)
};

struct InboundMsg {
  uint64_t tag = 0, length = 0, received = 0;
  std::vector<uint8_t> spill;  // unexpected-path buffer
  bool use_spill = false;
  PostedRecv pr{};  // valid iff has_pr
  bool has_pr = false;
  bool complete = false;
  bool discard = false;
  // devpull descriptor record: the payload lives on the sender's transfer
  // server; the embedder pulls it.  Queued in `unexpected` so matching
  // stays FIFO with staged DATA on the same tag (one queue, one contract
  // with core/matching.py).  remote_ready = the embedder's eager pull
  // landed (payload resident HERE): the record then survives the sender's
  // death, exactly like a complete staged message would.
  bool remote = false, remote_ready = false;
  uint64_t remote_id = 0, remote_conn = 0;
  // §18 rendezvous (RTS/CTS) record: like a devpull descriptor, but the
  // engine itself answers CTS and streams the payload (no embedder).
  // rts_started = CTS issued (assembly registered).
  bool rts = false, rts_started = false;
  // §18 flow-control debt: a spilled unexpected message remembers its
  // origin conn + incarnation generation + payload bytes so the grant
  // returns the moment the memory is released (Matcher::fc_release).
  uint64_t fc_conn = 0, fc_gen = 0, fc_bytes = 0;
  double born = mono_s();  // swpulse stall-unexp age origin (§25)
};

struct FcGrant {
  uint64_t conn_id = 0, gen = 0, bytes = 0;
};

struct Matcher {
  std::deque<PostedRecv> posted;
  std::deque<InboundMsg*> unexpected;
  std::unordered_set<InboundMsg*> inflight;
  // swtrace observability: set once by the owning Worker before the engine
  // starts.  Ring appends are lock-free data writes -- legal under mu.
  TraceRing* ring = nullptr;
  Counters* ctr = nullptr;
  Hists* hst = nullptr;  // swpulse (§25): relaxed bumps, legal under mu

  // swpulse (§25): post -> delivery latency of a completed receive.
  void pulse_wait(const PostedRecv& pr) {
    if (hst) hbump(hst->recv_wait_us, (uint64_t)((mono_s() - pr.t_post) * 1e6));
  }
  // §18 flow control: total spilled unexpected payload bytes (the
  // STARWAY_UNEXP_BYTES cap surface) plus the grant/CTS work the engine
  // thread drains each pass (conn TX is engine territory; matcher paths
  // run under mu, possibly on app threads).
  uint64_t unexp_bytes = 0;
  std::vector<FcGrant> pending_grants;
  std::vector<InboundMsg*> fc_cts;

  void fc_track(InboundMsg* m, uint64_t conn_id, uint64_t gen, uint64_t n) {
    m->fc_conn = conn_id;
    m->fc_gen = gen;
    m->fc_bytes = n;
    unexp_bytes += n;
  }

  // The spilled message's bytes left the unexpected queue: queue the
  // grant for the engine thread.  Idempotent; caller holds mu.
  void fc_release(InboundMsg* m) {
    if (!m->fc_bytes) return;
    uint64_t n = m->fc_bytes;
    m->fc_bytes = 0;
    unexp_bytes = unexp_bytes > n ? unexp_bytes - n : 0;
    pending_grants.push_back(FcGrant{m->fc_conn, m->fc_gen, n});
  }

  void rec(const char* ev, uint64_t tag, uint64_t nbytes,
           const char* reason = nullptr) {
    if (ring) ring->rec(ev, tag, 0, nbytes, reason);
  }
  // devpull claim outcome of a post_recv: reported to the caller (sw_recv
  // marshals it through the engine op queue so a claim can never be
  // observed by the embedder before the descriptor that created the
  // record -- descriptor fires run on the engine thread).
  struct RemoteClaim {
    bool has = false;
    uint64_t rid = 0, rctx = 0;
    int flags = 0;  // 0 claimed, 1 truncated
  };

  ~Matcher() {
    for (auto* m : unexpected) delete m;
  }

  void post_recv(const PostedRecv& pr_in, FireList& fires,
                 RemoteClaim* claim = nullptr) {
    for (auto it = unexpected.begin(); it != unexpected.end(); ++it) {
      InboundMsg* m = *it;
      if (!m->has_pr && !m->discard && tags_match(m->tag, pr_in.tag, pr_in.mask)) {
        if (m->rts && !m->complete) {
          // §18 rendezvous offer: keep the receive ATTACHED to the
          // record (unlike the devpull claim, which surfaces to the
          // embedder) and let the engine thread answer CTS.
          unexpected.erase(it);
          inflight.insert(m);
          if (m->length > pr_in.cap) {
            // Too-small receive: fail it now; the record still drains
            // via CTS so the sender's pin and flush barriers release.
            m->discard = true;
            fc_cts.push_back(m);
            rec(kEvOpFail, pr_in.tag, 0, kTruncated);
            auto fail = pr_in.fail; auto ctx = pr_in.ctx;
            fires.push_back([fail, ctx] { fail(ctx, kTruncated); });
            return;
          }
          m->pr = pr_in;
          m->pr.claimed = true;
          m->has_pr = true;
          fc_cts.push_back(m);
          rec(kEvRecvMatch, m->tag, m->length);
          return;
        }
        if (m->remote) {
          // Descriptor record: consume it and report the claim to the
          // caller (which marshals it to the embedder).  Too-small
          // receives fail here exactly like an oversized staged message.
          bool trunc = m->length > pr_in.cap;
          if (claim) {
            claim->has = true;
            claim->rid = m->remote_id;
            claim->rctx = trunc ? 0 : (uint64_t)(uintptr_t)pr_in.ctx;
            claim->flags = trunc ? 1 : 0;
          }
          uint64_t mtag = m->tag, mlen = m->length;
          unexpected.erase(it);
          delete m;
          if (trunc) {
            rec(kEvOpFail, pr_in.tag, 0, kTruncated);
            auto fail = pr_in.fail; auto ctx = pr_in.ctx;
            fires.push_back([fail, ctx] { fail(ctx, kTruncated); });
          } else {
            rec(kEvRecvMatch, mtag, mlen);
          }
          return;
        }
        if (m->length > pr_in.cap) {
          unexpected.erase(it);
          fc_release(m);
          if (!m->complete) { m->discard = true; } else { delete m; }
          rec(kEvOpFail, pr_in.tag, 0, kTruncated);
          auto fail = pr_in.fail; auto ctx = pr_in.ctx;
          fires.push_back([fail, ctx] { fail(ctx, kTruncated); });
          return;
        }
        if (m->complete) {
          memcpy(pr_in.buf, m->spill.data(), m->length);
          uint64_t t = m->tag, n = m->length;
          unexpected.erase(it);
          fc_release(m);
          delete m;
          rec(kEvRecvMatch, t, n);
          rec(kEvRecvDone, t, n);
          if (ctr) bump(ctr->recvs_completed);
          pulse_wait(pr_in);
          auto done = pr_in.done; auto ctx = pr_in.ctx;
          fires.push_back([done, ctx, t, n] { done(ctx, t, n); });
          return;
        }
        m->pr = pr_in;
        m->pr.claimed = true;
        m->has_pr = true;  // copied from spill at completion
        rec(kEvRecvMatch, m->tag, m->length);
        return;
      }
    }
    posted.push_back(pr_in);
  }

  // Reserved probe tag ("SW_PROBE"): consumed and dropped on arrival, never
  // queued, never matched -- live link probing (perf.autocalibrate) cannot
  // pollute matching state.  Contract shared with core/matching.py.
  static constexpr uint64_t kProbeTag = 0x53575F50524F4245ull;

  // A devpull descriptor arrived: match like on_start would, or queue a
  // remote record in the (FIFO) unexpected stream.  Returns 1 claimed
  // (*out_ctx = the removed receive's ctx), -1 matched-but-truncated
  // (*out_ctx set; the CALLER fires the failure, outside locks), 0 queued.
  int on_remote(uint64_t tag, uint64_t nbytes, uint64_t remote_id,
                uint64_t conn_id, uint64_t* out_ctx) {
    for (auto it = posted.begin(); it != posted.end(); ++it) {
      if (it->claimed || !tags_match(tag, it->tag, it->mask)) continue;
      *out_ctx = (uint64_t)(uintptr_t)it->ctx;
      int rc = nbytes > it->cap ? -1 : 1;
      if (rc == 1) rec(kEvRecvMatch, tag, nbytes);
      else rec(kEvOpFail, tag, nbytes, kTruncated);
      posted.erase(it);
      return rc;
    }
    auto* m = new InboundMsg();
    m->tag = tag;
    m->length = nbytes;
    m->remote = true;
    m->remote_id = remote_id;
    m->remote_conn = conn_id;
    unexpected.push_back(m);
    return 0;
  }

  // The conn a remote record came from died: records whose payload has
  // not landed can never be pulled and must not eat future receives.
  // Ready records (payload already resident at the receiver) survive,
  // like complete staged messages do -- one contract with the Python
  // engine's peer-death sweep.
  void purge_remote_conn(uint64_t conn_id) {
    // Scrub queued CTS work for the dead conn first: some of its records
    // are deleted just below and fc_service must never chase them.
    fc_cts.erase(std::remove_if(fc_cts.begin(), fc_cts.end(),
                                [conn_id](InboundMsg* m) {
                                  return m->remote_conn == conn_id;
                                }),
                 fc_cts.end());
    for (auto it = unexpected.begin(); it != unexpected.end();) {
      if ((*it)->remote && (*it)->remote_conn == conn_id && !(*it)->remote_ready) {
        delete *it;
        it = unexpected.erase(it);
      } else {
        ++it;
      }
    }
  }

  void mark_remote_ready(uint64_t remote_id) {
    for (auto* m : unexpected)
      if (m->remote && m->remote_id == remote_id) {
        m->remote_ready = true;
        return;
      }
  }

  // Header of a streamed message arrived; returns the record.
  InboundMsg* on_start(uint64_t tag, uint64_t length, FireList& fires) {
    auto* m = new InboundMsg();
    m->tag = tag;
    m->length = length;
    if (tag == kProbeTag) {
      m->discard = true;  // bytes drain to scratch, nothing is queued
      return m;
    }
    inflight.insert(m);
    for (auto it = posted.begin(); it != posted.end(); ++it) {
      if (!it->claimed && tags_match(tag, it->tag, it->mask)) {
        if (length > it->cap) {
          auto fail = it->fail; auto ctx = it->ctx;
          posted.erase(it);
          rec(kEvOpFail, tag, length, kTruncated);
          fires.push_back([fail, ctx] { fail(ctx, kTruncated); });
          m->discard = true;
          return m;
        }
        m->pr = *it;
        m->pr.claimed = true;
        m->has_pr = true;
        posted.erase(it);
        rec(kEvRecvMatch, tag, length);
        return m;  // streams straight into pr.buf
      }
    }
    m->use_spill = true;
    m->spill.resize(length);
    unexpected.push_back(m);
    return m;
  }

  void on_complete(InboundMsg* m, FireList& fires) {
    m->complete = true;
    inflight.erase(m);
    if (m->discard) {
      delete m;
      return;
    }
    if (m->has_pr) {
      if (m->use_spill) {
        memcpy(m->pr.buf, m->spill.data(), m->length);
        for (auto it = unexpected.begin(); it != unexpected.end(); ++it)
          if (*it == m) { unexpected.erase(it); break; }
        fc_release(m);
      }
      auto done = m->pr.done; auto ctx = m->pr.ctx;
      uint64_t t = m->tag, n = m->length;
      rec(kEvRecvDone, t, n);
      if (ctr) bump(ctr->recvs_completed);
      pulse_wait(m->pr);
      fires.push_back([done, ctx, t, n] { done(ctx, t, n); });
      delete m;
      return;
    }
    // stays in unexpected until claimed (spill holds the payload)
  }

  // A deadline expired on a posted receive (identified by its ctx cookie):
  // withdraw it and fail it with the stable "timed out" reason.  Returns
  // false when the receive already settled (no-op).  A receive claimed
  // mid-stream is detached: the partial is discarded (remaining bytes drain
  // to the conn's scratch buffer) so the caller's buffer is immediately
  // repostable -- the purge_inflight discipline.
  bool expire_recv(void* ctx, FireList& fires) {
    for (auto it = posted.begin(); it != posted.end(); ++it) {
      if (it->ctx == ctx) {
        auto fail = it->fail; auto c = it->ctx;
        rec(kEvOpFail, it->tag, 0, kTimedOut);
        if (ctr) bump(ctr->ops_timed_out);
        posted.erase(it);
        fires.push_back([fail, c] { fail(c, kTimedOut); });
        return true;
      }
    }
    for (auto* m : inflight) {
      if (m->has_pr && m->pr.ctx == ctx && !m->complete) {
        auto fail = m->pr.fail; auto c = m->pr.ctx;
        rec(kEvOpFail, m->tag, m->length, kTimedOut);
        if (ctr) bump(ctr->ops_timed_out);
        detach_claimed(m);
        fires.push_back([fail, c] { fail(c, kTimedOut); });
        return true;
      }
    }
    return false;
  }

  // Fail every pending posted receive (queued or claimed mid-stream) with
  // `reason`, leaving complete unexpected messages intact.  The liveness
  // sweep runs this when the last alive conn expires.
  void fail_pending(const std::string& reason, FireList& fires) {
    for (auto& pr : posted) {
      auto fail = pr.fail; auto ctx = pr.ctx;
      rec(kEvOpFail, pr.tag, 0, reason.c_str());
      fires.push_back([fail, ctx, reason] { fail(ctx, reason.c_str()); });
    }
    posted.clear();
    for (auto* m : std::vector<InboundMsg*>(inflight.begin(), inflight.end())) {
      if (m->has_pr && !m->complete) {
        auto fail = m->pr.fail; auto ctx = m->pr.ctx;
        rec(kEvOpFail, m->tag, m->length, reason.c_str());
        detach_claimed(m);
        fires.push_back([fail, ctx, reason] { fail(ctx, reason.c_str()); });
      }
    }
  }

  // Detach a mid-stream claim: the record becomes an ownerless discard
  // (bytes drain to scratch; on_complete frees it; cancel_all's !use_spill
  // path frees it if the stream never finishes).
  void detach_claimed(InboundMsg* m) {
    m->has_pr = false;
    m->discard = true;
    if (m->use_spill) {
      for (auto it = unexpected.begin(); it != unexpected.end(); ++it)
        if (*it == m) { unexpected.erase(it); break; }
      m->use_spill = false;
      fc_release(m);
    }
  }

  // §18 rendezvous announcement arrived: match a posted receive (keep it
  // attached -- the engine CTSes), or queue the record FIFO with staged
  // traffic.  Returns true when the caller should CTS now (claimed, or
  // matched-but-truncated and draining).
  bool on_rts(InboundMsg* m, FireList& fires) {
    for (auto it = posted.begin(); it != posted.end(); ++it) {
      if (it->claimed || !tags_match(m->tag, it->tag, it->mask)) continue;
      if (m->length > it->cap) {
        auto fail = it->fail; auto ctx = it->ctx;
        posted.erase(it);
        rec(kEvOpFail, m->tag, m->length, kTruncated);
        fires.push_back([fail, ctx] { fail(ctx, kTruncated); });
        m->discard = true;
        inflight.insert(m);
        return true;  // drain-CTS: sender pin + flush must still release
      }
      m->pr = *it;
      m->pr.claimed = true;
      m->has_pr = true;
      posted.erase(it);
      inflight.insert(m);
      rec(kEvRecvMatch, m->tag, m->length);
      return true;
    }
    unexpected.push_back(m);
    return false;
  }

  void purge_inflight(InboundMsg* m) {
    if (m->complete) return;
    m->discard = true;
    inflight.erase(m);
    fc_release(m);
    if (!m->has_pr) {
      for (auto it = unexpected.begin(); it != unexpected.end(); ++it)
        if (*it == m) { unexpected.erase(it); break; }
      delete m;
    }
    // claimed partial: pr stays pending forever (peer-death semantics);
    // record deleted at close.
  }

  void cancel_all(FireList& fires) {
    for (auto& pr : posted) {
      auto fail = pr.fail; auto ctx = pr.ctx;
      rec(kEvOpFail, pr.tag, 0, kCancelled);
      if (ctr) bump(ctr->ops_cancelled);
      fires.push_back([fail, ctx] { fail(ctx, kCancelled); });
    }
    posted.clear();
    for (auto* m : inflight) {
      if (m->has_pr && !m->complete) {
        auto fail = m->pr.fail; auto ctx = m->pr.ctx;
        rec(kEvOpFail, m->tag, m->length, kCancelled);
        if (ctr) bump(ctr->ops_cancelled);
        fires.push_back([fail, ctx] { fail(ctx, kCancelled); });
      }
      if (!m->use_spill) delete m;  // spill-owned records freed below
      else m->discard = true;
    }
    inflight.clear();
    for (auto* m : unexpected) delete m;
    unexpected.clear();
    unexp_bytes = 0;  // close wipes the queue; grants/CTS are moot
    pending_grants.clear();
    fc_cts.clear();
  }
};

// ----------------------------------------------------------------- conn

// Multi-rail striping (DESIGN.md §17; core/lane.py is the Python twin).
// One StripeSrc per striped outgoing message: the payload is BORROWED and
// pinned (release callback deferred) until the receiver's T_SACK --
// chunks may be resent after a rail death or session resume, so the
// bytes must stay stable.
struct StripeSrc {
  uint64_t msg_id = 0, tag = 0, total = 0, chunk = 0;
  double t_post = mono_s();  // swpulse (§25): send_local_us/pin_us origin
  const uint8_t* payload = nullptr;
  std::deque<uint64_t> pending;  // unclaimed chunk offsets, FIFO
  // Per-lane chunk ledgers, kept until SACK so a dead rail's share can
  // be re-queued: offsets IN FLIGHT on the lane (claimed, not fully
  // written) vs already WRITTEN to its transport -- the split keeps
  // `unwritten` exact across a resteal.
  std::unordered_map<uint64_t, std::vector<uint64_t>> rail_offs;  // in flight
  std::unordered_map<uint64_t, std::vector<uint64_t>> done_offs;  // written
  uint64_t unwritten = 0;
  int writers = 0;  // feeders currently mid-frame on this source
  bool local_done = false, counted = false, sacked = false, failed = false;
  sw_done_cb done = nullptr;
  sw_fail_cb fail = nullptr;
  void* ctx = nullptr;
  sw_done_cb release = nullptr;
  void* release_ctx = nullptr;

  uint64_t chunk_len(uint64_t off) const {
    uint64_t left = total - off;
    return left < chunk ? left : chunk;
  }
  bool started() const {
    return local_done || !rail_offs.empty() || !done_offs.empty();
  }
};

using StripeRef = std::shared_ptr<StripeSrc>;

// Receiver-side reassembly of one striped message: the matcher's record
// plus the offset-dedup set that makes chunks idempotent.
struct StripeAsm {
  uint64_t msg_id = 0, tag = 0, total = 0, received = 0;
  InboundMsg* msg = nullptr;
  // Probe-tag records live in no matcher queue (see the T_DATA dispatch
  // rx_msg_unowned twin): this assembly owns the msg at teardown.
  bool msg_unowned = false;
  std::unordered_set<uint64_t> offs;
};

constexpr size_t kStripeDoneLru = 4096;

struct TxItem {
  std::vector<uint8_t> header;
  const uint8_t* payload = nullptr;
  uint64_t paylen = 0;
  uint64_t off = 0;
  uint64_t tag = 0;  // data items only (the §18 RTS re-announce needs it)
  bool is_data = false;
  bool rndv = false;
  bool local_done = false;
  sw_done_cb done = nullptr;
  sw_fail_cb fail = nullptr;
  void* ctx = nullptr;
  // Fired exactly once when the engine is finished with `payload` (fully
  // written OR cancelled): the buffer-keepalive signal.  Rendezvous sends
  // complete `done` at header-write while the payload keeps streaming, so
  // `done` must NOT be the release point.
  sw_done_cb release = nullptr;
  void* release_ctx = nullptr;
  // The sm transport switch point (the HELLO_ACK): once this item finishes
  // writing to the socket, TX flips to the ring -- items queued behind it
  // ride the ring even while this one is still draining.
  bool switch_after = false;
  // --- session layer (Conn::sess) ---
  bool counted = false;       // sends_completed recorded (replay can't re-count)
  uint64_t e2e_ord = 0;       // swscope wire ordinal (assigned at first full TX)
  uint64_t sess_seq = 0;      // sequence number (0 = unframed)
  uint64_t sess_nbytes = 0;   // journal accounting (prefix + header + payload)
  std::vector<uint8_t> owned; // eager payload snapshot (the user may reuse
  //                             the buffer once done fires; a replay must
  //                             resend the originally-promised bytes)
  bool hold_release = false;  // rndv payload pinned until the peer ACKs
  // --- multi-rail striping (DESIGN.md §17) ---
  // Nonnull = this item is a lane's FEEDER: it streams one chunk frame,
  // then refills in place with the next chunk the group hands it
  // (completion-driven work stealing).  The SOURCE owns the op callbacks.
  StripeRef stripe;
  uint64_t stripe_off = 0;    // payload offset of the current chunk
  double stripe_t0 = 0;       // claim timestamp (lane throughput EWMA)
  // --- swpulse (DESIGN.md §25) ---
  // Creation stamp for the send_local_us distribution (0 = not a tagged
  // data submission), park stamp for park_us (0 = never parked).
  double t_post = 0;
  double t_park = 0;
  // --- MSG_ZEROCOPY TX (DESIGN.md §24) ---
  // Kernel page pins outstanding on this payload: MSG_ZEROCOPY shares
  // the user pages with the NIC/loopback skbs, so `release` (= the user
  // may reuse the buffer) must wait for the errqueue notification --
  // reusing earlier would put the NEW bytes on the wire.
  uint32_t zc_pins = 0;
  bool zc_deferred = false;   // release requested while pins outstanding

  uint64_t total() const { return header.size() + paylen; }
};

using TxRef = std::shared_ptr<TxItem>;

// `force` overrides a session journal's payload pin (hold_release):
// teardown paths are terminal, so the buffer is released regardless.
// A §24 kernel zerocopy pin (zc_pins) also defers the release -- the
// errqueue completion re-fires it -- but yields to `force` too: on
// teardown the fd is closing, so in-flight shared pages can at worst
// put stale bytes on a dead socket, never complete a receive.
void fire_release(TxItem& item, FireList& fires, bool force = false) {
  if (item.is_data && item.release && (force || !item.hold_release)) {
    if (item.zc_pins && !force) {
      item.zc_deferred = true;
      return;
    }
    auto rel = item.release; auto rctx = item.release_ctx;
    item.release = nullptr;
    fires.push_back([rel, rctx] { rel(rctx); });
  }
}

// Resilient-session state (the C++ twin of core/session.py SessionState):
// everything that must survive a connection incarnation.  Negotiated via
// the "sess"/"sess_id"/"sess_epoch"/"sess_ack" handshake keys; wire half
// is T_SEQ/T_ACK (frames.py).  See DESIGN.md §14.
struct Session {
  std::string id, epoch;
  uint64_t journal_cap = 16u << 20;
  double grace = 30.0;
  // tx
  uint64_t tx_seq = 0;
  std::deque<TxRef> journal;  // framed, unacked items in seq order
  uint64_t journal_bytes = 0;
  std::deque<TxRef> waiting;  // unframed items parked by backpressure
  uint64_t peer_acked = 0;
  // rx
  uint64_t rx_cum = 0;     // highest in-order seq fully processed
  uint64_t acked_sent = 0; // last cumulative ACK put on the wire
  // lifecycle
  bool suspended = false, expired = false;
  Clock::time_point deadline{};  // resume deadline while suspended
  int attempt = 0;               // client redial backoff counter
};

struct Conn {
  uint64_t id = 0;
  int fd = -1;
  bool alive = true;
  bool handshaken = false;
  bool want_write = false;
  std::string peer_name, mode = "socket";
  std::string local_addr, remote_addr;
  int local_port = 0, remote_port = 0;
  std::deque<TxRef> tx;
  // §24 swfast (all dark unless the envs armed them at worker start)
  bool in_uring_q = false;    // queued for this pass's batched submit
  int8_t zc_state = 0;        // 0 unknown, 1 SO_ZEROCOPY armed, -1 refused
  bool zc_skip_once = false;  // ENOBUFS fallback: next pass copies
  uint32_t zc_next_seq = 0;   // kernel's per-socket zerocopy seq counter
  // (seq, item) in send order; the TxRef is the real kernel-pin -- it
  // keeps the payload (or its session snapshot) alive until notified.
  std::deque<std::pair<uint32_t, TxRef>> zc_outstanding;
  // session layer (nullptr on seed-parity conns: every hook below is one
  // null check)
  std::unique_ptr<Session> sess;
  uint64_t sess_pending = 0;   // seq announced by the last T_SEQ
  bool sess_drop = false;      // next frame is a duplicate: drain + drop
  uint64_t rx_skip = 0;        // dup-frame payload bytes left to drain
  bool sess_ack_armed = false; // idle ACK timer outstanding
  const char* sess_fail = nullptr;  // flush-failure override at expiry
  // rx parser
  uint8_t hdr[HEADER_SIZE];
  size_t hdr_got = 0;
  int ctl_type = 0;
  std::string ctl_body;
  size_t ctl_need = 0;
  InboundMsg* rx_msg = nullptr;
  // rx_msg is a probe record the matcher does not own (see T_DATA dispatch).
  bool rx_msg_unowned = false;
  // devpull extension (sw_engine.h): negotiated in the handshake; pending =
  // surfaced descriptors not yet resolved by the embedder; deferred acks
  // hold (flush seq, snapshot of pending at barrier arrival).
  bool devpull_ok = false;
  // The peer's "cudaipc" value when the pull was negotiated.
  std::string cudaipc_peer;
  // Peer-liveness keepalive (negotiated "ka": "ok"); last_rx is proof of
  // life -- any inbound bytes (stream, ring, or doorbell) refresh it.
  bool ka_ok = false;
  Clock::time_point last_rx = Clock::now();
  // swscope (DESIGN.md §15): negotiated trace-conn id ("tr" handshake
  // key; empty = dark), per-direction wire ordinals pairing EV_E2E
  // events across processes, and the best clock-offset estimate from
  // timestamped PING/PONG samples (peer ~= local + offset).
  char tr_hex[17] = {0};
  uint64_t tx_e2e = 0, rx_e2e = 0;
  int64_t clock_off_us = 0;
  uint64_t clock_err_us = 0;  // 0 = no sample yet
  uint64_t ctl_a = 0;  // header `a` of the ctl frame being accumulated
  std::unordered_set<uint64_t> devpull_pending;
  std::vector<std::pair<uint64_t, std::unordered_set<uint64_t>>> devpull_deferred;
  std::vector<uint8_t> scratch;
  // flush accounting
  uint64_t flush_seq = 0, flush_acked = 0, data_counter = 0;
  std::unordered_map<uint64_t, uint64_t> flush_marks;
  bool dirty = false;
  // shared-memory upgrade state (mirrors core/conn.py): sm_active switches
  // RX to the ring; tx_via_ring flips once pre-switch TCP bytes (the
  // HELLO_ACK) have drained, so stream bytes never interleave transports.
  SmSegment* sm = nullptr;
  SmRing sm_tx{}, sm_rx{};
  bool sm_active = false;
  bool sm_negotiated = false;  // sticky: survives teardown for introspection
  bool tx_via_ring = false;
  // Doorbell bytes that hit a full socket buffer: flushed on EPOLLOUT.  A
  // starving byte is the only wakeup a ring-blocked producer gets, so
  // doorbells are queued, never dropped.
  std::string db_out;
  // --- multi-rail striping (DESIGN.md §17; core/lane.py is the twin) ---
  std::vector<uint64_t> rails;  // secondary conn ids (primary only)
  uint64_t rail_parent = 0;     // primary conn id (secondary only)
  bool rails_ok = false;        // "rails" negotiated on the primary
  bool feeder_live = false;     // this lane's feeder item is queued
  // Per-lane delivered-throughput EWMA (one update per completed chunk;
  // 0 = no data yet) + tail steals declined under STARWAY_STRIPE_WEIGHTED.
  double stripe_ewma_bps = 0;
  uint64_t stripe_tail_declines = 0;
  // TX scheduler (primary only): sources FIFO + id registry until SACK.
  uint64_t next_stripe_msg = 1;
  std::deque<StripeRef> stripe_q;
  std::unordered_map<uint64_t, StripeRef> stripe_by_id;
  // RX reassembly (primary only) + completed-id LRU for late resends.
  std::unordered_map<uint64_t, StripeAsm*> stripe_asm;
  std::deque<uint64_t> stripe_done_fifo;
  std::unordered_set<uint64_t> stripe_done;
  // Per-rail striped rx parser state.
  bool sdata_active = false;
  uint8_t sdata_sub[SDATA_SUB_SIZE];
  size_t sdata_got = 0;
  uint64_t sdata_tag = 0, sdata_len = 0;
  StripeAsm* rx_stripe = nullptr;
  uint64_t rx_stripe_off = 0, rx_stripe_len = 0, rx_stripe_got = 0;
  // --- §18 receiver-driven flow control (core/conn.py is the twin) ---
  // Sender half: fc_window = the PEER's advertised budget, fc_credits
  // the signed remainder (negative only via the one-oversized-frame
  // admission), fc_waiting the unframed FIFO of parked sends, fc_rts
  // the announced-but-unSACKed rendezvous sends (payload pinned until
  // SACK).  Receiver half: fc_unexp = outstanding (un-granted) spill
  // bytes, fc_rx_gen the incarnation generation orphaning stale grants
  // across a resume, fc_rx the un-completed inbound RTS records.
  bool fc_ok = false;
  uint64_t fc_window = 0;
  int64_t fc_credits = 0;
  std::deque<TxRef> fc_waiting;
  struct FcRts {
    TxRef item;
    bool announced = true;  // false once the CTS dispatched it into tx
    uint64_t tag = 0;
  };
  std::unordered_map<uint64_t, FcRts> fc_rts;
  uint64_t fc_next_msg = 1;
  uint64_t fc_unexp = 0, fc_rx_gen = 0;
  std::unordered_map<uint64_t, InboundMsg*> fc_rx;
  uint64_t unexp_cap = 0;
  // --- §19 integrity plane (core/conn.py is the twin) ---
  // csum_ok arms TX framing + RX verification; poison overrides the
  // cancel reason at terminal teardown ("corrupt"); csum_pend/f/h/accum
  // are the RX verification state for the frame announced by the last
  // T_CSUM; retx_offs tracks NACK-requeued chunks until rewritten (the
  // `retx_pending` gauge, primary conns only).
  bool csum_ok = false;
  const char* poison = nullptr;
  bool csum_pend = false;
  uint32_t csum_f = 0, csum_h = 0, csum_accum = 0;
  std::set<std::pair<uint64_t, uint64_t>> retx_offs;

  bool has_unfinished_data() const {
    for (auto& t : tx) {
      if (t->is_data && t->off < t->total()) return true;
      if (t->stripe && t->off < t->total()) return true;
    }
    return false;
  }

  void adopt_sm(SmSegment* seg, bool creator, bool defer_tx) {
    sm = seg;
    seg->tx_rx(creator, &sm_tx, &sm_rx);
    if (csum_ok) {
      // §19: the rings carry checksummed slot records from the first
      // byte (both sides decided at handshake, before any ring traffic).
      sm_tx.slotted = true;
      sm_rx.slotted = true;
    }
    sm_active = true;
    sm_negotiated = true;
    seg->unlink();
    if (!defer_tx) {
      if (tx.empty()) tx_via_ring = true;
      else tx.back()->switch_after = true;  // pre-switch items drain first
    }
  }

  void drop_sm() {
    if (sm) {
      sm->unlink();
      delete sm;
      sm = nullptr;
      sm_active = false;
      tx_via_ring = false;
    }
  }

  ~Conn() {
    drop_sm();
    for (auto& [id, a] : stripe_asm) delete a;
  }
};

struct FlushRec {
  sw_done_cb done = nullptr;
  sw_fail_cb fail = nullptr;
  void* ctx = nullptr;
  std::unordered_map<uint64_t, uint64_t> waits;  // conn_id -> seq
  // Striped delivery rides SACKs, not per-rail FLUSH frames: the barrier
  // also waits until every source with msg_id <= watermark is SACKed
  // (primary conn id -> watermark; DESIGN.md §17).
  std::unordered_map<uint64_t, uint64_t> stripe_waits;
  bool completed = false;
  double born = mono_s();  // swpulse flush_us origin + stall-flush age (§25)
};

// ------------------------------------------------------------------ ops

// sw_gauges rendezvous: the calling thread parks on the condvar while the
// engine thread renders the snapshot.  Gauges are computed from live
// engine-owned state (tx queues, journals, rx parser), so marshaling one
// op beats maintaining lock-free shadow copies of every queue -- and the
// off path stays untouched.  Heap-held via shared_ptr: a timed-out caller
// may return before the engine signals, and the op must not dangle.
struct GaugesWait {
  std::mutex m;
  std::condition_variable cv;
  bool done = false;
  std::string json;
};

struct Op {
  enum Kind { SEND, FLUSH, SEND_DEVPULL, DEVPULL_RESOLVED,
              DEVPULL_CLAIM, DEVPULL_PURGE, GAUGES } kind;
  uint64_t conn_id = 0;       // SEND target; FLUSH: 0 = all conns
  bool conn_scoped = false;   // FLUSH limited to conn_id
  const uint8_t* buf = nullptr;
  uint64_t len = 0, tag = 0;
  sw_done_cb done = nullptr;
  sw_recv_cb rdone = nullptr;
  sw_fail_cb fail = nullptr;
  void* ctx = nullptr;
  sw_done_cb release = nullptr;
  void* release_ctx = nullptr;
  std::string body;     // SEND_DEVPULL descriptor JSON
  uint64_t msg_id = 0;  // DEVPULL_RESOLVED / _CLAIM / _PURGE: remote id
  uint64_t rctx = 0;    // DEVPULL_CLAIM: claimed receive's registry ctx
  int flags = 0;        // DEVPULL_CLAIM: 0 claimed, 1 truncated
  std::shared_ptr<GaugesWait> gwait;  // GAUGES: rendezvous with the caller
};

// --------------------------------------------------------------- worker

// One armed op deadline.  Identified by the op's ctx cookie (unique per op:
// the Python registry key).  Settled ops leave their timer behind; it fires
// as a no-op (the cookie matches nothing).
struct Timer {
  Clock::time_point when;
  // SESS_* timers carry a conn id (not an op cookie) in ctx: the idle
  // cumulative-ACK flush, the session grace deadline, and the client's
  // backoff redial tick (DESIGN.md §14).
  enum Kind { SEND, RECV, FLUSH, SESS_ACK, SESS_GRACE, SESS_REDIAL } kind;
  void* ctx = nullptr;
};

struct Worker {
  std::mutex mu;
  std::atomic<int> status{ST_VOID};
  std::atomic<int> refs{1};  // python handle; engine thread takes one more
  // Resilient sessions (DESIGN.md §14): sess_id -> conn.  Server side:
  // suspended conns wait here for the peer's resume dial (sess_hello).
  std::unordered_map<std::string, Conn*> sessions;
  // Engine-event callback (sw_set_event_cb): session resume/expiry
  // notifications for the wrapper's flight recorder.
  sw_event_cb event_cb = nullptr;
  void* event_cb_ctx = nullptr;
  // swtrace observability (DESIGN.md §13): counters always live (relaxed
  // atomics); the trace ring armed per worker at creation (env knobs).
  Counters counters;
  TraceRing trace;
  // swpulse (DESIGN.md §25): always-on histograms (relaxed atomics, like
  // the counters) + the opt-in stall sentinel's engine-thread state.
  Hists hists;
  double stall_s = 0;              // threshold seconds (0 = sentinel off)
  Clock::time_point next_stall{};  // next sentinel scan
  uint64_t stall_prog = 0;         // progress sum at the last scan
  // Live alert keys (reason literal, condition id): a condition alerts
  // once until it clears -- the set is rebuilt each scan.
  std::set<std::pair<const void*, uint64_t>> stall_seen;
  int epfd = -1, evfd = -1;
  // §24 swfast lever state: sampled once per worker at engine start.
  // uring.ok() false = epoll core (the default and the probe fallback).
  UringCore uring;
  std::vector<Conn*> uring_q;  // conns with deferred TX this pass
  bool zc_armed = false;
  uint64_t zc_thresh = 0;      // rndv threshold sampled at engine start
  uint64_t busypoll_us = 0;
  std::thread::id engine_tid{};
  std::string worker_id;
  std::deque<Op> ops;
  // Deadline timers (guarded by mu; armed from app threads, fired on the
  // engine thread) + keepalive schedule (engine thread only).
  std::vector<Timer> timers;
  double ka_interval = 0.0;
  int ka_misses = 3;
  Clock::time_point next_ka{};
  std::unordered_map<uint64_t, Conn*> conns;
  std::vector<FlushRec*> flushes;
  Matcher matcher;
  uint64_t next_conn_id = 1;
  sw_done_cb close_done = nullptr;
  void* close_ctx = nullptr;
  bool is_server = false;
  // server bits
  int listen_fd = -1;
  sw_accept_cb accept_cb = nullptr;
  void* accept_ctx = nullptr;
  std::unordered_set<Conn*> half_open;
  // Accept wrappers consumed by a session resume (sess_hello moved their
  // socket onto the suspended conn).  Deleted at the end of the event-loop
  // pass -- the pump that delivered the HELLO still holds the pointer, and
  // parking them in half_open until worker close would leak one Conn per
  // resume on a long-lived server (the Python engine's wrapper just GCs).
  std::vector<Conn*> sess_reap;
  // devpull extension (sw_engine.h)
  bool devpull_advertise = false;
  std::string cudaipc_id;  // this process's "cudaipc" value
  sw_devpull_cb devpull_cb = nullptr;
  sw_devpull_claim_cb devpull_claim_cb = nullptr;
  void* devpull_cb_ctx = nullptr;
  uint64_t next_devpull_msg = 1;
  // client bits
  std::string c_host, c_mode;
  int c_port = 0;
  sw_status_cb c_status_cb = nullptr;
  void* c_status_ctx = nullptr;
  uint64_t primary_conn = 0;

  virtual ~Worker() {
    for (auto& [id, c] : conns) delete c;
    for (auto* f : flushes) delete f;
  }

  void unref() {
    if (refs.fetch_sub(1) == 1) delete this;
  }

  void wake() {
    if (evfd >= 0) {
      uint64_t one = 1;
      ssize_t r = write(evfd, &one, 8);
      (void)r;
    }
  }

  // ---------------------------------------------------------- epoll mgmt
  void ep_add(int fd, uint32_t events, void* ptr) {
    epoll_event ev{};
    ev.events = events;
    ev.data.ptr = ptr;
    epoll_ctl(epfd, EPOLL_CTL_ADD, fd, &ev);
  }

  void ep_mod_conn(Conn* c) {
    epoll_event ev{};
    ev.events = EPOLLIN | (c->want_write ? EPOLLOUT : 0);
    ev.data.ptr = c;
    epoll_ctl(epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }

  void ep_del(int fd) { epoll_ctl(epfd, EPOLL_CTL_DEL, fd, nullptr); }

  // ---------------------------------------------------------- integrity
  // Embed the T_CSUM prefix into one tx item's framed bytes (DESIGN.md
  // §19).  Runs at dispatch, after the item's final wire header exists
  // and BEFORE any session T_SEQ framing, so the wire order is
  // [SEQ][CSUM][frame] and journal replays stay byte-identical.
  // crc_head (`b`) covers the 17-byte header (+ the 24-byte stripe
  // sub-header for T_SDATA); crc_frame (`a`) every byte of the frame.
  static void csum_arm(Conn* c, TxItem& item) {
    if (!c->csum_ok || item.header.empty()) return;
    uint8_t t = item.header[0];
    if (t == T_HELLO || t == T_HELLO_ACK) return;  // handshake: unwrapped
    size_t head_n = HEADER_SIZE;
    if (t == T_SDATA) head_n = HEADER_SIZE + SDATA_SUB_SIZE;
    if (head_n > item.header.size()) head_n = item.header.size();
    uint32_t ch = crc32c(item.header.data(), head_n, 0);
    uint32_t cf = ch;
    if (item.header.size() > head_n)
      cf = crc32c(item.header.data() + head_n, item.header.size() - head_n,
                  cf);
    if (item.payload && item.paylen) cf = crc32c(item.payload, item.paylen, cf);
    std::vector<uint8_t> pre(HEADER_SIZE + item.header.size());
    pack_header(pre.data(), T_CSUM, cf, ch);
    memcpy(pre.data() + HEADER_SIZE, item.header.data(), item.header.size());
    item.header = std::move(pre);
  }

  // Offset of the data frame's own header inside item.header, past any
  // embedded T_SEQ / T_CSUM prefixes (tag extraction for trace events).
  static size_t data_hdr_off(const TxItem& item) {
    size_t off = 0;
    while (off + HEADER_SIZE <= item.header.size() &&
           (item.header[off] == T_SEQ || item.header[off] == T_CSUM))
      off += HEADER_SIZE;
    return off;
  }

  // Unrepairable verification failure: poison the conn with the stable
  // "corrupt" reason.  Without a session this takes the §10 failure
  // contract; with a live one conn_broken suspends instead and the
  // journal replay re-delivers verified bytes exactly-once.
  void conn_corrupt(Conn* c, const char* what, FireList& fires) {
    bump(counters.csum_fail);
    SW_DEBUG("integrity failure on conn %llu: %s", (unsigned long long)c->id,
             what);
    c->poison = kCorrupt;
    if (!c->sess || c->sess->expired) c->sess_fail = kCorrupt;
    conn_broken(c, fires);
  }

  // The receiver NACKed one striped chunk (payload checksum failed with
  // an intact sub-header): re-queue JUST that chunk.  Payloads are
  // pinned until T_SACK, so the resend is always legal; the receiver's
  // offset dedup never recorded the corrupt chunk, so the retransmit
  // streams into the same sink region (core/conn.py _on_snack twin).
  void on_snack(Conn* c, uint64_t msg_id, uint64_t off, FireList& fires) {
    if (c->fc_ok) {
      auto it = c->fc_rts.find(msg_id);
      if (it != c->fc_rts.end()) {
        // §18 rendezvous delivery (one self-describing chunk): the whole
        // frame rides again, exactly like a CTS re-dispatch.
        if (it->second.announced) return;  // not dispatched yet
        TxRef item = it->second.item;
        for (auto& ref : c->tx)
          if (ref == item) return;  // still (re)transmitting
        item->off = 0;
        bump(counters.chunk_retx);
        c->tx.push_back(item);
        kick_tx(c, fires);
        return;
      }
    }
    Conn* root = stripe_root(c);
    auto sit = root->stripe_by_id.find(msg_id);
    if (sit == root->stripe_by_id.end()) return;
    StripeRef src = sit->second;
    if (src->sacked || src->failed || off >= src->total ||
        (src->chunk && off % src->chunk))
      return;  // settled or garbled: a late SACK/redispatch covers it
    if (std::find(src->pending.begin(), src->pending.end(), off) !=
        src->pending.end())
      return;  // duplicate NACK: already queued for resend
    for (auto& [cid, v] : src->rail_offs)
      if (std::find(v.begin(), v.end(), off) != v.end())
        return;  // already back in flight on some lane
    bool removed = false;
    for (auto& [cid, v] : src->done_offs) {
      auto p = std::find(v.begin(), v.end(), off);
      if (p != v.end()) {
        v.erase(p);
        removed = true;
        break;
      }
    }
    if (!removed) return;  // ledger cleared by a resume: redispatch covers
    src->pending.push_back(off);
    src->unwritten++;
    bump(counters.chunk_retx);
    root->retx_offs.insert({msg_id, off});
    bool queued = false;
    for (auto& q : root->stripe_q)
      if (q.get() == src.get()) {
        queued = true;
        break;
      }
    if (!queued) root->stripe_q.push_back(src);
    stripe_dispatch(root, fires);
  }

  // -------------------------------------------------------------- sends
  static void fire_op_release(const Op& op, FireList& fires) {
    if (op.release) {
      auto rel = op.release; auto rctx = op.release_ctx;
      fires.push_back([rel, rctx] { rel(rctx); });
    }
  }

  void conn_send_data(Conn* c, const Op& op, FireList& fires) {
    if (!c->alive) {
      auto fail = op.fail; auto ctx = op.ctx;
      trace.rec(kEvOpFail, op.tag, c->id, op.len,
                "Endpoint is not connected (connection reset)");
      if (fail) fires.push_back([fail, ctx] { fail(ctx, "Endpoint is not connected (connection reset)"); });
      fire_op_release(op, fires);
      return;
    }
    uint64_t sthr = stripe_threshold_env();
    if (!c->rails.empty() && sthr > 0 && op.len >= sthr &&
        stripe_live_lanes(c) > 1) {
      // Striped path (DESIGN.md §17): chunks are idempotent and NOT
      // seq-framed even on session conns -- the group re-dispatches
      // un-SACKed sources wholesale at resume (journal per-message).
      // Striped sends are exempt from the §18 credit window: like the
      // RTS path they are SACK-terminated large transfers
      // (stripe_threshold should sit at or above the rndv threshold
      // when combining the two planes).
      stripe_submit(c, op, fires);
      return;
    }
    auto item = std::make_shared<TxItem>();
    item->t_post = mono_s();  // swpulse send_local_us origin (§25)
    item->header.resize(HEADER_SIZE);
    pack_header(item->header.data(), T_DATA, op.tag, op.len);
    item->payload = op.buf;
    item->paylen = op.len;
    item->tag = op.tag;
    item->is_data = true;
    item->rndv = op.len > rndv_threshold();
    item->done = op.done;
    item->fail = op.fail;
    item->ctx = op.ctx;
    item->release = op.release;
    item->release_ctx = op.release_ctx;
    if (c->fc_ok) {
      fc_send(c, item, fires);
      return;
    }
    csum_arm(c, *item);
    c->dirty = true;
    c->data_counter++;
    if (c->sess) {
      sess_submit(c, item, fires);
      return;
    }
    c->tx.push_back(std::move(item));
    kick_tx(c, fires);
  }

  // -------------------------------------------------------- flow control
  //
  // Receiver-driven credit flow control + the RTS/CTS rendezvous path
  // (DESIGN.md §18; core/conn.py carries the Python twin).  All fc state
  // is engine-thread-owned; the matcher's pending_grants/fc_cts vectors
  // (filled under mu, possibly from app threads) are drained by
  // fc_service each loop pass.

  // Debit the window, or refuse.  A fully-replenished (idle) window
  // always admits one frame even when the payload exceeds it -- the §14
  // journal-backpressure rule: a single oversized payload must block
  // later sends, never deadlock itself.
  static bool fc_admit(Conn* c, uint64_t n) {
    if (c->fc_credits >= (int64_t)n ||
        c->fc_credits >= (int64_t)c->fc_window) {
      c->fc_credits -= (int64_t)n;
      return true;
    }
    return false;
  }

  void fc_dispatch_eager(Conn* c, const TxRef& item, FireList& fires,
                         bool kick = true) {
    csum_arm(c, *item);
    c->dirty = true;
    c->data_counter++;
    if (c->sess) {
      sess_submit(c, item, fires);
      return;
    }
    c->tx.push_back(item);
    if (kick) kick_tx(c, fires);
  }

  // Announce a rendezvous send: the payload stays pinned here
  // (hold_release, the journal-pin mechanism) and travels as ONE
  // self-describing T_SDATA frame only after the receiver's CTS --
  // large transfers never consume window and never spill.  The RTS ctl
  // is per-incarnation (never seq-framed): a resume re-announces every
  // unSACKed entry instead of replaying it.
  void fc_rts_announce(Conn* c, const TxRef& item, FireList& fires) {
    c->dirty = true;
    c->data_counter++;
    uint64_t mid = FC_MSG_BIT | c->fc_next_msg++;
    item->header.resize(HEADER_SIZE + SDATA_SUB_SIZE);
    pack_header(item->header.data(), T_SDATA, item->tag,
                SDATA_SUB_SIZE + item->paylen);
    uint64_t zero = 0;
    memcpy(item->header.data() + HEADER_SIZE, &mid, 8);
    memcpy(item->header.data() + HEADER_SIZE + 8, &zero, 8);
    memcpy(item->header.data() + HEADER_SIZE + 16, &item->paylen, 8);
    item->rndv = true;
    item->hold_release = true;  // pinned until SACK (resend must be legal)
    csum_arm(c, *item);  // covers header+sub-header+payload (§19)
    c->fc_rts[mid] = Conn::FcRts{item, true, item->tag};
    std::string body = "{\"m\": " + std::to_string(mid) +
                       ", \"n\": " + std::to_string(item->paylen) + "}";
    conn_send_ctl(c, T_RTS, item->tag, body.size(), body, fires);
  }

  // send_data on an fc conn: gate eager sends on the peer's window,
  // announce rendezvous sends via RTS.  Once anything is parked,
  // EVERYTHING parks behind it -- FIFO arrival order at the receiver's
  // matcher is part of the matching contract.
  void fc_send(Conn* c, const TxRef& item, FireList& fires) {
    if (!c->fc_waiting.empty()) {
      item->t_park = mono_s();  // swpulse park_us origin (§25)
      c->fc_waiting.push_back(item);
      bump(counters.sends_parked);
      return;
    }
    if (item->rndv) {
      fc_rts_announce(c, item, fires);
      return;
    }
    if (!fc_admit(c, item->paylen)) {
      item->t_park = mono_s();  // swpulse park_us origin (§25)
      c->fc_waiting.push_back(item);
      bump(counters.sends_parked);
      return;
    }
    fc_dispatch_eager(c, item, fires);
  }

  // Move parked sends into dispatch as grants restore the window (FIFO;
  // rendezvous entries pass straight through to RTS).
  void fc_drain_waiting(Conn* c, FireList& fires) {
    bool moved = false;
    while (!c->fc_waiting.empty()) {
      TxRef item = c->fc_waiting.front();
      if (item->local_done) {  // shed by a deadline while parked
        c->fc_waiting.pop_front();
        pulse_unpark(*item);
        continue;
      }
      if (item->rndv) {
        c->fc_waiting.pop_front();
        pulse_unpark(*item);
        fc_rts_announce(c, item, fires);
        moved = true;
        continue;
      }
      if (!fc_admit(c, item->paylen)) break;
      c->fc_waiting.pop_front();
      pulse_unpark(*item);
      fc_dispatch_eager(c, item, fires, /*kick=*/false);
      moved = true;
    }
    if (moved) kick_tx(c, fires);
  }

  // Peer returned window (T_CREDIT): replenish and drain parked sends.
  // Clamped at the advertised window -- a wire-duplicated grant must
  // never mint credit.
  void fc_on_credit(Conn* c, uint64_t n, FireList& fires) {
    if (!c->fc_ok) return;  // stray grant: old peers cannot send it
    c->fc_credits += (int64_t)n;
    if (c->fc_credits > (int64_t)c->fc_window)
      c->fc_credits = (int64_t)c->fc_window;
    fc_drain_waiting(c, fires);
  }

  // Receiver granted the rendezvous: dispatch the pinned payload as its
  // pre-built T_SDATA frame.  A duplicate CTS (resume races) is ignored
  // -- only an announced entry dispatches.
  void fc_on_cts(Conn* c, uint64_t mid, FireList& fires) {
    auto it = c->fc_rts.find(mid);
    if (it == c->fc_rts.end() || !it->second.announced) return;
    it->second.announced = false;
    it->second.item->off = 0;
    c->tx.push_back(it->second.item);
    kick_tx(c, fires);
  }

  // True when this SACK settled a §18 rendezvous send: the entry (and
  // with it the payload pin) drops; the op completed locally at first
  // byte (rndv semantics).
  bool fc_on_sack(Conn* c, uint64_t mid, FireList& fires) {
    auto it = c->fc_rts.find(mid);
    if (it == c->fc_rts.end()) return false;
    fire_release(*it->second.item, fires, /*force=*/true);
    c->fc_rts.erase(it);
    return true;
  }

  // Fresh window per incarnation (DESIGN.md §18): stale debits and grant
  // obligations die with the old transport.  Journal-replayed DATA
  // frames re-debit the fresh window (their replay WILL arrive, and the
  // receiver grants duplicates too -- conservation), unSACKed rendezvous
  // sends re-announce, parked sends re-enter dispatch.
  void fc_reset_resume(Conn* c, FireList& fires) {
    c->fc_rx_gen++;
    c->fc_unexp = 0;
    c->fc_credits = (int64_t)c->fc_window;
    if (c->sess) {
      // Journal-replayed frames AND journal-backpressure-parked frames
      // (sess->waiting) both ship in this incarnation and were admitted
      // pre-suspend: re-debit both, or their wire bytes would
      // oversubscribe the fresh window.
      for (auto& item : c->sess->journal)
        if (item->is_data && item->paylen)
          c->fc_credits -= (int64_t)item->paylen;
      for (auto& item : c->sess->waiting)
        if (item->is_data && item->paylen)
          c->fc_credits -= (int64_t)item->paylen;
    }
    for (auto& [mid, ent] : c->fc_rts) {
      ent.announced = true;
      ent.item->off = 0;
      std::string body = "{\"m\": " + std::to_string(mid) +
                         ", \"n\": " + std::to_string(ent.item->paylen) + "}";
      conn_send_ctl(c, T_RTS, ent.tag, body.size(), body, fires);
    }
    fc_drain_waiting(c, fires);
  }

  // Terminal teardown sweep for fc state: cancel parked and announced
  // sends exactly once (a CTS'd delivery item may also sit in tx --
  // local_done dedupes) and release the pins.
  void fc_cancel_terminal(Conn* c, FireList& fires, const char* reason) {
    auto cancel_item = [&](const TxRef& item) {
      if (item->is_data && !item->local_done && item->fail) {
        item->local_done = true;
        bump(counters.ops_cancelled);
        auto fail = item->fail; auto ctx = item->ctx;
        fires.push_back([fail, ctx, reason] { fail(ctx, reason); });
      }
      fire_release(*item, fires, /*force=*/true);
    };
    for (auto& item : c->fc_waiting) cancel_item(item);
    c->fc_waiting.clear();
    for (auto& [mid, ent] : c->fc_rts) cancel_item(ent.item);
    c->fc_rts.clear();
    c->fc_rx.clear();  // dedup index only; the matcher owns the records
  }

  // §18 rendezvous announcement arrived: register the offer with the
  // matcher (flush deferral and force-start ride the devpull pending
  // machinery); CTS goes out when a receive claims the record.
  // swcheck: state(estab, RTS, estab|down)
  void on_rts(Conn* c, uint64_t tag, const std::string& body,
              FireList& fires) {
    if (!c->fc_ok) return;  // never negotiated: drop
    uint64_t mid = json_num_field(body, "m");
    uint64_t total = json_num_field(body, "n");
    if (!mid) return;
    if (c->stripe_done.count(mid)) {
      // Late re-announcement of a completed message: re-SACK so the
      // sender releases its pin.
      conn_send_ctl(c, T_SACK, mid, total, "", fires);
      return;
    }
    auto known = c->fc_rx.find(mid);
    if (known != c->fc_rx.end()) {
      InboundMsg* m = known->second;
      if (m->rts_started) {
        // The CTS (or the delivery) died with an incarnation; the
        // assembly survived (rts_started is set atomically with its
        // registration) -- just re-CTS.
        conn_send_ctl(c, T_CTS, mid, 0, "", fires);
      } else if (m->has_pr || m->discard) {
        // The CTS hop was consumed by a dead incarnation AFTER a claim
        // (or drain) consumed the record: no future post_recv can
        // re-fire it -- restart on the live conn.
        fc_start_rx(c, m, fires);
      }
      return;
    }
    auto* m = new InboundMsg();
    m->tag = tag;
    m->length = total;
    m->remote = true;
    m->rts = true;
    m->remote_id = mid;
    m->remote_conn = c->id;
    c->devpull_pending.insert(mid);  // flush barriers defer until resolved
    bool cts_now;
    {
      std::lock_guard<std::mutex> g(mu);
      cts_now = matcher.on_rts(m, fires);
    }
    c->fc_rx[mid] = m;
    if (cts_now) fc_start_rx(c, m, fires);
  }

  // Engine-thread half of the CTS: choose the sink, pre-register the
  // assembly under the sender's msg id, answer CTS.  The T_SDATA
  // delivery then streams through the ordinary stripe RX path.
  void fc_start_rx(Conn* c, InboundMsg* m, FireList& fires) {
    if (!c->alive || c->fd < 0 || m->rts_started) return;
    m->rts_started = true;
    if (!m->discard && !m->has_pr) {
      // Force-started by a flush barrier before any receive matched:
      // spill, like a drained devpull (exempt from the window -- the
      // sender's flush asked for residency here).
      m->use_spill = true;
      m->spill.resize(m->length);
    }
    auto* a = new StripeAsm();
    a->msg_id = m->remote_id;
    a->tag = m->tag;
    a->total = m->length;
    a->msg = m;
    c->stripe_asm[a->msg_id] = a;
    conn_send_ctl(c, T_CTS, a->msg_id, 0, "", fires);
  }

  // Drain the matcher's queued fc work (grants from fc_release, CTS
  // requests from app-thread claims) onto conn TX -- once per loop pass.
  void fc_service(FireList& fires) {
    std::vector<FcGrant> grants;
    std::vector<InboundMsg*> cts;
    {
      std::lock_guard<std::mutex> g(mu);
      if (matcher.pending_grants.empty() && matcher.fc_cts.empty()) return;
      grants.swap(matcher.pending_grants);
      cts.swap(matcher.fc_cts);
    }
    for (auto& gr : grants) {
      Conn* c = conn_by_id(gr.conn_id);
      if (!c || gr.gen != c->fc_rx_gen) continue;
      c->fc_unexp = c->fc_unexp > gr.bytes ? c->fc_unexp - gr.bytes : 0;
      if (c->alive && c->fc_ok && c->fd >= 0)
        conn_send_ctl(c, T_CREDIT, gr.bytes, 0, "", fires);
    }
    for (auto* m : cts) {
      Conn* c = conn_by_id(m->remote_conn);
      if (c) fc_start_rx(c, m, fires);
    }
  }

  void conn_send_ctl(Conn* c, uint8_t type, uint64_t a, uint64_t b,
                     const std::string& body, FireList& fires,
                     bool switch_after = false, bool sess_frame = false) {
    if (!c->alive) return;
    // swrefine tx event at the ctl-plane handoff (DESIGN.md §22; data
    // frames are covered by send_post/send_done and the peer's rx side).
    trace.proto_tx(c->id, type);
    auto item = std::make_shared<TxItem>();
    item->header.resize(HEADER_SIZE + body.size());
    pack_header(item->header.data(), type, a, b);
    if (!body.empty()) memcpy(item->header.data() + HEADER_SIZE, body.data(), body.size());
    csum_arm(c, *item);
    item->switch_after = switch_after;
    if (sess_frame && c->sess) {
      // FLUSH / FLUSH_ACK are sequenced session frames: a barrier (or its
      // ack) lost with a conn must replay, or the peer's flush hangs.
      sess_submit(c, item, fires);
      return;
    }
    c->tx.push_back(std::move(item));
    kick_tx(c, fires);
  }

  void conn_send_devpull(Conn* c, const Op& op, FireList& fires) {
    if (!c->alive) {
      auto fail = op.fail; auto ctx = op.ctx;
      trace.rec(kEvOpFail, op.tag, c->id, op.len,
                "Endpoint is not connected (connection reset)");
      if (fail) fires.push_back([fail, ctx] { fail(ctx, "Endpoint is not connected (connection reset)"); });
      return;
    }
    // Counts as tagged data: the sender's flush barrier must cover the
    // pulled payload (the receiver defers the ACK until pulls resolve).
    c->dirty = true;
    c->data_counter++;
    trace.proto_tx(c->id, T_DEVPULL);
    auto item = std::make_shared<TxItem>();
    item->header.resize(HEADER_SIZE + op.body.size());
    pack_header(item->header.data(), T_DEVPULL, op.tag, op.body.size());
    memcpy(item->header.data() + HEADER_SIZE, op.body.data(), op.body.size());
    csum_arm(c, *item);
    item->is_data = true;  // local completion at full write; flush-counted
    item->done = op.done;
    item->fail = op.fail;
    item->ctx = op.ctx;
    if (c->sess) {
      sess_submit(c, item, fires);
      return;
    }
    c->tx.push_back(std::move(item));
    kick_tx(c, fires);
  }

  // ------------------------------------------------------------- session
  //
  // The C++ half of the resilient-session layer (core/session.py +
  // core/conn.py carry the Python twin; DESIGN.md §14).  Every sequenced
  // frame gains a T_SEQ prefix and lives in the journal until the peer's
  // cumulative ACK covers it; on conn death with a live session the conn
  // SUSPENDS (queues/journal/flush bookkeeping survive), the client
  // redials under backoff, and resume replays everything past the
  // handshake-carried ACK.  Exactly-once delivery comes from the
  // receiver dropping any seq it has already processed.

  static uint64_t sess_wire_bytes(const TxRef& item) {
    // Wire footprint once framed: current frame + the T_SEQ prefix.
    return item->total() + HEADER_SIZE;
  }

  void fire_event(const char* what, uint64_t conn_id, FireList& fires) {
    if (!event_cb) return;
    auto cb = event_cb; auto ctx = event_cb_ctx;
    fires.push_back([cb, ctx, what, conn_id] { cb(ctx, what, conn_id); });
  }

  // Frame (assign seq + embed the T_SEQ prefix) and journal one item.
  // Eager payloads are snapshotted -- the user may legally reuse the
  // buffer once `done` fires, and a replay must resend what was promised.
  // Rendezvous payloads stay by reference: the journal pins them by
  // deferring the release callback until the peer's ACK (the §14 fence --
  // rndv bytes are never blind-replayed from a possibly-reused buffer).
  void sess_frame_and_queue(Conn* c, const TxRef& item) {
    Session* s = c->sess.get();
    uint64_t seq = ++s->tx_seq;
    std::vector<uint8_t> prefixed(HEADER_SIZE + item->header.size());
    pack_header(prefixed.data(), T_SEQ, seq, 0);
    memcpy(prefixed.data() + HEADER_SIZE, item->header.data(),
           item->header.size());
    item->header = std::move(prefixed);
    item->sess_seq = seq;
    if (item->is_data && item->payload && item->paylen > 0) {
      if (item->rndv) {
        item->hold_release = true;
      } else {
        item->owned.assign(item->payload, item->payload + item->paylen);
        item->payload = item->owned.data();
      }
    }
    item->sess_nbytes = item->total();
    s->journal.push_back(item);
    s->journal_bytes += item->sess_nbytes;
    c->tx.push_back(item);
  }

  // Frame + journal + queue, or park when the journal is at its byte cap
  // (backpressure: the send completes late instead of the journal
  // OOMing).  Parked items keep FIFO order; an empty journal always
  // admits one frame so a single over-cap payload cannot deadlock.
  void sess_submit(Conn* c, const TxRef& item, FireList& fires) {
    Session* s = c->sess.get();
    bool room = s->waiting.empty() &&
                (s->journal.empty() ||
                 s->journal_bytes + sess_wire_bytes(item) <= s->journal_cap);
    if (!room) {
      s->waiting.push_back(item);
      return;
    }
    sess_frame_and_queue(c, item);
    kick_tx(c, fires);
  }

  // Move parked items into the journal/tx as ACKs free room.
  bool sess_drain_waiting(Conn* c) {
    Session* s = c->sess.get();
    bool moved = false;
    while (!s->waiting.empty()) {
      TxRef item = s->waiting.front();
      if (!s->journal.empty() &&
          s->journal_bytes + sess_wire_bytes(item) > s->journal_cap)
        break;
      s->waiting.pop_front();
      sess_frame_and_queue(c, item);
      moved = true;
    }
    return moved;
  }

  // Peer's cumulative ACK: trim the journal (releasing pinned rndv
  // payloads), unblock parked sends.
  void sess_on_ack(Conn* c, uint64_t cum, FireList& fires) {
    bump(counters.acks_rx);
    Session* s = c->sess.get();
    if (cum > s->peer_acked) s->peer_acked = cum;
    sess_trim_journal(s, cum, fires);
    if (sess_drain_waiting(c)) kick_tx(c, fires);
  }

  void sess_trim_journal(Session* s, uint64_t cum, FireList& fires) {
    while (!s->journal.empty() && s->journal.front()->sess_seq <= cum) {
      TxRef item = s->journal.front();
      s->journal.pop_front();
      s->journal_bytes -= item->sess_nbytes;
      fire_release(*item, fires, /*force=*/true);
    }
    if (s->journal.empty()) s->journal_bytes = 0;
  }

  // T_SEQ announcing the next frame's sequence number.  Returns false
  // when the conn was torn down (protocol violation / seq gap).
  bool sess_on_seq(Conn* c, uint64_t seq, FireList& fires) {
    Session* s = c->sess.get();
    if (!s) {
      conn_broken(c, fires);  // session frames on a non-session conn
      return false;
    }
    if (seq <= s->rx_cum) {
      // Already processed (replay overlap): drain + drop the frame.
      bump(counters.dup_frames_dropped);
      c->sess_drop = true;
    } else if (seq == s->rx_cum + 1) {
      c->sess_pending = seq;
    } else {
      // Gap inside one incarnation (reordered/corrupted relay): the
      // framed stream cannot be repaired in place -- reset and let the
      // resume handshake replay from the cumulative ACK.
      conn_broken(c, fires);
      return false;
    }
    return true;
  }

  // The sequenced frame announced by the last T_SEQ was fully processed:
  // advance the cumulative counter and make sure an ACK eventually goes
  // out even if no further reads piggyback one.
  void sess_commit(Conn* c) {
    if (!c->sess || c->sess_pending == 0) return;
    c->sess->rx_cum = c->sess_pending;
    c->sess_pending = 0;
    if (!c->sess_ack_armed) {
      c->sess_ack_armed = true;
      add_timer(Timer::SESS_ACK, (void*)(uintptr_t)c->id, 0.2);
    }
  }

  // Piggybacked cumulative ACK: sent at the end of a read pass (and from
  // the idle timer) whenever rx progress is unacknowledged.
  void sess_maybe_ack(Conn* c, FireList& fires) {
    Session* s = c->sess.get();
    if (!s || !c->alive || s->suspended || c->fd < 0) return;
    if (s->rx_cum > s->acked_sent) {
      s->acked_sent = s->rx_cum;
      bump(counters.acks_tx);
      conn_send_ctl(c, T_ACK, s->acked_sent, 0, "", fires);
    }
  }

  // The transport died but the session is resumable: drop the socket and
  // all per-incarnation parser state, keep every queue, journal, and
  // flush bookkeeping.  The conn stays `alive` so flush barriers keep
  // waiting and new sends keep queueing -- they complete after resume.
  // swcheck: state(estab, lost, suspended)
  void sess_suspend(Conn* c, FireList& fires) {
    Session* s = c->sess.get();
    SW_DEBUG("conn %llu lost; session suspended", (unsigned long long)c->id);
    // swrefine: (estab, lost) -> suspended (DESIGN.md §22).
    trace.proto_ev(c->id, "lost");
    s->suspended = true;
    s->deadline = Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                     std::chrono::duration<double>(s->grace));
    if (c->fd >= 0) {
      ep_del(c->fd);
      close(c->fd);
      c->fd = -1;
    }
    c->want_write = false;
    c->db_out.clear();
    uring_unqueue(c);
    // §24: the dead incarnation's zerocopy notifications are unreadable;
    // drop the kernel pins.  The journal's hold_release (NOT force here)
    // keeps the §14 pin alive until the resume replay acks.
    zc_abandon(c, fires);
    // rx parser reset: the replayed stream restarts at a frame boundary.
    c->hdr_got = 0;
    c->ctl_type = 0;
    c->ctl_body.clear();
    c->ctl_need = 0;
    c->ctl_a = 0;
    c->rx_skip = 0;
    c->sess_drop = false;
    c->sess_pending = 0;
    c->csum_pend = false;  // per-incarnation: replay re-announces (§19)
    c->csum_accum = 0;
    // Striped rx parser state is per-incarnation; the ASSEMBLIES survive
    // (the resumed sender re-dispatches un-SACKed sources and offset
    // dedup keeps bytes exactly-once).
    c->sdata_active = false;
    c->sdata_got = 0;
    c->rx_stripe = nullptr;
    c->rx_stripe_got = 0;
    c->feeder_live = false;
    if (c->rx_msg) {
      InboundMsg* m = c->rx_msg;
      bool unowned = c->rx_msg_unowned;
      c->rx_msg = nullptr;
      c->rx_msg_unowned = false;
      std::lock_guard<std::mutex> g(mu);
      if (unowned) {
        delete m;  // probe record: this conn owns it
      } else if (m->has_pr && !m->complete) {
        // Re-arm the stranded receive at the FRONT of the queue: the
        // replayed frame must claim the same receive (its buffer was
        // partially written; the replay rewrites it from the start).
        PostedRecv pr = m->pr;
        pr.claimed = false;
        m->has_pr = false;
        matcher.purge_inflight(m);
        matcher.posted.push_front(pr);
      } else {
        matcher.purge_inflight(m);
      }
    }
    // Journaled frames replay from the journal; bare per-incarnation ctl
    // (PING/PONG/ACK/handshake) queued on the old transport dies with it.
    drop_feeder_holds(c, fires);
    c->tx.clear();
    for (uint64_t rid : std::vector<uint64_t>(c->rails)) {
      // Rails are per-incarnation transports (like sm rings): the
      // resumed client re-dials them; un-SACKed striped sources
      // re-dispatch wholesale at resume (journal per-message).
      Conn* r = conn_by_id(rid);
      if (r && r->alive) conn_broken(r, fires);
    }
    c->rails.clear();
    add_timer(Timer::SESS_GRACE, (void*)(uintptr_t)c->id, s->grace);
    if (!is_server)
      add_timer(Timer::SESS_REDIAL, (void*)(uintptr_t)c->id, 0.01);
  }

  // A reconnect re-handshake matched this session: adopt the new socket,
  // trim the journal by the peer's cumulative ACK (carried in the
  // handshake), and replay everything past it.  `ack_body` is the
  // acceptor's HELLO_ACK JSON -- it must precede replayed frames on the
  // wire ("" on the client side, which already consumed the peer's ACK).
  // swcheck: state(suspended, resume, estab)
  void sess_resume(Conn* c, int fd, uint64_t peer_ack,
                   const std::string& ack_body, FireList& fires) {
    Session* s = c->sess.get();
    // swrefine: (suspended, resume) -> estab; the resume dial's
    // HELLO/HELLO_ACK exchange is folded into this one event
    // (DESIGN.md §22).
    trace.proto_ev(c->id, "resume");
    s->suspended = false;
    s->attempt = 0;
    c->fd = fd;
    c->last_rx = Clock::now();
    if (peer_ack > s->peer_acked) s->peer_acked = peer_ack;
    sess_trim_journal(s, peer_ack, fires);
    // The handshake carried our rx_cum as sess_ack: the peer starts from
    // it, so there is nothing older to re-ACK.
    s->acked_sent = s->rx_cum;
    // Frames queued while suspended are all journaled (framing happens at
    // submit): rebuild tx purely from the journal, or those items would
    // ride the wire twice.
    drop_feeder_holds(c, fires);
    c->tx.clear();
    bump(counters.sessions_resumed);
    if (!ack_body.empty()) {
      auto ack = std::make_shared<TxItem>();
      ack->header.resize(HEADER_SIZE + ack_body.size());
      pack_header(ack->header.data(), T_HELLO_ACK, 0, ack_body.size());
      memcpy(ack->header.data() + HEADER_SIZE, ack_body.data(),
             ack_body.size());
      c->tx.push_back(std::move(ack));
    }
    uint64_t replayed = 0;
    for (auto& item : s->journal) {
      item->off = 0;
      c->tx.push_back(item);
      replayed++;
      if (trace.enabled && c->tr_hex[0] && item->counted && item->e2e_ord) {
        // swscope: this frame's ordinal was recorded at its first full
        // transmission; the replay rewrites the bytes (the receiver's
        // seq dedup drops them if they landed) -- mark it superseded,
        // never recount it.
        char reason[24];
        snprintf(reason, sizeof(reason), "%s:sup", c->tr_hex);
        trace.rec(kEvE2e, item->e2e_ord, c->id, 0, reason);
      }
    }
    bump(counters.frames_replayed, replayed);
    sess_drain_waiting(c);  // trim may have freed journal room
    c->feeder_live = false;  // tx was rebuilt: the old feeder is gone
    trace.rec(kEvSessResume, 0, c->id, replayed);
    fire_event("session-resume", c->id, fires);
    ep_add(fd, EPOLLIN, c);
    if (c->fc_ok)
      // Fresh credit window per incarnation; unSACKed rendezvous sends
      // re-announce; parked sends re-enter dispatch (DESIGN.md §18).
      // After ep_add: the drain may arm write interest.
      fc_reset_resume(c, fires);
    stripe_redispatch(c, fires);
    kick_tx(c, fires);
  }

  // Terminal session failure: grace elapsed, or the peer answered a
  // resume dial with a new epoch.  Everything that was riding out the
  // outage fails with the stable "session expired" reason.
  // swcheck: state(suspended, expire, expired)
  void sess_expire(Conn* c, FireList& fires) {
    Session* s = c->sess.get();
    if (!s || s->expired) return;
    // swrefine: terminal expiry -- from `suspended` (grace / epoch
    // mismatch) or straight from `estab` (the stale-epoch registration
    // path, MONITOR_EXTRA in analysis/refine.py; DESIGN.md §22).
    trace.proto_ev(c->id, "expire");
    s->expired = true;
    c->sess_fail = kSessionExpired;
    SW_DEBUG("session expired (conn %llu)", (unsigned long long)c->id);
    trace.rec(kEvSessExpire, 0, c->id, 0, kSessionExpired);
    fire_event("session-expired", c->id, fires);
    sess_cancel_terminal(c, fires, kSessionExpired);
    fc_cancel_terminal(c, fires, kSessionExpired);
    if (c->alive) {
      c->alive = false;
      if (c->fd >= 0) {
        ep_del(c->fd);
        close(c->fd);
        c->fd = -1;
      }
      for (auto& ref : c->tx) {
        TxItem& item = *ref;
        if (item.is_data && !item.local_done && item.fail) {
          item.local_done = true;
          bump(counters.ops_cancelled);
          auto fail = item.fail; auto ctx = item.ctx;
          fires.push_back([fail, ctx] { fail(ctx, kSessionExpired); });
        }
        fire_release(item, fires, /*force=*/true);
      }
      drop_feeder_holds(c, fires);
      c->tx.clear();
      c->feeder_live = false;
      if (c->rx_msg) {
        std::lock_guard<std::mutex> g(mu);
        matcher.purge_inflight(c->rx_msg);
        c->rx_msg = nullptr;
        c->rx_msg_unowned = false;
      }
      std::lock_guard<std::mutex> g(mu);
      matcher.purge_remote_conn(c->id);
    }
    stripe_terminal(c, kSessionExpired, fires);
    for (uint64_t rid : std::vector<uint64_t>(c->rails)) {
      Conn* r = conn_by_id(rid);
      if (r && r->alive) conn_broken(r, fires);
    }
    c->rails.clear();
    // Session users opted into bounded failure (like the keepalive
    // contract): queued receives fail once no alive conns remain.
    {
      std::lock_guard<std::mutex> g(mu);
      bool any_alive = false;
      for (auto& [id, cc] : conns)
        if (cc->alive) { any_alive = true; break; }
      if (!any_alive) matcher.fail_pending(kSessionExpired, fires);
    }
    auto snapshot = flushes;
    for (auto* rec : snapshot) try_complete_flush(rec, fires);
  }

  // Terminal teardown sweep for session state: cancel journaled / parked
  // items exactly once (`local_done` dedupes against the tx loop -- a
  // journaled item may also sit in tx) and release pinned payloads.
  void sess_cancel_terminal(Conn* c, FireList& fires, const char* reason) {
    if (!c->sess) return;
    Session* s = c->sess.get();
    auto cancel_item = [&](const TxRef& item) {
      if (item->is_data && !item->local_done && item->fail) {
        item->local_done = true;
        bump(counters.ops_cancelled);
        auto fail = item->fail; auto ctx = item->ctx;
        fires.push_back([fail, ctx, reason] { fail(ctx, reason); });
      }
      fire_release(*item, fires, /*force=*/true);
    };
    for (auto& item : s->journal) cancel_item(item);
    for (auto& item : s->waiting) cancel_item(item);
    s->journal.clear();
    s->journal_bytes = 0;
    s->waiting.clear();
    sessions.erase(s->id);
  }

  // SESS_* timer dispatch (ctx carries the conn id).
  void sess_timer(const Timer& t, FireList& fires) {
    uint64_t cid = (uint64_t)(uintptr_t)t.ctx;
    Conn* c = nullptr;
    {
      std::lock_guard<std::mutex> g(mu);
      auto it = conns.find(cid);
      if (it != conns.end()) c = it->second;
    }
    if (!c || !c->sess) return;
    Session* s = c->sess.get();
    if (t.kind == Timer::SESS_ACK) {
      c->sess_ack_armed = false;
      sess_maybe_ack(c, fires);
      return;
    }
    if (s->expired) return;
    if (t.kind == Timer::SESS_GRACE) {
      if (s->suspended && Clock::now() >= s->deadline) sess_expire(c, fires);
      return;
    }
    // SESS_REDIAL (client only)
    if (!s->suspended || status.load() != ST_RUNNING) return;
    if (Clock::now() >= s->deadline) {
      sess_expire(c, fires);
      return;
    }
    sess_redial(c, fires);
  }

  // One resume attempt for a suspended session (engine thread; re-armed
  // under exponential backoff with jitter -- the PR-1 reconnect shape,
  // now transparent).  The dial blocks the engine loop for at most the
  // connect timeout, like the Python engine's _sess_dial.
  void sess_redial(Conn* c, FireList& fires) {
    Session* s = c->sess.get();
    int fd = -1;
    std::string ack_body;
    if (!sess_dial(s, &fd, &ack_body)) {
      s->attempt++;
      int shift = s->attempt - 1 > 5 ? 5 : s->attempt - 1;
      double base = 0.05 * (double)(1u << shift);
      if (base > 1.0) base = 1.0;
      double delay = base * (0.5 + (double)(rand() % 1000) / 2000.0);
      add_timer(Timer::SESS_REDIAL, (void*)(uintptr_t)c->id, delay);
      return;
    }
    if (json_field(ack_body, "sess") != "ok" ||
        json_field(ack_body, "sess_epoch") != s->epoch) {
      // The peer restarted (or forgot us): a new epoch is a new session
      // -- ours is expired, not resumable.
      close(fd);
      sess_expire(c, fires);
      return;
    }
    uint64_t peer_ack =
        strtoull(json_field(ack_body, "sess_ack").c_str(), nullptr, 10);
    sess_resume(c, fd, peer_ack, "", fires);
    if (c->rails_ok) {
      // Rails are per-incarnation: re-dial them now that the session is
      // back (striped sources already re-dispatched on the primary; new
      // lanes start stealing as they attach).
      dial_rails(c, stripe_rails_env() - 1, fires);
    }
  }

  // One blocking resume dial + handshake, bounded by the connect timeout.
  // Returns true with *out_fd (nonblocking) and *out_ack on success.
  // swcheck: state(hello-sent, HELLO_ACK, estab)
  // swcheck: state(hello-sent, OTHER, down)
  bool sess_dial(Session* s, int* out_fd, std::string* out_ack) {
    std::string hello = std::string("{\"worker_id\": \"") + worker_id +
                        "\", \"mode\": \"" + c_mode + "\", \"name\": \"\"" +
                        ", \"ka\": \"ok\", \"sess\": \"ok\", \"sess_id\": \"" +
                        s->id + "\", \"sess_epoch\": \"" + s->epoch +
                        "\", \"sess_ack\": \"" + std::to_string(s->rx_cum) +
                        "\"";
    if (devpull_advertise)
      hello += ", \"cudaipc\": \"" + cudaipc_id + "\"";
    uint64_t fc_w = fc_window_env();
    if (fc_w > 0)
      // Fresh credit window per incarnation (DESIGN.md §18): both sides
      // reset to their stored windows at resume; the key is
      // re-advertised for wire-format consistency.
      hello += ", \"fc\": \"" + std::to_string(fc_w) + "\"";
    if (integrity_enabled())
      // §19: re-offered per incarnation for wire-format consistency
      // (csum_ok is sticky on the session conn either way).
      hello += ", \"csum\": \"1\"";
    hello += "}";
    return blocking_dial(hello, out_fd, out_ack);
  }

  // Session half of the accept handshake.  Returns true when this dial
  // RESUMED an existing suspended session (`c` -- the fresh accept
  // wrapper -- was consumed: its socket moved onto the suspended conn);
  // false when a new session was registered on `c` and the normal accept
  // path continues.
  bool sess_hello(Conn* c, const std::string& body, FireList& fires) {
    std::string sid = json_field(body, "sess_id");
    std::string req_epoch = json_field(body, "sess_epoch");
    auto it = sessions.find(sid);
    Conn* existing = it == sessions.end() ? nullptr : it->second;
    if (existing && existing->sess && !existing->sess->expired &&
        existing->sess->epoch == req_epoch) {
      if (!existing->sess->suspended) {
        // One-sided failure: the client saw its conn die and redialed
        // before this side noticed (no EOF yet, ka not expired).  The
        // resume dial itself proves the old incarnation dead --
        // supersede it instead of expiring a resumable session.
        sess_suspend(existing, fires);
      }
      uint64_t peer_ack =
          strtoull(json_field(body, "sess_ack").c_str(), nullptr, 10);
      int fd = c->fd;
      ep_del(fd);
      c->fd = -1;
      c->alive = false;
      sess_reap.push_back(c);  // zombie wrapper: freed at end of this pass
      std::string ack =
          std::string("{\"worker_id\": \"") + worker_id +
          "\", \"sess\": \"ok\", \"sess_epoch\": \"" + existing->sess->epoch +
          "\", \"sess_ack\": \"" + std::to_string(existing->sess->rx_cum) +
          "\"" + (existing->ka_ok ? ", \"ka\": \"ok\"" : "") +
          (existing->csum_ok ? ", \"csum\": \"ok\"" : "") +
          (existing->devpull_ok ? ", \"cudaipc\": \"" + cudaipc_id + "\""
                                : "") +
          (existing->fc_ok
               ? ", \"fc\": \"" +
                     std::to_string(fc_window_env() ? fc_window_env()
                                                    : existing->fc_window) +
                     "\""
               : "") +
          "}";
      sess_resume(existing, fd, peer_ack, ack, fires);
      return true;
    }
    if (existing && existing != c) {
      // Same session id, stale epoch: the old incarnation can never
      // resume -- expire it before the new registration shadows it in
      // the registry.
      sess_expire(existing, fires);
    }
    c->sess = std::make_unique<Session>();
    c->sess->id = sid;
    uint64_t r = 0;
    if (getrandom(&r, 8, 0) != 8) r = (uint64_t)(uintptr_t)c ^ c->id;
    char ep[17];
    snprintf(ep, sizeof(ep), "%08x", (uint32_t)r);
    c->sess->epoch = ep;
    c->sess->journal_cap = session_journal_bytes_env();
    c->sess->grace = session_grace_env();
    sessions[sid] = c;
    return false;
  }

  // ------------------------------------------------------------- stripe
  //
  // Multi-rail striping (DESIGN.md §17; core/lane.py RailGroup is the
  // Python twin).  All stripe state is engine-thread-owned; `mu` guards
  // only the conns registry and matcher, as everywhere else.

  Conn* conn_by_id(uint64_t id) {
    if (!id) return nullptr;
    std::lock_guard<std::mutex> g(mu);
    auto it = conns.find(id);
    return it == conns.end() ? nullptr : it->second;
  }

  Conn* stripe_root(Conn* c) {
    if (!c->rail_parent) return c;
    Conn* root = conn_by_id(c->rail_parent);
    return root ? root : c;
  }

  // Drop the payload pin once settled AND no feeder is mid-frame on the
  // source (a frame header already promised its chunk's bytes).
  static void stripe_maybe_release(StripeSrc& s, FireList& fires) {
    if ((s.sacked || s.failed) && s.writers <= 0 && s.release) {
      auto rel = s.release; auto rctx = s.release_ctx;
      s.release = nullptr;
      fires.push_back([rel, rctx] { rel(rctx); });
    }
  }

  void stripe_first_progress(const StripeRef& src, FireList& fires) {
    if (src->local_done) return;
    // Transmission begun: rndv-style local completion for the message.
    src->local_done = true;
    // swpulse (§25): striped submit -> first wire progress.
    hbump(hists.send_local_us, (uint64_t)((mono_s() - src->t_post) * 1e6));
    if (src->done) {
      auto done = src->done; auto ctx = src->ctx;
      fires.push_back([done, ctx] { done(ctx); });
    }
  }

  // STARWAY_STRIPE_WEIGHTED tail bias (core/lane.py _decline_tail is the
  // twin): in a message's last chunks a slow lane's final chunk IS the
  // completion time, so a lane whose delivered-throughput EWMA sits
  // below half the fastest live lane's declines the steal and leaves it
  // for a faster lane's next refill.
  bool stripe_decline_tail(Conn* root, Conn* lane, const StripeRef& src) {
    if (lane->stripe_ewma_bps <= 0 || !stripe_weighted_env()) return false;
    int live = stripe_live_lanes(root);
    if (live < 2 || src->pending.size() > (size_t)live) return false;
    double best = (root->alive && root->fd >= 0) ? root->stripe_ewma_bps : 0;
    for (uint64_t rid : root->rails) {
      Conn* r = conn_by_id(rid);
      if (r && r->alive && r->fd >= 0 && r->stripe_ewma_bps > best)
        best = r->stripe_ewma_bps;
    }
    if (lane->stripe_ewma_bps >= kStripeSlowFraction * best) return false;
    lane->stripe_tail_declines++;
    return true;
  }

  // The work-stealing heart: hand the next pending chunk (FIFO across
  // sources) to the lane that asked, loading it into `item` as one
  // self-describing T_SDATA frame.  `steal` marks a refill claim; only
  // steals may be declined by the weighted-tail policy (dispatch always
  // feeds every live lane, so a declined chunk can never strand).
  bool stripe_claim(Conn* root, Conn* lane, TxItem& item, bool steal) {
    while (!root->stripe_q.empty()) {
      StripeRef& front = root->stripe_q.front();
      if (front->pending.empty() || front->sacked || front->failed) {
        root->stripe_q.pop_front();
        continue;
      }
      break;
    }
    for (auto& qref : root->stripe_q) {
      StripeRef src = qref;
      if (src->pending.empty() || src->sacked || src->failed)
        continue;  // settled mid-queue: dropped when it reaches front
      // A declined tail skips THIS source only: the slow lane must
      // still carry the bulk of messages queued behind it (core/lane.py
      // claim_next is the twin).
      if (steal && stripe_decline_tail(root, lane, src)) continue;
      uint64_t off = src->pending.front();
      src->pending.pop_front();
      src->rail_offs[lane->id].push_back(off);
      src->writers++;
      uint64_t n = src->chunk_len(off);
      item.header.resize(HEADER_SIZE + SDATA_SUB_SIZE);
      pack_header(item.header.data(), T_SDATA, src->tag, SDATA_SUB_SIZE + n);
      memcpy(item.header.data() + HEADER_SIZE, &src->msg_id, 8);
      memcpy(item.header.data() + HEADER_SIZE + 8, &off, 8);
      memcpy(item.header.data() + HEADER_SIZE + 16, &src->total, 8);
      item.payload = src->payload + off;
      item.paylen = n;
      item.off = 0;
      item.stripe = src;
      item.stripe_off = off;
      item.stripe_t0 =
          std::chrono::duration<double>(Clock::now().time_since_epoch())
              .count();
      // §19: every chunk frame self-verifies; per-lane -- each rail
      // negotiated csum in its own handshake (core/lane.py twin).
      csum_arm(lane, item);
      return true;
    }
    return false;
  }

  // One chunk fully handed to `lane`'s transport: account it, release
  // the feeder's hold, and mark the message handed when it was the last.
  void stripe_tx_chunk_finished(Conn* lane, TxItem& item, FireList& fires) {
    StripeRef src = item.stripe;
    bump(counters.stripe_chunks_tx);
    // Lane throughput EWMA (tracked unconditionally, one multiply per
    // chunk; only the weighted-claim policy is env-gated).
    double dt = std::chrono::duration<double>(
                    Clock::now().time_since_epoch()).count() - item.stripe_t0;
    uint64_t nb = src->chunk_len(item.stripe_off);
    if (dt > 0 && nb > 0) {
      double bps = (double)nb / dt;
      lane->stripe_ewma_bps =
          lane->stripe_ewma_bps == 0
              ? bps
              : (1.0 - kStripeEwmaAlpha) * lane->stripe_ewma_bps +
                    kStripeEwmaAlpha * bps;
    }
    stripe_root(lane)->retx_offs.erase({src->msg_id, item.stripe_off});
    src->writers--;
    if (src->unwritten > 0) src->unwritten--;
    auto it = src->rail_offs.find(lane->id);
    if (it != src->rail_offs.end()) {
      auto& v = it->second;
      auto pos = std::find(v.begin(), v.end(), item.stripe_off);
      if (pos != v.end()) {
        v.erase(pos);
        src->done_offs[lane->id].push_back(item.stripe_off);
      }
    }
    Conn* root = stripe_root(lane);
    if (src->unwritten == 0 && src->pending.empty() && !src->counted) {
      src->counted = true;
      bump(counters.sends_completed);
      if (trace.enabled) {
        trace.rec(kEvSendDone, src->tag, root->id, src->total);
        if (root->tr_hex[0]) {
          // swscope: ONE marker per striped message on the primary,
          // ordinal = msg_id (shared wire state -- the pair survives
          // out-of-order assembly completion).
          char reason[24];
          snprintf(reason, sizeof(reason), "%s:sx", root->tr_hex);
          trace.rec(kEvE2e, src->msg_id, root->id, src->total, reason);
        }
      }
    }
    stripe_maybe_release(*src, fires);
  }

  // Refill the lane's feeder with the next chunk; false = group dry
  // (or a weighted-tail decline -- the steal point).
  bool stripe_refill(Conn* lane, TxItem& item) {
    item.stripe.reset();
    return stripe_claim(stripe_root(lane), lane, item, /*steal=*/true);
  }

  // A tx queue about to be cleared may hold a feeder mid-frame: release
  // its hold on the source (writers) or the payload pin would leak past
  // the SACK that should free it (core/lane.py _drop_src is the twin).
  void drop_feeder_holds(Conn* c, FireList& fires) {
    for (auto& ref : c->tx) {
      if (ref->stripe) {
        ref->stripe->writers--;
        stripe_maybe_release(*ref->stripe, fires);
        ref->stripe.reset();
      }
    }
    c->feeder_live = false;
  }

  int stripe_live_lanes(Conn* root) {
    int n = (root->alive && root->fd >= 0) ? 1 : 0;
    for (uint64_t rid : root->rails) {
      Conn* r = conn_by_id(rid);
      if (r && r->alive && r->fd >= 0) n++;
    }
    return n;
  }

  // Make sure every live lane has an active feeder and kick it.
  void stripe_dispatch(Conn* root, FireList& fires) {
    std::vector<Conn*> lanes{root};
    for (uint64_t rid : root->rails) {
      Conn* r = conn_by_id(rid);
      if (r) lanes.push_back(r);
    }
    for (Conn* lane : lanes) {
      if (!lane->alive || lane->fd < 0) continue;
      if (!lane->feeder_live) {
        auto item = std::make_shared<TxItem>();
        if (!stripe_claim(root, lane, *item, /*steal=*/false))
          break;  // group dry
        item->counted = true;  // the SOURCE owns per-message accounting
        lane->feeder_live = true;
        lane->tx.push_back(std::move(item));
      }
      kick_tx(lane, fires);
    }
  }

  void stripe_submit(Conn* c, const Op& op, FireList& fires) {
    auto src = std::make_shared<StripeSrc>();
    src->msg_id = c->next_stripe_msg++;
    src->tag = op.tag;
    src->total = op.len;
    src->chunk = stripe_chunk_env();
    src->payload = op.buf;
    for (uint64_t off = 0; off < src->total; off += src->chunk)
      src->pending.push_back(off);
    src->unwritten = src->pending.size();
    src->done = op.done;
    src->fail = op.fail;
    src->ctx = op.ctx;
    src->release = op.release;
    src->release_ctx = op.release_ctx;
    c->dirty = true;
    c->stripe_by_id[src->msg_id] = src;
    c->stripe_q.push_back(src);
    stripe_dispatch(c, fires);
  }

  bool stripe_has_unsacked(Conn* root, uint64_t watermark) {
    for (auto& [mid, src] : root->stripe_by_id)
      if (mid <= watermark && !src->sacked) return true;
    return false;
  }

  void stripe_on_sack(Conn* root, uint64_t msg_id, FireList& fires) {
    auto it = root->stripe_by_id.find(msg_id);
    if (it == root->stripe_by_id.end()) return;
    for (auto rit = root->retx_offs.begin(); rit != root->retx_offs.end();)
      rit = rit->first == msg_id ? root->retx_offs.erase(rit) : std::next(rit);
    StripeRef src = it->second;
    root->stripe_by_id.erase(it);
    if (!src->sacked) {
      src->sacked = true;
      // swpulse (§25): §17 payload-pin residency, submit -> SACK.
      hbump(hists.pin_us, (uint64_t)((mono_s() - src->t_post) * 1e6));
      stripe_maybe_release(*src, fires);
    }
    auto snapshot = flushes;
    for (auto* rec : snapshot) try_complete_flush(rec, fires);
  }

  // A secondary lane died: re-queue its claimed-but-unacked chunks and
  // let the survivors steal them (the payload is pinned until SACK, so
  // the resend is always legal; receiver offset dedup absorbs chunks
  // that did land).
  void stripe_rail_lost(Conn* root, uint64_t rail_id, FireList& fires) {
    root->rails.erase(std::remove(root->rails.begin(), root->rails.end(),
                                  rail_id),
                      root->rails.end());
    uint64_t restolen = 0;
    for (auto& [mid, src] : root->stripe_by_id) {
      std::vector<uint64_t> infl, done;
      auto it = src->rail_offs.find(rail_id);
      if (it != src->rail_offs.end()) {
        infl = std::move(it->second);
        src->rail_offs.erase(it);
      }
      auto dt = src->done_offs.find(rail_id);
      if (dt != src->done_offs.end()) {
        done = std::move(dt->second);
        src->done_offs.erase(dt);
      }
      if ((infl.empty() && done.empty()) || src->failed || src->sacked)
        continue;
      // In-flight chunks were never counted written (unwritten already
      // covers them); written-to-the-dead-lane chunks go back to
      // unwritten for the resend.
      for (uint64_t off : infl) src->pending.push_back(off);
      for (uint64_t off : done) src->pending.push_back(off);
      src->unwritten += done.size();
      restolen += infl.size() + done.size();
      bool queued = false;
      for (auto& q : root->stripe_q)
        if (q.get() == src.get()) { queued = true; break; }
      if (!queued) root->stripe_q.push_back(src);
    }
    if (restolen) {
      bump(counters.rail_resteals, restolen);
      stripe_dispatch(root, fires);
    }
  }

  // Session resume: re-dispatch every un-SACKed source from chunk zero
  // across whatever lanes are live -- the journal is per-message, never
  // per-lane; the receiver's offset dedup + completed-id LRU make the
  // wholesale resend exactly-once.
  void stripe_redispatch(Conn* root, FireList& fires) {
    root->stripe_q.clear();
    root->retx_offs.clear();  // wholesale resend supersedes NACKs (§19)
    std::vector<uint64_t> ids;
    for (auto& [mid, src] : root->stripe_by_id) ids.push_back(mid);
    std::sort(ids.begin(), ids.end());
    for (uint64_t mid : ids) {
      StripeRef src = root->stripe_by_id[mid];
      if (src->sacked || src->failed) continue;
      src->pending.clear();
      for (uint64_t off = 0; off < src->total; off += src->chunk)
        src->pending.push_back(off);
      src->rail_offs.clear();
      src->done_offs.clear();
      src->writers = 0;  // the suspended incarnation's feeders are gone
      src->unwritten = src->pending.size();
      root->stripe_q.push_back(src);
    }
    if (!root->stripe_q.empty()) stripe_dispatch(root, fires);
  }

  // Primary terminal teardown: settle every un-SACKed source (entries
  // stay registered, marked failed, so a flush barrier waiting on their
  // SACKs fails instead of completing vacuously) and purge partial
  // assemblies from the matcher.
  void stripe_terminal(Conn* c, const char* reason, FireList& fires,
                       bool purge_rx = true) {
    for (auto& [mid, src] : c->stripe_by_id) {
      if (src->sacked || src->failed) continue;
      src->failed = true;
      bump(counters.ops_cancelled);
      if (!src->local_done && src->fail) {
        auto fail = src->fail; auto ctx = src->ctx;
        fires.push_back([fail, ctx, reason] { fail(ctx, reason); });
      }
      src->local_done = true;
      src->writers = 0;  // no feeder will ever touch it again
      stripe_maybe_release(*src, fires);
    }
    c->stripe_q.clear();
    c->retx_offs.clear();
    if (!c->stripe_asm.empty()) {
      std::lock_guard<std::mutex> g(mu);
      for (auto& [mid, a] : c->stripe_asm) {
        if (purge_rx) {
          matcher.purge_inflight(a->msg);
        } else if (a->msg_unowned) {
          // do_close: cancel_all already freed every matcher-owned
          // record; only unowned probe records are still ours to free.
          delete a->msg;
        }
        delete a;
      }
      c->stripe_asm.clear();
    }
  }

  // A completed striped sub-header on `rail`: resolve the assembly (or
  // arrange the chunk drained) and arm the payload streaming state.
  void stripe_rx_resolve(Conn* rail, FireList& fires) {
    uint64_t msg_id, off, total;
    memcpy(&msg_id, rail->sdata_sub, 8);
    memcpy(&off, rail->sdata_sub + 8, 8);
    memcpy(&total, rail->sdata_sub + 16, 8);
    uint64_t clen = rail->sdata_len - SDATA_SUB_SIZE;
    Conn* root = stripe_root(rail);
    if (root->stripe_done.count(msg_id)) {
      // Late resend of a completed message: drain + re-SACK.
      rail->rx_skip = clen;
      conn_send_ctl(rail, T_SACK, msg_id, total, "", fires);
      return;
    }
    StripeAsm* a = nullptr;
    auto it = root->stripe_asm.find(msg_id);
    if (it != root->stripe_asm.end()) {
      a = it->second;
    } else {
      a = new StripeAsm();
      a->msg_id = msg_id;
      a->tag = rail->sdata_tag;
      a->total = total;
      {
        std::lock_guard<std::mutex> g(mu);
        a->msg = matcher.on_start(rail->sdata_tag, total, fires);
      }
      a->msg_unowned = (rail->sdata_tag == Matcher::kProbeTag);
      root->stripe_asm[msg_id] = a;
    }
    if (a->offs.count(off) || off + clen > a->total) {
      rail->rx_skip = clen;  // duplicate (or malformed) chunk: drain
      return;
    }
    rail->rx_stripe = a;
    rail->rx_stripe_off = off;
    rail->rx_stripe_len = clen;
    rail->rx_stripe_got = 0;
  }

  // §18 rendezvous delivery completing: resolve the descriptor record
  // BEFORE the matcher completion may free it -- deferred flush ACKs
  // release, and the (now resident) message behaves like staged data.
  void fc_rx_completing(Conn* root, StripeAsm* a, FireList& fires) {
    auto it = root->fc_rx.find(a->msg_id);
    if (it == root->fc_rx.end()) return;
    InboundMsg* m = it->second;
    root->fc_rx.erase(it);
    m->remote = false;
    m->rts = false;
    devpull_resolve(root, a->msg_id, fires);
  }

  void stripe_rx_chunk_done(Conn* rail, FireList& fires) {
    StripeAsm* a = rail->rx_stripe;
    uint64_t off = rail->rx_stripe_off, clen = rail->rx_stripe_len;
    rail->rx_stripe = nullptr;
    rail->rx_stripe_got = 0;
    if (a->offs.count(off)) return;  // cross-rail duplicate finished
    //          second: identical bytes, but accounting must be once-only
    a->offs.insert(off);
    a->received += clen;
    bump(counters.stripe_chunks_rx);
    if (a->received < a->total) return;
    Conn* root = stripe_root(rail);
    // A cross-rail duplicate of some offset may still be mid-stream on a
    // sibling lane; completion frees this assembly and hands the sink
    // back to the user, so redirect those reads to the drain path NOW
    // (use-after-free / write-after-done otherwise; core/lane.py twin).
    std::vector<Conn*> group{root};
    for (uint64_t rid : root->rails) {
      Conn* r = conn_by_id(rid);
      if (r) group.push_back(r);
    }
    for (Conn* r : group) {
      if (r != rail && r->rx_stripe == a) {
        r->rx_skip = r->rx_stripe_len - r->rx_stripe_got;
        r->rx_stripe = nullptr;
        r->rx_stripe_got = 0;
      }
    }
    InboundMsg* m = a->msg;
    m->received = a->total;
    root->stripe_asm.erase(a->msg_id);
    root->stripe_done.insert(a->msg_id);
    root->stripe_done_fifo.push_back(a->msg_id);
    while (root->stripe_done_fifo.size() > kStripeDoneLru) {
      root->stripe_done.erase(root->stripe_done_fifo.front());
      root->stripe_done_fifo.pop_front();
    }
    fc_rx_completing(root, a, fires);
    {
      std::lock_guard<std::mutex> g(mu);
      matcher.on_complete(m, fires);
    }
    conn_send_ctl(rail, T_SACK, a->msg_id, a->total, "", fires);
    if (trace.enabled && root->tr_hex[0]) {
      char reason[24];
      snprintf(reason, sizeof(reason), "%s:sr", root->tr_hex);
      trace.rec(kEvE2e, a->msg_id, root->id, a->total, reason);
    }
    delete a;
  }

  // Secondary-lane attach (server side): adopt the accepted conn into
  // the endpoint whose peer worker id is `rail_of`.
  void on_rail_hello(Conn* c, const std::string& rail_of,
                     const std::string& body, FireList& fires) {
    Conn* primary = nullptr;
    {
      std::lock_guard<std::mutex> g(mu);
      for (auto& [id, cc] : conns) {
        if (cc->alive && cc->handshaken && cc->peer_name == rail_of &&
            cc->rail_parent == 0) {
          primary = cc;
          break;
        }
      }
    }
    if (!primary) {
      // Raced the endpoint's death: answer without "rail": "ok"; the
      // dialer drops the socket.
      std::string ack = std::string("{\"worker_id\": \"") + worker_id + "\"}";
      conn_send_ctl(c, T_HELLO_ACK, 0, ack.size(), ack, fires);
      return;
    }
    if (json_field(body, "ka") == "ok") c->ka_ok = true;
    if (integrity_enabled() && !json_field(body, "csum").empty())
      c->csum_ok = true;
    c->rail_parent = primary->id;
    primary->rails.push_back(c->id);
    {
      std::lock_guard<std::mutex> g(mu);
      conns[c->id] = c;
    }
    std::string ack = std::string("{\"worker_id\": \"") + worker_id +
                      "\", \"rail\": \"ok\"" +
                      (c->ka_ok ? ", \"ka\": \"ok\"" : "") +
                      (c->csum_ok ? ", \"csum\": \"ok\"" : "") + "}";
    conn_send_ctl(c, T_HELLO_ACK, 0, ack.size(), ack, fires);
    trace.rec(kEvConnUp, 0, c->id);
    if (!primary->stripe_q.empty()) stripe_dispatch(primary, fires);
  }

  // Client side: dial `count` secondary lanes to the accepted endpoint
  // (blocking dials on the engine thread, like the primary handshake; a
  // failed rail is skipped -- striping runs over fewer lanes).
  void dial_rails(Conn* primary, int count, FireList& fires) {
    for (int i = 0; i < count; i++) {
      int fd = -1;
      std::string ack;
      std::string hello =
          std::string("{\"worker_id\": \"") + worker_id +
          "\", \"mode\": \"" + c_mode + "\", \"name\": \"\", \"rail_of\": \"" +
          worker_id + "\", \"rail_idx\": \"" + std::to_string(i + 1) +
          "\", \"ka\": \"ok\"" +
          (integrity_enabled() ? ", \"csum\": \"1\"" : "") + "}";
      if (!blocking_dial(hello, &fd, &ack) || json_field(ack, "rail") != "ok") {
        SW_DEBUG("rail %d dial failed; striping over fewer lanes", i + 1);
        if (fd >= 0) close(fd);
        continue;
      }
      auto* r = new Conn();
      r->fd = fd;
      r->handshaken = true;
      r->mode = c_mode;
      r->peer_name = primary->peer_name;
      r->ka_ok = json_field(ack, "ka") == "ok";
      r->csum_ok = integrity_enabled() && json_field(ack, "csum") == "ok";
      r->rail_parent = primary->id;
      r->remote_addr = c_host;
      r->remote_port = c_port;
      {
        std::lock_guard<std::mutex> g(mu);
        r->id = next_conn_id++;
        conns[r->id] = r;
      }
      primary->rails.push_back(r->id);
      // swrefine: rails take the same blocking handshake as the primary.
      trace.proto_ev(r->id, "st:hello-sent");
      trace.proto_ev(r->id, "rx:HELLO_ACK");
      ep_add(fd, EPOLLIN, r);
      trace.rec(kEvConnUp, 0, r->id);
    }
    if (!primary->stripe_q.empty()) stripe_dispatch(primary, fires);
  }

  // One blocking HELLO/HELLO_ACK exchange against the client's target
  // (shared by the session redial and the rail dials).
  bool blocking_dial(const std::string& hello, int* out_fd,
                     std::string* out_ack) {
    const int cto_ms = connect_timeout_ms();
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) return false;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)c_port);
    if (inet_pton(AF_INET, c_host.c_str(), &addr.sin_addr) != 1) {
      close(fd);
      return false;
    }
    int rc = ::connect(fd, (sockaddr*)&addr, sizeof(addr));
    if (rc < 0 && errno != EINPROGRESS) {
      close(fd);
      return false;
    }
    pollfd pfd{fd, POLLOUT, 0};
    int err = 0;
    socklen_t elen = sizeof(err);
    if (poll(&pfd, 1, cto_ms) <= 0 ||
        getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) != 0 || err != 0) {
      close(fd);
      return false;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::vector<uint8_t> frame(HEADER_SIZE + hello.size());
    pack_header(frame.data(), T_HELLO, 0, hello.size());
    memcpy(frame.data() + HEADER_SIZE, hello.data(), hello.size());
    size_t off = 0;
    while (off < frame.size()) {
      ssize_t w = ::send(fd, frame.data() + off, frame.size() - off,
                         MSG_NOSIGNAL);
      if (w < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          pollfd p2{fd, POLLOUT, 0};
          if (poll(&p2, 1, cto_ms) <= 0) { close(fd); return false; }
          continue;
        }
        close(fd);
        return false;
      }
      off += (size_t)w;
    }
    auto read_exact = [&](uint8_t* out, size_t n) -> bool {
      size_t got = 0;
      while (got < n) {
        ssize_t r = ::recv(fd, out + got, n - got, 0);
        if (r > 0) { got += (size_t)r; continue; }
        if (r == 0) return false;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          pollfd p2{fd, POLLIN, 0};
          if (poll(&p2, 1, cto_ms) <= 0) return false;
          continue;
        }
        return false;
      }
      return true;
    };
    uint8_t hdr[HEADER_SIZE];
    uint8_t type;
    uint64_t a, b;
    if (!read_exact(hdr, HEADER_SIZE)) { close(fd); return false; }
    unpack_header(hdr, &type, &a, &b);
    if (type != T_HELLO_ACK || b > 4096) { close(fd); return false; }
    std::vector<uint8_t> bd(b);
    if (b && !read_exact(bd.data(), b)) { close(fd); return false; }
    out_ack->assign((char*)bd.data(), bd.size());
    *out_fd = fd;
    return true;
  }

  // A surfaced descriptor resolved (embedder's pull landed or failed):
  // release flush barriers whose snapshot it was the last member of.
  void devpull_resolve(Conn* c, uint64_t msg_id, FireList& fires) {
    c->devpull_pending.erase(msg_id);
    std::vector<uint64_t> ready;
    auto& def = c->devpull_deferred;
    for (auto it = def.begin(); it != def.end();) {
      it->second.erase(msg_id);
      if (it->second.empty()) {
        ready.push_back(it->first);
        it = def.erase(it);
      } else {
        ++it;
      }
    }
    for (uint64_t seq : ready)
      if (c->alive)
        conn_send_ctl(c, T_FLUSH_ACK, seq, 0, "", fires,
                      /*switch_after=*/false, /*sess_frame=*/true);
  }

  void on_devpull(Conn* c, uint64_t tag, const std::string& body, FireList& fires) {
    if (!devpull_cb || !c->devpull_ok) return;  // never negotiated: drop
    uint64_t msg_id = next_devpull_msg++;
    c->devpull_pending.insert(msg_id);
    uint64_t nbytes = json_num_field(body, "n");
    int rc;
    uint64_t rctx = 0;
    {
      std::lock_guard<std::mutex> g(mu);
      rc = matcher.on_remote(tag, nbytes, msg_id, c->id, &rctx);
    }
    auto cb = devpull_cb; auto ctx = devpull_cb_ctx;
    uint64_t cid = c->id;
    // Copy the body into the fire (the ctl buffer is reused immediately).
    auto shared = std::make_shared<std::string>(body);
    fires.push_back([cb, ctx, cid, tag, shared, msg_id, rc, rctx] {
      cb(ctx, cid, tag, shared->c_str(), shared->size(), msg_id, rc, rctx);
    });
  }

  // Write to the active transport: >0 bytes taken, 0 = blocked, -1 = dead.
  ssize_t conn_tx_write(Conn* c, const uint8_t* p, size_t n, FireList& fires) {
    if (c->tx_via_ring) {
      // 0 = ring full; kick_tx signals the peer with a starving doorbell
      // and its reply (after draining) re-enters kick_tx.
      ssize_t w = (ssize_t)c->sm_tx.write(p, n);
      if (w > 0) {
        bump(counters.bytes_tx, (uint64_t)w);
        bump(counters.hot_copies);  // §23 sm ring put (one slot memcpy)
      }
      return w;
    }
    bump(counters.io_syscalls);  // §23 runtime cost twin
    ssize_t w = ::send(c->fd, p, n, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) return 0;
      conn_broken(c, fires);
      return -1;
    }
    if (w > 0) bump(counters.bytes_tx, (uint64_t)w);
    return w;
  }

  void doorbell(Conn* c, FireList& fires, uint8_t val = DB_DATA) {
    if (!c->db_out.empty()) {
      if (c->db_out.find((char)val) == std::string::npos) c->db_out.push_back((char)val);
      return;
    }
    bump(counters.io_syscalls);  // §23 runtime cost twin
    ssize_t w = ::send(c->fd, &val, 1, MSG_NOSIGNAL | MSG_DONTWAIT);
    if (w == 1) return;
    if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK) {
      conn_broken(c, fires);
      return;
    }
    // Socket buffer full: queue + EPOLLOUT so the byte is never lost (a
    // starving byte is the one wakeup a sleeping producer depends on).
    c->db_out.push_back((char)val);
    if (!c->want_write) {
      c->want_write = true;
      ep_mod_conn(c);
    }
  }

  // EPOLLOUT: flush queued doorbell bytes, then retry the tx queue.
  void conn_writable(Conn* c, FireList& fires) {
    while (!c->db_out.empty()) {
      bump(counters.io_syscalls);  // §23 runtime cost twin
      ssize_t w = ::send(c->fd, c->db_out.data(), c->db_out.size(),
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w > 0) {
        c->db_out.erase(0, (size_t)w);
        continue;
      }
      if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return;
      conn_broken(c, fires);
      return;
    }
    kick_tx(c, fires);
  }

  // §24 MSG_ZEROCOPY eligibility: an armed worker, a plain data payload
  // at or above the rndv threshold, and a socket that accepted
  // SO_ZEROCOPY (probed lazily, once per conn, from here -- rails,
  // resumes, and accepts all funnel through without per-site plumbing).
  // Striped feeders are excluded: their frames interleave with T_SNACK
  // retransmits and refill in place, so the notification bookkeeping
  // would pin the wrong incarnation of the feeder's payload.
  bool zc_ready(Conn* c, const TxItem& item) {
    if (!zc_armed || !item.is_data || item.stripe || item.paylen < zc_thresh)
      return false;
    if (c->zc_state == 0) {
      int one = 1;
      c->zc_state = setsockopt(c->fd, SOL_SOCKET, SO_ZEROCOPY, &one,
                               sizeof(one)) == 0
                        ? 1
                        : -1;
    }
    return c->zc_state == 1;
  }

  // Record one successful MSG_ZEROCOPY submission: the kernel's
  // per-socket notification counter increments once per zerocopy
  // sendmsg, and the deque's TxRef keeps the payload bytes alive until
  // zc_complete_range pops it.
  void zc_track(Conn* c, const TxRef& ref) {
    ref->zc_pins++;
    c->zc_outstanding.emplace_back(c->zc_next_seq++, ref);
    bump(counters.zc_sends);
  }

  // One MSG_ZEROCOPY payload pass for the front item (its header already
  // left via the copying gather).  Returns like tcp_tx_gather: bytes
  // written, 0 = socket full, -1 = conn broke.  Fallback ladder on
  // ENOBUFS (socket optmem exhausted): retry the same slice as an
  // ordinary copying sendmsg -- the kernel's own documented advice.
  ssize_t zc_tx_send(Conn* c, FireList& fires) {
    TxRef ref = c->tx.front();
    TxItem& item = *ref;
    uint64_t po = item.off - item.header.size();
    uint64_t left = item.paylen - po;
    size_t n = left > (4u << 20) ? (4u << 20) : (size_t)left;
    struct iovec iov{(void*)(item.payload + po), n};
    msghdr msg{};
    msg.msg_iov = &iov;
    msg.msg_iovlen = 1;
    bump(counters.io_syscalls);  // §23 runtime cost twin
    ssize_t w = ::sendmsg(c->fd, &msg, MSG_NOSIGNAL | MSG_ZEROCOPY);
    if (w > 0) {
      zc_track(c, ref);
    } else if (w < 0 && errno == ENOBUFS) {
      bump(counters.io_syscalls);  // §23 runtime cost twin
      w = ::sendmsg(c->fd, &msg, MSG_NOSIGNAL);
    }
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) return 0;
      conn_broken(c, fires);
      return -1;
    }
    if (w > 0) bump(counters.bytes_tx, (uint64_t)w);
    return w;
  }

  // Gather pending tx bytes across queue items into one sendmsg: small
  // messages cost one syscall (and one TCP segment) for header+payload
  // instead of two, and bursts of messages coalesce.  Returns bytes
  // written, 0 when the socket is full, -1 when the conn broke.
  // Mirrored by the Python engine's TcpConn._gather_tx + kick_tx
  // (core/conn.py): both engines batch at most 64 iovecs / 4 MiB per
  // pass and never batch bytes past the sm transport switch point --
  // keep the two pumps in lockstep when changing either.
  // The §24 zerocopy carve-out batches a zc-eligible item's HEADER only
  // and hands its payload to zc_tx_send on the following pass -- payload
  // pages must ride their own sendmsg for the notification to map back
  // to one item.
  ssize_t tcp_tx_gather(Conn* c, FireList& fires) {
    constexpr int kMaxIov = 64;
    constexpr uint64_t kMaxBytes = 4u << 20;
    struct iovec iov[kMaxIov];
    int niov = 0;
    uint64_t bytes = 0;
    for (auto& ref : c->tx) {
      TxItem& item = *ref;
      if (niov >= kMaxIov || bytes >= kMaxBytes) break;
      bool zc = zc_ready(c, item);
      uint64_t hlen = item.header.size();
      uint64_t off = item.off;
      if (zc && niov == 0 && off >= hlen) {
        if (c->zc_skip_once) {
          c->zc_skip_once = false;
          zc = false;  // ENOBUFS fallback: this pass copies
        } else {
          return zc_tx_send(c, fires);
        }
      }
      if (off < hlen) {
        iov[niov].iov_base = (void*)(item.header.data() + off);
        iov[niov].iov_len = (size_t)(hlen - off);
        bytes += iov[niov].iov_len;
        niov++;
        off = hlen;
      }
      if (zc) break;  // payload goes zerocopy on the next pass
      if (niov < kMaxIov && off < item.total() && bytes < kMaxBytes) {
        uint64_t po = off - hlen;
        uint64_t left = item.paylen - po;
        uint64_t room = kMaxBytes - bytes;
        size_t n = (size_t)(left < room ? left : room);
        iov[niov].iov_base = (void*)(item.payload + po);
        iov[niov].iov_len = n;
        bytes += n;
        niov++;
      }
      // Never batch bytes past the sm switch point onto the socket.
      if (item.switch_after) break;
      // A stripe feeder refills in place after its chunk completes, so
      // the byte budget must never span past it (the Python pump's
      // _gather_tx carries the same rule -- keep the two in lockstep).
      if (item.stripe) break;
    }
    if (niov == 0) return 0;
    msghdr msg{};
    msg.msg_iov = iov;
    msg.msg_iovlen = (size_t)niov;
    bump(counters.io_syscalls);  // §23 runtime cost twin
    ssize_t w = ::sendmsg(c->fd, &msg, MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) return 0;
      conn_broken(c, fires);
      return -1;
    }
    if (w > 0) {
      bump(counters.bytes_tx, (uint64_t)w);
      bump(counters.gather_passes);
      bump(counters.gather_items, (uint64_t)niov);
    }
    return w;
  }

  // swpulse (§25): one send_local_us bump at the local-completion
  // transition -- a clock read + a relaxed increment, nothing else.
  // Callers guard with `!local_done`, so a session replay cannot
  // re-measure.  t_post == 0 (feeder/ctl items) records nothing.
  void pulse_local(const TxItem& item) {
    if (item.t_post > 0)
      hbump(hists.send_local_us, (uint64_t)((mono_s() - item.t_post) * 1e6));
  }

  // swpulse (§25): one park_us bump as a §18-parked send leaves the park
  // queue (drained, shed, or re-announced).
  void pulse_unpark(TxItem& item) {
    if (item.t_park > 0) {
      hbump(hists.park_us, (uint64_t)((mono_s() - item.t_park) * 1e6));
      item.t_park = 0;
    }
  }

  // A tagged (is_data) TxItem fully handed to the transport: account it
  // and record its send_done event (tag lives in the packed header).
  // `counted` makes this once-only: a session replay re-writes journaled
  // items but must not re-count them.
  void tx_item_completed(Conn* c, TxItem& item) {
    if (!item.is_data || item.counted) return;
    item.counted = true;
    bump(counters.sends_completed);
    if (trace.enabled && item.header.size() >= HEADER_SIZE) {
      uint64_t tag = 0;
      size_t toff = data_hdr_off(item);  // skip T_SEQ / T_CSUM prefixes
      memcpy(&tag, item.header.data() + toff + 1, 8);
      trace.rec(kEvSendDone, tag, c->id, item.paylen);
    }
    if (trace.enabled && c->tr_hex[0]) {
      // swscope tx ordinal: completion order IS wire order, so this
      // ordinal equals the receiver's accept ordinal for the same
      // message; `counted` above makes it once-only across replays.
      item.e2e_ord = ++c->tx_e2e;
      char reason[24];
      snprintf(reason, sizeof(reason), "%s:tx", c->tr_hex);
      trace.rec(kEvE2e, item.e2e_ord, c->id, item.paylen, reason);
    }
  }

  // swscope rx ordinal: one EV_E2E per accepted (non-dup) data frame, in
  // stream order (dup session frames drain via sess_drop/rx_skip and
  // never reach this counter).
  void rx_e2e(Conn* c, uint64_t nbytes) {
    if (!trace.enabled || !c->tr_hex[0]) return;
    char reason[24];
    snprintf(reason, sizeof(reason), "%s:rx", c->tr_hex);
    trace.rec(kEvE2e, ++c->rx_e2e, c->id, nbytes, reason);
  }

  // Credit `w` freshly-written socket bytes to the queued items in order:
  // the budget-accounting half of the TCP pump, shared verbatim by the
  // epoll core (kick_tx below) and the §24 uring core (uring_service) so
  // the two cores cannot drift on completion/release/switch semantics.
  void tcp_tx_account(Conn* c, uint64_t budget, FireList& fires) {
    while (budget > 0 && !c->tx.empty()) {
      TxRef ref = c->tx.front();  // keep alive across the pop
      TxItem& item = *ref;
      uint64_t take = item.total() - item.off;
      if (take > budget) take = budget;
      item.off += take;
      budget -= take;
      if (item.stripe && take > 0)
        stripe_first_progress(item.stripe, fires);
      if (item.is_data && item.rndv && !item.local_done &&
          item.off >= item.header.size()) {
        item.local_done = true;
        pulse_local(item);
        if (item.done) {
          auto done = item.done; auto ctx = item.ctx;
          fires.push_back([done, ctx] { done(ctx); });
        }
      }
      if (item.off >= item.total()) {
        if (item.stripe) {
          // Chunk fully on the wire: account it and refill the
          // feeder in place (work stealing); the gather pass
          // stopped at the feeder, so no later item's budget is
          // misattributed to the refilled frame.
          stripe_tx_chunk_finished(c, item, fires);
          if (!stripe_refill(c, *ref)) {
            c->feeder_live = false;
            c->tx.pop_front();
          }
          break;
        }
        if (item.is_data && !item.local_done) {
          item.local_done = true;
          pulse_local(item);
          if (item.done) {
            auto done = item.done; auto ctx = item.ctx;
            fires.push_back([done, ctx] { done(ctx); });
          }
        }
        bool flip = item.switch_after;
        tx_item_completed(c, item);
        fire_release(item, fires);
        c->tx.pop_front();
        if (flip) {
          // Switch point left the socket: later items ride the ring.
          c->tx_via_ring = true;
          break;
        }
      }
    }
  }

  void kick_tx(Conn* c, FireList& fires, bool direct = false) {
    // fd < 0: session-suspended (resume re-kicks).
    if (!c->alive || c->fd < 0) return;
    // §24 uring core: TCP-phase sends from every conn kicked this pass
    // coalesce into one batched submit (uring_service, end of the loop
    // pass).  Ring-mode conns stay on the memcpy transport below -- their
    // hot path has no per-message syscall to batch.  `direct` is the
    // service's own re-entry (and the singleton bypass), never deferred.
    if (!direct && uring.ok() && !c->tx_via_ring) {
      uring_queue(c);
      return;
    }
    uint64_t t0 = c->sm_active ? c->sm_tx.tail().load(std::memory_order_relaxed) : 0;
    bool blocked = false;
    while (!c->tx.empty() && !blocked) {
      if (!c->tx_via_ring) {
        // TCP: one gathered sendmsg per pass, then account the bytes to
        // the queued items in order.
        ssize_t w = tcp_tx_gather(c, fires);
        if (w < 0) return;  // conn_broken already ran
        if (w == 0) {
          blocked = true;
          break;
        }
        tcp_tx_account(c, (uint64_t)w, fires);
        continue;
      }
      // Ring path: stream the front item chunk-by-chunk (no syscalls).
      TxRef ref = c->tx.front();  // keep alive across the pop
      TxItem& item = *ref;
      uint64_t hlen = item.header.size();
      while (item.off < item.total()) {
        const uint8_t* p;
        size_t n;
        if (item.off < hlen) {
          p = item.header.data() + item.off;
          n = hlen - item.off;
        } else {
          uint64_t po = item.off - hlen;
          p = item.payload + po;
          uint64_t left = item.paylen - po;
          n = left > (4u << 20) ? (4u << 20) : (size_t)left;
        }
        ssize_t w = conn_tx_write(c, p, n, fires);
        if (w < 0) return;
        if (w == 0) {
          blocked = true;
          break;
        }
        item.off += (uint64_t)w;
        if (item.stripe) stripe_first_progress(item.stripe, fires);
        if (item.is_data && item.rndv && !item.local_done && item.off >= hlen) {
          item.local_done = true;
          pulse_local(item);
          if (item.done) {
            auto done = item.done; auto ctx = item.ctx;
            fires.push_back([done, ctx] { done(ctx); });
          }
        }
      }
      if (!blocked) {
        if (item.stripe) {
          // Chunk published to the ring: refill the feeder in place.
          stripe_tx_chunk_finished(c, item, fires);
          if (stripe_refill(c, item)) continue;
          c->feeder_live = false;
          c->tx.pop_front();
          continue;
        }
        if (item.is_data && !item.local_done) {
          item.local_done = true;
          pulse_local(item);
          if (item.done) {
            auto done = item.done; auto ctx = item.ctx;
            fires.push_back([done, ctx] { done(ctx); });
          }
        }
        tx_item_completed(c, item);
        fire_release(item, fires);
        c->tx.pop_front();
      }
    }
    if (blocked) {
      if (c->tx_via_ring) {
        // Blocked on the ring, not the socket (EPOLLOUT would spin).  Ask
        // the peer to reply once it drains; the starving byte doubles as
        // the data doorbell for anything published this pass.  Drop any
        // stale EPOLLOUT interest (unless doorbell() queued a byte): the
        // socket stays writable, so leaving it set would busy-spin.
        doorbell(c, fires, DB_STARVING);
        if (c->want_write && c->db_out.empty()) {
          c->want_write = false;
          ep_mod_conn(c);
        }
      } else if (!c->want_write) {
        c->want_write = true;
        ep_mod_conn(c);
      }
      return;
    }
    if (c->want_write && c->db_out.empty()) {
      c->want_write = false;
      ep_mod_conn(c);
    }
    if (c->sm_active && !c->tx_via_ring) {
      // Pre-switch TCP bytes (the HELLO_ACK) fully drained.
      c->tx_via_ring = true;
    }
    if (c->sm_active && c->sm_tx.tail().load(std::memory_order_relaxed) != t0)
      doorbell(c, fires);
  }

  // --------------------------------------------- swfast (DESIGN.md §24)
  // The uring TX core: kick_tx defers TCP-phase conns into uring_q; once
  // per event-loop pass uring_service collects every deferred conn's
  // gather into SQEs and lands them with ONE io_uring_enter.  The
  // collect/account halves are the same code both cores run
  // (uring_tx_collect mirrors tcp_tx_gather; tcp_tx_account is shared),
  // so protocol behavior -- completion order, switch points, stripe
  // refills, release discipline -- is identical under either core.

  struct UringOp {
    Conn* c = nullptr;
    bool is_zc = false;
    TxRef zc_ref;
    struct iovec iov[64];
    int niov = 0;
    msghdr mh{};
    int res = 0;
  };

  void uring_queue(Conn* c) {
    if (c->in_uring_q) return;
    c->in_uring_q = true;
    uring_q.push_back(c);
  }

  // Teardown hook: a dying conn must leave the pass's submit queue (the
  // service loop holds raw pointers, and half-open conns are deleted the
  // moment they break).
  void uring_unqueue(Conn* c) {
    if (!c->in_uring_q) return;
    c->in_uring_q = false;
    uring_q.erase(std::remove(uring_q.begin(), uring_q.end(), c),
                  uring_q.end());
  }

  // Build one conn's submission for this pass: either a gathered
  // header/ctl batch or a single zerocopy payload slice -- the same
  // item-walk rules as tcp_tx_gather (64 iovecs / 4 MiB, stop at the sm
  // switch point, stripe feeders, and zc boundaries), with the sendmsg
  // deferred to the ring.  Keep in lockstep with tcp_tx_gather.
  bool uring_tx_collect(Conn* c, UringOp& op) {
    constexpr int kMaxIov = 64;
    constexpr uint64_t kMaxBytes = 4u << 20;
    int niov = 0;
    uint64_t bytes = 0;
    for (auto& ref : c->tx) {
      TxItem& item = *ref;
      if (niov >= kMaxIov || bytes >= kMaxBytes) break;
      bool zc = zc_ready(c, item);
      uint64_t hlen = item.header.size();
      uint64_t off = item.off;
      if (zc && niov == 0 && off >= hlen) {
        if (c->zc_skip_once) {
          c->zc_skip_once = false;
          zc = false;  // ENOBUFS fallback: this pass copies
        } else {
          uint64_t po = off - hlen;
          uint64_t left = item.paylen - po;
          size_t n = left > kMaxBytes ? (size_t)kMaxBytes : (size_t)left;
          op.iov[0].iov_base = (void*)(item.payload + po);
          op.iov[0].iov_len = n;
          op.niov = 1;
          op.is_zc = true;
          op.zc_ref = ref;
          return true;
        }
      }
      if (off < hlen) {
        op.iov[niov].iov_base = (void*)(item.header.data() + off);
        op.iov[niov].iov_len = (size_t)(hlen - off);
        bytes += op.iov[niov].iov_len;
        niov++;
        off = hlen;
      }
      if (zc) break;  // payload goes zerocopy on the next pass
      if (niov < kMaxIov && off < item.total() && bytes < kMaxBytes) {
        uint64_t po = off - hlen;
        uint64_t left = item.paylen - po;
        uint64_t room = kMaxBytes - bytes;
        size_t n = (size_t)(left < room ? left : room);
        op.iov[niov].iov_base = (void*)(item.payload + po);
        op.iov[niov].iov_len = n;
        bytes += n;
        niov++;
      }
      if (item.switch_after) break;
      if (item.stripe) break;
    }
    op.niov = niov;
    return niov > 0;
  }

  // One completed (or refused) SQE: the same outcome ladder as the epoll
  // core's gather return -- EAGAIN parks on EPOLLOUT, errors break the
  // conn, bytes route through the shared tcp_tx_account.
  void uring_op_finish(UringOp& op, FireList& fires) {
    Conn* c = op.c;
    if (!c->alive || c->fd < 0) return;
    int res = op.res;
    if (res == -EAGAIN || res == -EWOULDBLOCK) {
      if (!c->want_write) {
        c->want_write = true;
        ep_mod_conn(c);
      }
      return;
    }
    if (res == -ENOBUFS && op.is_zc) {
      c->zc_skip_once = true;  // §24 ladder: next pass copies
      uring_queue(c);
      return;
    }
    if (res < 0) {
      conn_broken(c, fires);
      return;
    }
    if (res > 0) {
      bump(counters.bytes_tx, (uint64_t)res);
      if (op.is_zc) {
        zc_track(c, op.zc_ref);
      } else {
        bump(counters.gather_passes);
        bump(counters.gather_items, (uint64_t)op.niov);
      }
      tcp_tx_account(c, (uint64_t)res, fires);
    }
    if (!c->tx.empty() && !c->tx_via_ring) {
      uring_queue(c);  // more to send: next round of the service loop
    } else {
      // Drained (or flipped to the ring): the direct kick is the shared
      // epilogue -- want_write teardown, the sm flip, the doorbell.
      kick_tx(c, fires, /*direct=*/true);
    }
  }

#if SW_HAVE_IOURING
  // The batched submit: ONE io_uring_enter lands every ready conn's
  // sendmsg for the pass (the §23 ledger's uring_flush path, amortized
  // across conns).  Strictly synchronous: every SQE carries
  // MSG_DONTWAIT, so GETEVENTS with min_complete = n returns with all
  // CQEs inline and no buffer outlives the call.
  int uring_submit_wait(unsigned n) {
    unsigned done = 0;
    while (done < n) {
      bump(counters.io_syscalls);  // §23 runtime cost twin
      bump(counters.uring_submits);
      int r = io_uring_enter(uring.ring_fd, n - done, n - done,
                             IORING_ENTER_GETEVENTS);
      if (r < 0) {
        if (errno == EINTR) continue;
        return -1;
      }
      if (r == 0) return -1;  // wedged ring: treat as a core failure
      done += (unsigned)r;
    }
    return (int)done;
  }

  void uring_service(FireList& fires) {
    int guard = 0;
    while (!uring_q.empty() && ++guard <= 4096) {
      std::vector<Conn*> batch;
      batch.swap(uring_q);
      std::deque<UringOp> ops;  // stable addresses: SQEs point at mh
      for (Conn* c : batch) {
        c->in_uring_q = false;
        if (!c->alive || c->fd < 0) continue;
        if (c->tx_via_ring || c->tx.empty()) {
          // Ring-mode conns (and bare epilogue kicks) run the classic
          // pump inline -- no socket syscalls to batch there.
          kick_tx(c, fires, /*direct=*/true);
          continue;
        }
        ops.emplace_back();
        ops.back().c = c;
        if (!uring_tx_collect(c, ops.back())) ops.pop_back();
      }
      if (ops.empty()) continue;
      if (ops.size() == 1) {
        // Singleton bypass: a ring round-trip buys no batching, so the
        // classic pump keeps single-conn workers at exact epoll-core
        // syscall cost (the paired-bench parity case).
        kick_tx(ops[0].c, fires, /*direct=*/true);
        continue;
      }
      size_t done = 0;
      while (done < ops.size()) {
        unsigned chunk = 0;
        for (size_t i = done; i < ops.size(); i++) {
          io_uring_sqe* sqe = uring.get_sqe();
          if (!sqe) break;  // SQ full: flush this chunk, then continue
          UringOp& op = ops[i];
          op.mh.msg_iov = op.iov;
          op.mh.msg_iovlen = (size_t)op.niov;
          sqe->opcode = IORING_OP_SENDMSG;
          sqe->fd = op.c->fd;
          sqe->addr = (uint64_t)(uintptr_t)&op.mh;
          sqe->msg_flags = MSG_NOSIGNAL | MSG_DONTWAIT |
                           (op.is_zc ? MSG_ZEROCOPY : 0);
          sqe->user_data = (uint64_t)i;
          chunk++;
        }
        bump(counters.uring_sqes, chunk);
        if (uring_submit_wait(chunk) < 0) {
          // enter() itself failed (not an op result): abandon the core
          // for this worker; deferred conns re-kick on the classic pump.
          uring.shutdown();
          for (size_t i = done; i < ops.size(); i++)
            kick_tx(ops[i].c, fires, /*direct=*/true);
          return;
        }
        uring.reap([&](uint64_t ud, int res) {
          if (ud < ops.size()) ops[ud].res = res;
        });
        for (size_t i = done; i < done + chunk; i++)
          uring_op_finish(ops[i], fires);
        done += chunk;
      }
    }
  }
#else
  void uring_service(FireList&) {}
#endif

  // §24 MSG_ZEROCOPY completions.  Ranges complete cumulatively in seq
  // order on TCP: everything at or below `hi` is done (wrap-safe
  // signed compare; a socket wraps after 4B zerocopy sends).
  void zc_complete_range(Conn* c, uint32_t hi, FireList& fires) {
    while (!c->zc_outstanding.empty()) {
      auto& front = c->zc_outstanding.front();
      if ((int32_t)(front.first - hi) > 0) break;
      TxRef ref = front.second;
      c->zc_outstanding.pop_front();
      if (ref->zc_pins > 0) ref->zc_pins--;
      bump(counters.zc_notifies);
      // swpulse (§25): §24 kernel-pin residency, send post -> last
      // errqueue notification for the item.
      if (ref->zc_pins == 0 && ref->t_post > 0)
        hbump(hists.pin_us, (uint64_t)((mono_s() - ref->t_post) * 1e6));
      if (ref->zc_pins == 0 && ref->zc_deferred) {
        ref->zc_deferred = false;
        fire_release(*ref, fires);
      }
    }
  }

  // EPOLLERR with pins outstanding: drain the error queue.  Zerocopy
  // notifications ride it with ee_errno 0 (not a socket error); a real
  // error leaves the queue empty and surfaces on the rx path as ever.
  void zc_drain_errqueue(Conn* c, FireList& fires) {
    while (!c->zc_outstanding.empty()) {
      char cbuf[256];
      msghdr msg{};
      msg.msg_control = cbuf;
      msg.msg_controllen = sizeof(cbuf);
      bump(counters.io_syscalls);  // §23 runtime cost twin
      ssize_t r = ::recvmsg(c->fd, &msg, MSG_ERRQUEUE | MSG_DONTWAIT);
      if (r < 0) return;  // EAGAIN: drained
      for (cmsghdr* cm = CMSG_FIRSTHDR(&msg); cm; cm = CMSG_NXTHDR(&msg, cm)) {
        if (cm->cmsg_level != SOL_IP || cm->cmsg_type != IP_RECVERR) continue;
        auto* ee = (sock_extended_err*)CMSG_DATA(cm);
        if (ee->ee_origin != SO_EE_ORIGIN_ZEROCOPY) continue;
        // [ee_info, ee_data] completed; SO_EE_CODE_ZEROCOPY_COPIED just
        // means the kernel copied after all -- still a completion.
        zc_complete_range(c, ee->ee_data, fires);
      }
    }
  }

  // fd teardown with zerocopy pins in flight: the notifications can no
  // longer be read, so drop the kernel pins.  NOT force: a session
  // journal's hold_release still gates the actual release.
  void zc_abandon(Conn* c, FireList& fires) {
    while (!c->zc_outstanding.empty()) {
      TxRef ref = c->zc_outstanding.front().second;
      c->zc_outstanding.pop_front();
      ref->zc_pins = 0;
      if (ref->zc_deferred) {
        ref->zc_deferred = false;
        fire_release(*ref, fires);
      }
    }
  }

  // ----------------------------------------------------------------- rx
  // Stream-read dispatch: >0 bytes, 0 = nothing available, -1 = conn broken
  // (conn_broken already ran).  The ring has no EOF: peer death surfaces on
  // the socket (doorbell channel) in conn_readable.
  ssize_t stream_read(Conn* c, uint8_t* dst, size_t want, FireList& fires) {
    if (c->sm_active) {
      ssize_t n = c->sm_rx.read_into(dst, want);
      if (n < 0) {
        // §19: a torn/corrupt ring slot, caught at dequeue before its
        // bytes could be parsed -- poison with the stable reason.
        conn_corrupt(c, "sm slot record", fires);
        return -1;
      }
      if (n > 0) {
        c->last_rx = Clock::now();
        bump(counters.bytes_rx, (uint64_t)n);
        bump(counters.hot_copies);  // §23 sm ring take (one slot memcpy)
      }
      return n;
    }
    bump(counters.io_syscalls);  // §23 runtime cost twin
    ssize_t r = ::recv(c->fd, dst, want, 0);
    if (r > 0) {
      c->last_rx = Clock::now();
      bump(counters.bytes_rx, (uint64_t)r);
      return r;
    }
    if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return 0;
    conn_broken(c, fires);
    return -1;
  }

  void conn_readable(Conn* c, FireList& fires) {
    if (!c->sm_active) {
      pump_frames(c, fires);
      if (c->alive) sess_maybe_ack(c, fires);  // piggybacked cumulative ACK
      return;
    }
    // sm mode: the socket carries only doorbells (and EOF/RST).  Drain it,
    // pump the ring; on EOF pump once more (bytes published before the peer
    // died must still deliver -- graceful close), then break the conn.
    bool eof = false, starving = false;
    for (;;) {
      char buf[4096];
      bump(counters.io_syscalls);  // §23 runtime cost twin
      ssize_t r = ::recv(c->fd, buf, sizeof(buf), 0);
      if (r > 0) {
        c->last_rx = Clock::now();  // doorbell bytes are proof of life
        if (memchr(buf, DB_STARVING, (size_t)r)) starving = true;
        continue;
      }
      if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
      eof = true;
      break;
    }
    pump_frames(c, fires);
    if (!c->alive) return;
    if (starving) {
      // The peer's producer sleeps on a full ring.  The pump above freed
      // space (or it was already free); reply unconditionally -- our send
      // comes after the head store, so the peer's post-recv cursor reads
      // are current.
      doorbell(c, fires);
    }
    if (!c->tx.empty()) kick_tx(c, fires);  // doorbell may mean tx space freed
    if (eof && c->alive) {
      pump_frames(c, fires);
      if (c->alive) conn_broken(c, fires);
    }
  }

  void pump_frames(Conn* c, FireList& fires) {
    while (c->alive) {
      if (c->rx_skip) {
        // Duplicate sequenced frame: drain its payload to scratch without
        // touching the matcher (exactly-once delivery).
        if (c->scratch.size() < (1u << 20)) c->scratch.resize(1u << 20);
        size_t want = c->rx_skip > c->scratch.size() ? c->scratch.size()
                                                     : (size_t)c->rx_skip;
        ssize_t r = stream_read(c, c->scratch.data(), want, fires);
        if (r <= 0) return;
        if (c->csum_pend)
          c->csum_accum = crc32c(c->scratch.data(), (size_t)r, c->csum_accum);
        c->rx_skip -= (uint64_t)r;
        if (c->rx_skip == 0 && c->csum_pend) {
          // A drained frame (duplicate seq / superseded chunk) ends
          // here: verify for accounting only -- nothing was delivered.
          c->csum_pend = false;
          if (c->csum_accum != c->csum_f) bump(counters.csum_fail);
        }
        continue;
      }
      if (c->sdata_active) {
        // Striped-chunk sub-header (msg id, offset, total) accumulating
        // on this rail (DESIGN.md §17).
        ssize_t r = stream_read(c, c->sdata_sub + c->sdata_got,
                                SDATA_SUB_SIZE - c->sdata_got, fires);
        if (r <= 0) return;
        if (c->csum_pend)
          c->csum_accum = crc32c(c->sdata_sub + c->sdata_got, (size_t)r,
                                 c->csum_accum);
        c->sdata_got += (size_t)r;
        if (c->sdata_got < SDATA_SUB_SIZE) continue;
        c->sdata_active = false;
        if (c->csum_pend && c->csum_accum != c->csum_h) {
          // Routing fields (header+sub-header) cannot be trusted: a
          // NACK would carry garbage ids -- poison instead (§19).
          conn_corrupt(c, "stripe sub-header checksum", fires);
          return;
        }
        stripe_rx_resolve(c, fires);
        continue;
      }
      if (c->rx_stripe) {
        StripeAsm* a = c->rx_stripe;
        InboundMsg* m = a->msg;
        uint64_t remaining = c->rx_stripe_len - c->rx_stripe_got;
        uint8_t* target;
        size_t want;
        if (m->discard) {
          if (c->scratch.size() < (1u << 20)) c->scratch.resize(1u << 20);
          target = c->scratch.data();
          want = remaining > c->scratch.size() ? c->scratch.size()
                                               : (size_t)remaining;
        } else {
          uint64_t pos = c->rx_stripe_off + c->rx_stripe_got;
          uint8_t* base = (m->has_pr && !m->use_spill) ? m->pr.buf
                                                       : m->spill.data();
          target = base + pos;
          want = remaining > (4u << 20) ? (4u << 20) : (size_t)remaining;
        }
        ssize_t r = stream_read(c, target, want, fires);
        if (r <= 0) return;
        if (c->csum_pend)
          c->csum_accum = crc32c(target, (size_t)r, c->csum_accum);
        c->rx_stripe_got += (uint64_t)r;
        if (c->rx_stripe_got < c->rx_stripe_len) continue;
        if (c->csum_pend) {
          c->csum_pend = false;
          if (c->csum_accum != c->csum_f) {
            // Chunk payload corrupt, routing verified: NACK just this
            // chunk (§19).  The offset was never recorded in the
            // assembly, so the retransmit streams into the same sink
            // region; the conn stays healthy.
            StripeAsm* bad = c->rx_stripe;
            uint64_t bad_off = c->rx_stripe_off;
            c->rx_stripe = nullptr;
            c->rx_stripe_got = 0;
            bump(counters.csum_fail);
            conn_send_ctl(c, T_SNACK, bad->msg_id, bad_off, "", fires);
            continue;
          }
        }
        stripe_rx_chunk_done(c, fires);
        continue;
      }
      if (c->rx_msg) {
        InboundMsg* m = c->rx_msg;
        uint64_t remaining = m->length - m->received;
        uint8_t* target;
        size_t want;
        if (m->discard) {
          if (c->scratch.size() < (1u << 20)) c->scratch.resize(1u << 20);
          target = c->scratch.data();
          want = remaining > c->scratch.size() ? c->scratch.size() : (size_t)remaining;
        } else if (m->has_pr && !m->use_spill) {
          target = m->pr.buf + m->received;
          want = remaining > (4u << 20) ? (4u << 20) : (size_t)remaining;
        } else {
          target = m->spill.data() + m->received;
          want = remaining > (4u << 20) ? (4u << 20) : (size_t)remaining;
        }
        ssize_t r = stream_read(c, target, want, fires);
        if (r <= 0) return;
        if (c->csum_pend)
          c->csum_accum = crc32c(target, (size_t)r, c->csum_accum);
        m->received += (uint64_t)r;
        if (m->received >= m->length) {
          if (c->csum_pend) {
            // Verified BEFORE the matcher completes the receive: corrupt
            // bytes must never reach user code as good data (§19).
            c->csum_pend = false;
            if (c->csum_accum != c->csum_f) {
              conn_corrupt(c, "payload checksum (DATA)", fires);
              return;
            }
          }
          uint64_t mlen = m->length;
          {
            std::lock_guard<std::mutex> g(mu);
            matcher.on_complete(m, fires);
          }
          c->rx_msg = nullptr;
          c->rx_msg_unowned = false;
          rx_e2e(c, mlen);
          sess_commit(c);
        }
        continue;
      }
      if (c->ctl_need) {
        size_t have = c->ctl_body.size();
        size_t want = c->ctl_need - have;
        uint8_t tmp[4096];
        ssize_t r = stream_read(c, tmp, want > sizeof(tmp) ? sizeof(tmp) : want, fires);
        if (r <= 0) return;
        if (c->csum_pend)
          c->csum_accum = crc32c(tmp, (size_t)r, c->csum_accum);
        c->ctl_body.append((char*)tmp, (size_t)r);
        if (c->ctl_body.size() < c->ctl_need) continue;
        if (c->csum_pend) {
          c->csum_pend = false;
          if (c->csum_accum != c->csum_f) {
            conn_corrupt(c, "control body checksum", fires);
            return;
          }
        }
        int t = c->ctl_type;
        uint64_t ctl_a = c->ctl_a;
        std::string body = std::move(c->ctl_body);
        c->ctl_body.clear();
        c->ctl_need = 0;
        c->ctl_type = 0;
        c->ctl_a = 0;
        // Ctl bodies are JSON OBJECTS by contract: reject non-object
        // shapes ([] / "x" / 42 / nesting bombs) exactly as the Python
        // engine's unpack_json_body does (one rule, both engines --
        // PR-14 wirefuzz hardening).  Braced-but-invalid JSON stays
        // tolerated here: the per-field extractor shrugs where
        // json.loads raises, the one documented residual asymmetry.
        size_t b0 = body.find_first_not_of(" \t\r\n");
        size_t b1 = body.find_last_not_of(" \t\r\n");
        if (b0 == std::string::npos || body[b0] != '{' || body[b1] != '}') {
          conn_broken(c, fires);
          return;
        }
        // swcheck: state(estab, HELLO, estab|down)
        if (t == T_HELLO) on_hello(c, body, fires);
        else if (t == T_DEVPULL) {
          // swcheck: state(estab, DEVPULL, estab|down)
          on_devpull(c, ctl_a, body, fires);
          rx_e2e(c, body.size());
          sess_commit(c);
        } else if (t == T_RTS) {
          on_rts(c, ctl_a, body, fires);
        }
        // T_HELLO_ACK handled synchronously during client connect
        continue;
      }
      ssize_t r = stream_read(c, c->hdr + c->hdr_got, HEADER_SIZE - c->hdr_got, fires);
      if (r <= 0) return;
      if (c->csum_pend)
        // The protected frame's header is covered too: a corrupted
        // length field must never desync the stream (§19).
        c->csum_accum = crc32c(c->hdr + c->hdr_got, (size_t)r, c->csum_accum);
      c->hdr_got += (size_t)r;
      if (c->hdr_got < HEADER_SIZE) continue;
      c->hdr_got = 0;
      uint8_t type;
      uint64_t a, b;
      unpack_header(c->hdr, &type, &a, &b);
      // swrefine: one protocol event per dispatched inbound frame,
      // BEFORE the §19 gate and the dispatch switch -- the monitor sees
      // exactly what the parser saw (DESIGN.md §22; core/conn.py
      // _pump_frames taps the same point).
      trace.proto_rx(c->id, type);
      if (c->csum_ok) {
        // §19 verification gate, BEFORE dispatch: arm on T_CSUM, require
        // one for every protected frame, validate routing fields the
        // moment they are parsed.
        // swcheck: state(estab, CSUM, estab|down)
        if (type == T_CSUM) {
          if (c->csum_pend) {
            conn_corrupt(c, "nested checksum prefix", fires);
            return;
          }
          c->csum_pend = true;
          c->csum_f = (uint32_t)a;
          c->csum_h = (uint32_t)b;
          c->csum_accum = 0;
          continue;
        }
        if (!csum_exempt(type)) {
          if (!c->csum_pend) {
            conn_corrupt(c, "frame without checksum", fires);
            return;
          }
          if (type != T_SDATA && c->csum_accum != c->csum_h) {
            conn_corrupt(c, "frame header checksum", fires);
            return;
          }
          bool body_follows =
              type == T_SDATA || (csum_body(type) && b > 0);
          if (!body_follows) {
            // Header-only frame: the header IS the frame.
            c->csum_pend = false;
            if (c->csum_accum != c->csum_f) {
              conn_corrupt(c, "frame checksum", fires);
              return;
            }
          }
        }
      }
      switch (type) {
        // swcheck: state(estab, DATA, estab|down)
        case T_DATA: {
          if (c->sess_drop) {
            c->sess_drop = false;
            if (b) {
              c->rx_skip = b;
              if (c->fc_ok)
                // The dup was re-debited against the fresh window at
                // the sender's resume: grant it back (no memory held
                // -- credit conservation, DESIGN.md §18).
                conn_send_ctl(c, T_CREDIT, b, 0, "", fires);
            }
            break;
          }
          bool spilled = false, overload = false;
          {
            std::lock_guard<std::mutex> g(mu);
            InboundMsg* m = matcher.on_start(a, b, fires);
            spilled = b > 0 && m->use_spill && !m->has_pr && !m->discard;
            // Tracked only when §18 is in play (fc negotiated or the
            // cap armed): the seed path must not pay a pending-grant
            // push per unexpected message.
            if (spilled && (c->fc_ok || c->unexp_cap)) {
              // Unexpected spill: charge this conn's window accounting;
              // the matcher returns the grant when the bytes leave the
              // queue (fc_release).
              matcher.fc_track(m, c->id, c->fc_rx_gen, b);
              c->fc_unexp += b;
              // Per-conn cap: the offender is the conn whose own
              // un-granted residency crossed the line (total bound =
              // cap x live conns), never an innocent peer.
              overload = c->unexp_cap && c->fc_unexp > c->unexp_cap;
            }
            if (b == 0) {
              matcher.on_complete(m, fires);
            } else {
              c->rx_msg = m;
              // Probe records live in no matcher queue: this conn owns them
              // (close must free them without touching freed matcher state).
              c->rx_msg_unowned = (a == Matcher::kProbeTag);
            }
          }
          if (overload) {
            // STARWAY_UNEXP_BYTES breaker: reset this conn instead of
            // letting the process OOM (last resort for peers that
            // never negotiated fc).
            SW_DEBUG("unexpected-queue cap exceeded; resetting conn %llu",
                     (unsigned long long)c->id);
            conn_broken(c, fires);
            return;
          }
          if (b == 0) {
            rx_e2e(c, 0);
            sess_commit(c);
          } else if (c->fc_ok && !spilled) {
            // Matched at header (streams into the posted buffer) or
            // probe-discarded: no unexpected memory is held, so the
            // sender's debit returns immediately.
            conn_send_ctl(c, T_CREDIT, b, 0, "", fires);
          }
          break;
        }
        // swcheck: state(estab, FLUSH, estab)
        case T_FLUSH:
          if (c->sess_drop) {
            c->sess_drop = false;
            break;
          }
          sess_commit(c);
          if (!c->devpull_pending.empty()) {
            // Descriptors preceding this barrier are unresolved: withhold
            // the ACK until their pulls land (snapshot, so descriptors
            // arriving after the barrier cannot extend the wait).
            c->devpull_deferred.emplace_back(a, c->devpull_pending);
            // Force-start any §18 rendezvous offer still waiting for a
            // matching receive (spill) so the deferred ACK can resolve
            // -- the Python engine's _force_start_pulls twin.
            for (auto& [mid, m] : c->fc_rx)
              if (!m->rts_started && !m->has_pr) fc_start_rx(c, m, fires);
          } else {
            conn_send_ctl(c, T_FLUSH_ACK, a, 0, "", fires,
                          /*switch_after=*/false, /*sess_frame=*/true);
          }
          break;
        // swcheck: state(estab, FLUSH_ACK, estab)
        case T_FLUSH_ACK:
          if (c->sess_drop) {
            c->sess_drop = false;
            break;
          }
          sess_commit(c);
          on_flush_ack(c, a, fires);
          break;
        // swcheck: state(estab, SEQ, estab|down)
        case T_SEQ:
          if (!sess_on_seq(c, a, fires)) return;
          break;
        // swcheck: state(estab, ACK, estab)
        case T_ACK:
          if (c->sess) sess_on_ack(c, a, fires);
          break;
        // swcheck: state(estab, BYE, estab|expired)
        case T_BYE:
          // Peer's clean local close on a session conn: the session is
          // over -- the imminent EOF must take the seed/keepalive death
          // contract (prompt "not connected", no fault dump), not a
          // grace-window suspend + redial.
          if (c->sess && !c->sess->expired) {
            c->sess->expired = true;
            sessions.erase(c->sess->id);
          }
          break;
        // swcheck: state(estab, SDATA, estab|down)
        case T_SDATA:
          // A body not longer than the sub-header is a protocol
          // violation: no sender emits zero-length chunks, and a
          // zero-length chunk read misparsed as transport EOF here
          // while the Python sm path stalled forever (wirefuzz seed).
          if (b <= SDATA_SUB_SIZE) {
            conn_broken(c, fires);  // sub-header promised, not present
            return;
          }
          c->sdata_active = true;
          c->sdata_got = 0;
          c->sdata_tag = a;
          c->sdata_len = b;
          break;
        // swcheck: state(estab, SACK, estab)
        case T_SACK: {
          if (fc_on_sack(c, a, fires)) break;
          Conn* root = stripe_root(c);
          stripe_on_sack(root, a, fires);
          break;
        }
        // swcheck: state(estab, SNACK, estab)
        case T_SNACK:
          // §19 chunk-level retransmit request from the receiver.
          on_snack(c, a, b, fires);
          break;
        // swcheck: state(estab, CREDIT, estab)
        case T_CREDIT:
          fc_on_credit(c, a, fires);
          break;
        // swcheck: state(estab, CTS, estab)
        case T_CTS:
          fc_on_cts(c, a, fires);
          break;
        // swcheck: state(estab, PING, estab)
        case T_PING:
          // Liveness probe: answer immediately (stream_read already
          // refreshed last_rx, so inbound PINGs also prove the peer
          // alive).  A timestamped PING gets its echo + our own clock
          // reading -- the swscope sample channel (frames.py).
          conn_send_ctl(c, T_PONG, a, now_ns(), "", fires);
          break;
        // swcheck: state(estab, PONG, estab)
        case T_PONG:
          // Timestamped PONG: one NTP-style clock sample for this peer
          // (offset = t_peer - (t_tx + rtt/2), error rtt/2).  Zero
          // fields mean an old peer's plain probe answer.
          if (a && b) {
            uint64_t now = now_ns();
            if (now >= a) {
              uint64_t rtt = now - a;
              uint64_t err_us = rtt / 2000;
              if (err_us < 1) err_us = 1;
              int64_t off_us =
                  ((int64_t)b - (int64_t)(a + rtt / 2)) / 1000;
              if (c->clock_err_us == 0 || err_us < c->clock_err_us) {
                c->clock_off_us = off_us;
                c->clock_err_us = err_us;
              }
              if (trace.enabled && c->tr_hex[0]) {
                char reason[48];
                snprintf(reason, sizeof(reason), "%s:%lld:%llu", c->tr_hex,
                         (long long)off_us, (unsigned long long)err_us);
                trace.rec(kEvClock, 0, c->id, 0, reason);
              }
            }
          }
          break;  // proof of life recorded by stream_read
        case T_HELLO:
        // swcheck: state(estab, HELLO_ACK, estab|down)
        case T_HELLO_ACK:
        case T_DEVPULL:
        case T_RTS:
          // A ctl frame's JSON body is small and never empty: b == 0
          // was silently dropped here (ctl_need = 0 never entered the
          // body state) while the Python engine's 0-byte read broke or
          // stalled the conn, and an unchecked length accumulates
          // attacker-sized bodies -- both are protocol violations now,
          // in BOTH engines (frames.CTL_MAX; wirefuzz corpus seeds).
          if (b == 0 || b > CTL_MAX) {
            conn_broken(c, fires);
            return;
          }
          if (type == T_DEVPULL && c->sess_drop) {
            c->sess_drop = false;
            c->rx_skip = b;
            break;
          }
          c->ctl_type = type;
          c->ctl_need = (size_t)b;
          c->ctl_a = a;
          break;
        // swcheck: state(estab, OTHER, down)
        default:
          conn_broken(c, fires);
          return;
      }
    }
  }

  // -------------------------------------------------------------- flush
  void start_flush(const Op& op, FireList& fires) {
    std::vector<Conn*> candidates;
    {
      std::lock_guard<std::mutex> g(mu);
      if (op.conn_scoped) {
        auto it = conns.find(op.conn_id);
        if (it != conns.end()) candidates.push_back(it->second);
      } else {
        for (auto& [id, c] : conns) candidates.push_back(c);
      }
    }
    // Secondary rails are never flush targets: they carry only chunk
    // traffic, and striped delivery is covered by the SACK waits below.
    candidates.erase(
        std::remove_if(candidates.begin(), candidates.end(),
                       [](Conn* c) { return c->rail_parent != 0; }),
        candidates.end());
    for (Conn* c : candidates) {
      if (!c->alive && c->dirty) {
        // An expired session owns the failure reason (DESIGN.md §14).
        const char* reason = c->sess_fail
            ? c->sess_fail
            : "Endpoint is not connected (peer reset before flush)";
        auto fail = op.fail; auto ctx = op.ctx;
        trace.rec(kEvOpFail, 0, c->id, 0, reason);
        if (fail) fires.push_back([fail, ctx, reason] { fail(ctx, reason); });
        return;
      }
    }
    auto* rec = new FlushRec();
    rec->done = op.done;
    rec->fail = op.fail;
    rec->ctx = op.ctx;
    for (Conn* c : candidates) {
      if (!c->alive) continue;
      uint64_t seq = ++c->flush_seq;
      rec->waits[c->id] = seq;
      c->flush_marks[seq] = c->data_counter;
      if (stripe_has_unsacked(c, c->next_stripe_msg - 1))
        rec->stripe_waits[c->id] = c->next_stripe_msg - 1;
      conn_send_ctl(c, T_FLUSH, seq, 0, "", fires,
                    /*switch_after=*/false, /*sess_frame=*/true);
    }
    flushes.push_back(rec);
    try_complete_flush(rec, fires);
  }

  void on_flush_ack(Conn* c, uint64_t seq, FireList& fires) {
    if (seq > c->flush_acked) c->flush_acked = seq;
    auto it = c->flush_marks.find(seq);
    if (it != c->flush_marks.end()) {
      if (it->second == c->data_counter) c->dirty = false;
      c->flush_marks.erase(it);
    }
    auto snapshot = flushes;
    for (auto* rec : snapshot) try_complete_flush(rec, fires);
  }

  void try_complete_flush(FlushRec* rec, FireList& fires) {
    if (rec->completed) return;
    bool pending = false, dead = false;
    // A session that expired (rather than a bare reset) owns the failure
    // reason: "session expired" instead of "not connected".
    const char* dead_reason = "Endpoint is not connected (peer reset during flush)";
    for (auto& [cid, seq] : rec->waits) {
      auto it = conns.find(cid);
      if (it == conns.end()) continue;
      Conn* c = it->second;
      if (c->flush_acked < seq) {
        if (!c->alive) {
          dead = true;
          if (c->sess_fail) dead_reason = c->sess_fail;
        } else {
          pending = true;
        }
      }
    }
    for (auto& [cid, watermark] : rec->stripe_waits) {
      auto it = conns.find(cid);
      if (it == conns.end()) continue;
      Conn* c = it->second;
      if (stripe_has_unsacked(c, watermark)) {
        if (!c->alive) {
          dead = true;
          if (c->sess_fail) dead_reason = c->sess_fail;
        } else {
          pending = true;
        }
      }
    }
    if (dead) {
      rec->completed = true;
      remove_flush(rec);
      trace.rec(kEvOpFail, 0, 0, 0, dead_reason);
      auto fail = rec->fail; auto ctx = rec->ctx;
      if (fail) fires.push_back([fail, ctx, dead_reason] { fail(ctx, dead_reason); });
      delete rec;
    } else if (!pending) {
      rec->completed = true;
      remove_flush(rec);
      bump(counters.flushes_completed);
      // swpulse (§25): barrier post -> all-target acknowledgement.
      hbump(hists.flush_us, (uint64_t)((mono_s() - rec->born) * 1e6));
      trace.rec(kEvFlushDone);
      auto done = rec->done; auto ctx = rec->ctx;
      if (done) fires.push_back([done, ctx] { done(ctx); });
      delete rec;
    }
  }

  void remove_flush(FlushRec* rec) {
    for (auto it = flushes.begin(); it != flushes.end(); ++it)
      if (*it == rec) {
        flushes.erase(it);
        return;
      }
  }

  // --------------------------------------------------------- conn death
  void conn_broken(Conn* c, FireList& fires) {
    if (!c->alive) return;
    // With a live session (STARWAY_SESSION negotiated via "sess"), the
    // conn SUSPENDS instead of failing: queues/journal/flush bookkeeping
    // survive, the client redials under backoff, and in-flight ops
    // complete late after the resume replay (DESIGN.md §14).  Only
    // session expiry falls through to terminal teardown.
    if (c->sess && !c->sess->expired && !c->sess->suspended &&
        status.load() == ST_RUNNING) {
      trace.rec(kEvConnDown, 0, c->id);
      sess_suspend(c, fires);
      return;
    }
    // swrefine: terminal transport death (the suspend path above
    // records "lost" instead; DESIGN.md §22).
    trace.proto_ev(c->id, "down");
    // With liveness detection active (STARWAY_KEEPALIVE > 0) on a
    // ka-negotiated conn, the user opted out of recvs-pend-forever:
    // whatever killed the conn, the receive it was streaming into fails,
    // and once no alive conns remain every queued receive fails too
    // (stable "not connected" keyword; the Python engine's _conn_broken
    // carries the identical branch).
    bool ka_live = ka_interval > 0 && c->ka_ok;
    sw_fail_cb stranded_fail = nullptr;
    void* stranded_ctx = nullptr;
    if (ka_live && c->rx_msg) {
      // Under mu: an app-thread sw_recv can be claiming this very in-flight
      // message (Matcher::post_recv writes m->pr / has_pr under mu).
      std::lock_guard<std::mutex> g(mu);
      if (c->rx_msg->has_pr && !c->rx_msg->complete) {
        stranded_fail = c->rx_msg->pr.fail;
        stranded_ctx = c->rx_msg->pr.ctx;
        c->rx_msg->has_pr = false;  // purge below then drops the partial whole
      }
    }
    c->alive = false;
    ep_del(c->fd);
    uring_unqueue(c);
    zc_abandon(c, fires);  // §24: the fd dies, kernel pins with it
    trace.rec(kEvConnDown, 0, c->id);
    // A §19 poison owns the cancel reason: in-flight ops report
    // "corrupt", not a generic cancel (core/conn.py mark_dead twin).
    const char* reason = c->poison ? c->poison : kCancelled;
    sess_cancel_terminal(c, fires, reason);
    fc_cancel_terminal(c, fires, reason);
    for (auto& ref : c->tx) {
      TxItem& item = *ref;
      if (item.is_data && !item.local_done && item.fail) {
        item.local_done = true;
        auto fail = item.fail; auto ctx = item.ctx;
        bump(counters.ops_cancelled);
        fires.push_back([fail, ctx, reason] { fail(ctx, reason); });
      }
      fire_release(item, fires, /*force=*/true);
    }
    drop_feeder_holds(c, fires);
    c->tx.clear();
    if (c->rx_msg) {
      std::lock_guard<std::mutex> g(mu);
      matcher.purge_inflight(c->rx_msg);
      c->rx_msg = nullptr;
      c->rx_msg_unowned = false;
    }
    close(c->fd);
    c->fd = -1;
    c->feeder_live = false;
    c->drop_sm();
    {
      std::lock_guard<std::mutex> g(mu);
      matcher.purge_remote_conn(c->id);
    }
    stripe_terminal(c, reason, fires);
    if (c->rail_parent) {
      // A secondary lane died: the endpoint survives; its claimed-but-
      // unacked chunks re-queue onto the surviving lanes.
      Conn* root = conn_by_id(c->rail_parent);
      if (root && root->alive) stripe_rail_lost(root, c->id, fires);
    }
    for (uint64_t rid : std::vector<uint64_t>(c->rails)) {
      // The primary died terminally: its rails are meaningless.
      Conn* r = conn_by_id(rid);
      if (r && r->alive) conn_broken(r, fires);
    }
    c->rails.clear();
    bool was_half_open = half_open.erase(c) > 0;
    auto snapshot = flushes;
    for (auto* rec : snapshot) try_complete_flush(rec, fires);
    if (ka_live) {
      std::string reason =
          std::string(kNotConnected) + " (peer lost; liveness detection active)";
      if (stranded_fail) {
        fires.push_back([stranded_fail, stranded_ctx, reason] {
          stranded_fail(stranded_ctx, reason.c_str());
        });
      }
      bool any_alive = false;
      {
        std::lock_guard<std::mutex> g(mu);
        for (auto& [id, cc] : conns)
          if (cc->alive) { any_alive = true; break; }
        if (!any_alive) matcher.fail_pending(reason, fires);
      }
    }
    if (was_half_open) delete c;  // never reached conns registry
  }

  void conn_close_local(Conn* c, FireList& fires) {
    if (!c->alive) return;
    bool abort = c->has_unfinished_data();
    if (c->sess && !c->sess->suspended && !c->sess->expired && !abort &&
        c->fd >= 0 && (c->tx.empty() || c->tx.front()->off == 0)) {
      // Clean close on a session conn: tell the peer the session is over
      // (T_BYE) so it fails over to the seed death contract instead of
      // suspending for the grace window.  Best-effort -- a lost BYE only
      // costs the peer the grace-expiry fallback.
      uint8_t bye[2 * HEADER_SIZE];
      pack_header(bye + HEADER_SIZE, T_BYE, 0, 0);
      size_t bye_off = HEADER_SIZE, bye_n = HEADER_SIZE;
      if (c->csum_ok) {
        // §19: even the goodbye is checksummed (uniform "every frame").
        uint32_t ch = crc32c(bye + HEADER_SIZE, HEADER_SIZE, 0);
        pack_header(bye, T_CSUM, ch, ch);
        bye_off = 0;
        bye_n = 2 * HEADER_SIZE;
      }
      (void)!send(c->fd, bye + bye_off, bye_n, MSG_NOSIGNAL | MSG_DONTWAIT);
    }
    sess_cancel_terminal(c, fires, kCancelled);
    fc_cancel_terminal(c, fires, kCancelled);
    for (auto& ref : c->tx) {
      TxItem& item = *ref;
      if (item.is_data && !item.local_done && item.fail) {
        item.local_done = true;
        auto fail = item.fail; auto ctx = item.ctx;
        bump(counters.ops_cancelled);
        fires.push_back([fail, ctx] { fail(ctx, kCancelled); });
      }
      fire_release(item, fires, /*force=*/true);
    }
    drop_feeder_holds(c, fires);
    c->tx.clear();
    c->alive = false;
    ep_del(c->fd);
    uring_unqueue(c);
    zc_abandon(c, fires);  // §24: the fd dies, kernel pins with it
    if (c->rx_msg) {
      // cancel_all already ran (do_close order) and freed every record the
      // matcher owns -- dereferencing those here would be use-after-free.
      // The one record it cannot own is a probe mid-drain (never queued
      // anywhere; flagged at header time): free it or it leaks.
      if (c->rx_msg_unowned) delete c->rx_msg;
      c->rx_msg = nullptr;
    }
    if (abort) {
      // RST: a partially-written message must not look deliverable.
      struct linger lg { 1, 0 };
      setsockopt(c->fd, SOL_SOCKET, SO_LINGER, &lg, sizeof(lg));
    }
    close(c->fd);
    c->fd = -1;
    c->feeder_live = false;
    c->drop_sm();
    stripe_terminal(c, kCancelled, fires, /*purge_rx=*/false);
  }

  // -------------------------------------------------------------- hello
  void on_hello(Conn* c, const std::string& body, FireList& fires) {
    c->peer_name = json_field(body, "worker_id");
    std::string mode = json_field(body, "mode");
    if (!mode.empty()) c->mode = mode;
    if (c->mode == "address") {
      c->local_addr.clear();
      c->remote_addr.clear();
      c->local_port = c->remote_port = 0;
    }
    c->handshaken = true;
    half_open.erase(c);
    std::string rail_of = json_field(body, "rail_of");
    if (!rail_of.empty()) {
      // Secondary-lane attach (DESIGN.md §17): adopt the conn into the
      // existing endpoint's rail set -- no accept callback, no new
      // endpoint, no sm/session negotiation.
      on_rail_hello(c, rail_of, body, fires);
      return;
    }
    // Resilient-session handshake (STARWAY_SESSION): a resume dial adopts
    // the new socket into the suspended conn; a fresh offer registers a
    // new session.  Session conns never take the sm upgrade (the rings
    // are a per-incarnation transport with no replay journal).
    bool sess_offered = session_enabled() &&
                        json_field(body, "sess") == "ok" &&
                        !json_field(body, "sess_id").empty();
    if (sess_offered && sess_hello(c, body, fires))
      return;  // resumed onto the suspended conn; this wrapper consumed
    // Shared-memory offer: map + validate, confirm in the ACK; any failure
    // silently stays on TCP (mirrors core/engine.py ServerWorker._on_hello).
    SmSegment* seg = nullptr;
    if (sm_enabled() && !sess_offered) {
      std::string key = json_field(body, "sm_key");
      if (!key.empty()) {
        uint64_t nonce = strtoull(json_field(body, "sm_nonce").c_str(), nullptr, 16);
        uint64_t rsz = strtoull(json_field(body, "sm_ring").c_str(), nullptr, 10);
        seg = SmSegment::attach(key, nonce, rsz);
      }
    }
    // §19 integrity negotiation, decided BEFORE the sm adopt below: the
    // rings' slot-record framing must be agreed before any ring byte.
    c->csum_ok = integrity_enabled() && !json_field(body, "csum").empty();
    if (seg) c->adopt_sm(seg, /*creator=*/false, /*defer_tx=*/true);
    {
      std::lock_guard<std::mutex> g(mu);
      conns[c->id] = c;
    }
    if (devpull_advertise && !json_field(body, "cudaipc").empty()) {
      c->cudaipc_peer = json_field(body, "cudaipc");
      c->devpull_ok = true;
    }
    if (json_field(body, "ka") == "ok") c->ka_ok = true;  // liveness capability
    if (!json_field(body, "rails").empty()) c->rails_ok = true;
    c->unexp_cap = unexp_cap_env();
    uint64_t fc_w = fc_window_env();
    if (fc_w > 0) {
      // Receiver-driven flow control (DESIGN.md §18): adopt the
      // connector's advertised window for OUR sends, answer with ours.
      uint64_t peer_w = strtoull(json_field(body, "fc").c_str(), nullptr, 10);
      if (peer_w > 0) {
        c->fc_ok = true;
        c->fc_window = peer_w;
        c->fc_credits = (int64_t)peer_w;
      }
    }
    if (trace.enabled) {
      // swscope stitching: adopt the connector's trace-conn id so both
      // rings tag this conn's EV_E2E events identically (DESIGN.md §15).
      std::string tr = json_field(body, "tr");
      if (!tr.empty() && tr.size() < sizeof(c->tr_hex))
        snprintf(c->tr_hex, sizeof(c->tr_hex), "%s", tr.c_str());
    }
    std::string sess_ext;
    if (c->sess)
      sess_ext = std::string(", \"sess\": \"ok\", \"sess_epoch\": \"") +
                 c->sess->epoch + "\", \"sess_ack\": \"0\"";
    std::string ack = std::string("{\"worker_id\": \"") + worker_id + "\"" +
                      (seg ? ", \"sm\": \"ok\"" : "") +
                      (c->devpull_ok ? ", \"cudaipc\": \"" + cudaipc_id + "\""
                                     : "") +
                      (c->ka_ok ? ", \"ka\": \"ok\"" : "") +
                      (c->rails_ok ? ", \"rails\": \"ok\"" : "") +
                      (c->fc_ok ? ", \"fc\": \"" + std::to_string(fc_w) + "\""
                                : "") +
                      (c->csum_ok ? ", \"csum\": \"ok\"" : "") +
                      (c->tr_hex[0] ? ", \"tr\": \"ok\"" : "") + sess_ext + "}";
    // The ACK is the transport switch point (see TxItem::switch_after).
    conn_send_ctl(c, T_HELLO_ACK, 0, ack.size(), ack, fires,
                  /*switch_after=*/seg != nullptr);
    trace.rec(kEvConnUp, 0, c->id);
    if (accept_cb) {
      auto cb = accept_cb; auto ctx = accept_ctx; uint64_t id = c->id;
      fires.push_back([cb, ctx, id] { cb(ctx, id); });
    }
  }

  // ---------------------------------------------------------- deadlines
  // Arm a deadline for an op (thread-safe; caller wakes the engine).
  void add_timer(Timer::Kind kind, void* ctx, double timeout_s) {
    std::lock_guard<std::mutex> g(mu);
    timers.push_back(Timer{
        Clock::now() + std::chrono::duration_cast<Clock::duration>(
                           std::chrono::duration<double>(timeout_s)),
        kind, ctx});
  }

  // epoll_wait timeout to the earliest timer / keepalive tick (ms), -1 when
  // neither is armed.
  int poll_timeout_ms() {
    std::lock_guard<std::mutex> g(mu);
    bool have = false;
    Clock::time_point next{};
    for (auto& t : timers)
      if (!have || t.when < next) { next = t.when; have = true; }
    if (ka_interval > 0 && (!have || next_ka < next)) {
      next = next_ka;
      have = true;
    }
    if (!have) return -1;
    // Round UP: truncating the sub-millisecond tail to 0 would busy-spin
    // epoll until the timer lands (check_timers finds nothing due yet).
    auto us = std::chrono::duration_cast<std::chrono::microseconds>(
                  next - Clock::now()).count();
    auto ms = (us + 999) / 1000;
    if (ms < 0) ms = 0;
    if (ms > 60000) ms = 60000;
    return (int)ms;
  }

  void check_timers(FireList& fires) {
    auto now = Clock::now();
    std::vector<Timer> due;
    {
      std::lock_guard<std::mutex> g(mu);
      for (auto it = timers.begin(); it != timers.end();) {
        if (it->when <= now) {
          due.push_back(*it);
          it = timers.erase(it);
        } else {
          ++it;
        }
      }
    }
    for (auto& t : due) expire_op(t, fires);
    if (ka_interval > 0 && now >= next_ka) {
      next_ka = now + std::chrono::duration_cast<Clock::duration>(
                          std::chrono::duration<double>(ka_interval));
      ka_tick(fires);
    }
  }

  // ------------------------------------- §25 swpulse stall sentinel
  //
  // Engine-thread self-detection, armed only by STARWAY_STALL_MS (the
  // env-unset loop takes zero sentinel branches past one double test per
  // pass).  The telemetry thread (core/telemetry.py _stall_tick) watches
  // this worker's stall_alerts delta and reshapes the ring's EV_STALL
  // records into the unified report stream -- so the alert encoding
  // (conn, nbytes = age ms, reason = kStallReasons entry) is contract
  // surface with the Python engine's Worker.stall_scan.

  // Sum of every counter except stall_alerts: any movement between scans
  // clears suspicion (bytes_tx/rx are in here, so a long streaming
  // transfer registers progress and never false-alarms).
  uint64_t progress_sum() {
    Counters& c = counters;
    return c.sends_posted.load() + c.sends_completed.load() +
           c.recvs_posted.load() + c.recvs_completed.load() +
           c.flushes_posted.load() + c.flushes_completed.load() +
           c.ops_timed_out.load() + c.ops_cancelled.load() +
           c.bytes_tx.load() + c.bytes_rx.load() +
           c.gather_passes.load() + c.gather_items.load() +
           c.staging_hits.load() + c.staging_misses.load() +
           c.ka_misses.load() + c.reconnects.load() +
           c.sessions_resumed.load() + c.frames_replayed.load() +
           c.dup_frames_dropped.load() +
           c.acks_tx.load() + c.acks_rx.load() +
           c.stripe_chunks_tx.load() + c.stripe_chunks_rx.load() +
           c.rail_resteals.load() +
           c.sends_parked.load() + c.sheds.load() +
           c.csum_fail.load() + c.chunk_retx.load() +
           c.reshard_bytes.load() + c.reshard_rounds.load() +
           c.io_syscalls.load() + c.hot_copies.load() +
           c.uring_submits.load() + c.uring_sqes.load() +
           c.zc_sends.load() + c.zc_notifies.load() +
           c.busypoll_hits.load();
  }

  // One sentinel scan: flag no-progress conditions older than stall_s.
  // The Python engine's Worker.stall_scan is the twin -- same conditions,
  // same reason vocabulary, same once-until-cleared dedup.
  void stall_tick() {
    double now = mono_s();
    uint64_t prog = progress_sum();
    bool progressed = prog != stall_prog;
    stall_prog = prog;
    struct Alert { const char* reason; uint64_t conn, age_ms; };
    std::vector<Alert> alerts;
    std::set<std::pair<const void*, uint64_t>> live;
    if (!progressed && status.load() == ST_RUNNING) {
      auto flag = [&](const char* reason, uint64_t key_id, uint64_t conn,
                      double age) {
        auto key = std::make_pair((const void*)reason, key_id);
        live.insert(key);
        if (!stall_seen.count(key))
          alerts.push_back(Alert{reason, conn, (uint64_t)(age * 1e3)});
      };
      // conns is mutated under mu (accept/registration) and the matcher
      // is shared with app threads (sw_recv runs it under mu): the scan
      // reads both under the same lock.  Pure reads + lock-free ring/
      // counter writes -- no user callback fires under mu.
      std::lock_guard<std::mutex> g(mu);
      for (auto* rec : flushes) {
        double age = now - rec->born;
        if (age > stall_s)
          flag(kStallReasons[0], (uint64_t)(uintptr_t)rec, 0, age);
      }
      for (auto& [id, c] : conns) {
        if (!c->alive || (c->sess && c->sess->suspended))
          continue;  // §14 resume owns progress; not a wedge
        if (!c->fc_waiting.empty() && c->fc_waiting.front()->t_park > 0) {
          double age = now - c->fc_waiting.front()->t_park;
          if (age > stall_s) flag(kStallReasons[1], id, id, age);
        }
        double oldest = 0;
        for (auto& [mid, src] : c->stripe_by_id)
          if (!src->sacked && !src->failed && now - src->t_post > stall_s &&
              (oldest == 0 || src->t_post < oldest))
            oldest = src->t_post;
        if (oldest > 0) flag(kStallReasons[2], id, id, now - oldest);
      }
      if (!matcher.unexpected.empty()) {
        double age = now - matcher.unexpected.front()->born;
        if (age > stall_s) flag(kStallReasons[3], 0, 0, age);
      }
    }
    stall_seen = std::move(live);
    if (!alerts.empty()) {
      bump(counters.stall_alerts, alerts.size());
      for (auto& a : alerts)
        trace.rec(kEvStall, 0, a.conn, a.age_ms, a.reason);
    }
  }

  void expire_op(const Timer& t, FireList& fires) {
    if (t.kind == Timer::SESS_ACK || t.kind == Timer::SESS_GRACE ||
        t.kind == Timer::SESS_REDIAL) {
      sess_timer(t, fires);
      return;
    }
    if (t.kind == Timer::RECV) {
      std::lock_guard<std::mutex> g(mu);
      matcher.expire_recv(t.ctx, fires);
      return;
    }
    // SEND / FLUSH: the op may still be queued (not yet drained)...
    {
      std::lock_guard<std::mutex> g(mu);
      for (auto it = ops.begin(); it != ops.end(); ++it) {
        bool send_like = it->kind == Op::SEND || it->kind == Op::SEND_DEVPULL;
        if (it->ctx != t.ctx) continue;
        if ((t.kind == Timer::SEND && send_like) ||
            (t.kind == Timer::FLUSH && it->kind == Op::FLUSH)) {
          auto fail = it->fail; auto ctx = it->ctx;
          bump(counters.ops_timed_out);
          trace.rec(kEvOpFail, it->tag, it->conn_id, it->len, kTimedOut);
          if (fail) fires.push_back([fail, ctx] { fail(ctx, kTimedOut); });
          fire_op_release(*it, fires);
          ops.erase(it);
          return;
        }
      }
    }
    if (t.kind == Timer::FLUSH) {
      // ...or an outstanding barrier record.
      for (auto* rec : flushes) {
        if (rec->ctx != t.ctx || rec->completed) continue;
        rec->completed = true;
        remove_flush(rec);
        bump(counters.ops_timed_out);
        trace.rec(kEvOpFail, 0, 0, 0, kTimedOut);
        auto fail = rec->fail; auto ctx = rec->ctx;
        if (fail) fires.push_back([fail, ctx] { fail(ctx, kTimedOut); });
        delete rec;
        return;
      }
      return;
    }
    // SEND: find the queued TxItem.  Untouched -> withdraw cleanly; already
    // partially on the wire -> the stream cannot be resumed past a missing
    // fragment, so fail the op and tear the conn down (UCX ep-error
    // analogue).  Settled ops match nothing: no-op.
    std::vector<Conn*> cs;
    {
      std::lock_guard<std::mutex> g(mu);
      for (auto& [id, c] : conns) cs.push_back(c);
    }
    for (Conn* c : cs) {
      if (c->fc_ok && expire_fc_send(c, t.ctx, fires)) return;
      for (auto it = c->tx.begin(); it != c->tx.end(); ++it) {
        TxItem& item = **it;
        if (!item.is_data || item.ctx != t.ctx || item.local_done) continue;
        if (c->sess && !c->sess->expired && item.sess_seq) {
          // Live session, sequenced frame: the send is PROMISED -- the
          // journal delivers it (now, or via a replay), so failing it
          // "timed out" would lie about an op the peer still receives,
          // and tearing a healthy conn down would force a needless
          // resume cycle.  The op completes late; only grace/epoch
          // expiry may fail it (DESIGN.md §14; the Python engine's
          // _expire_send defers the same way).  Parked-unframed sends
          // (no seq yet) stay cleanly expirable below.
          return;
        }
        auto fail = item.fail; auto ctx = item.ctx;
        bump(counters.ops_timed_out);
        uint64_t tg = 0;
        size_t toff = data_hdr_off(item);
        if (item.header.size() >= toff + HEADER_SIZE)
          memcpy(&tg, item.header.data() + toff + 1, 8);
        trace.rec(kEvOpFail, tg, c->id, item.paylen, kTimedOut);
        // A sequenced session frame was already promised to the peer
        // (withdrawing it would leave a seq hole the receiver must treat
        // as a gap): expire it like a started send.
        if (item.off == 0 && item.sess_seq == 0) {
          item.local_done = true;
          if (fail) fires.push_back([fail, ctx] { fail(ctx, kTimedOut); });
          fire_release(item, fires);
          c->tx.erase(it);
        } else {
          item.local_done = true;  // suppress the conn_broken cancel path
          if (fail) fires.push_back([fail, ctx] { fail(ctx, kTimedOut); });
          conn_broken(c, fires);
        }
        return;
      }
      // Striped send: the source registry holds it (core/lane.py
      // _expire_stripe is the Python twin).
      for (auto& [mid, src] : c->stripe_by_id) {
        if (src->ctx != t.ctx || src->sacked || src->failed) continue;
        if (src->local_done) return;  // deadline bounds LOCAL completion
        if (c->sess && !c->sess->expired && src->started())
          return;  // promised: re-dispatch at resume completes it late
        bool started = src->started();
        bump(counters.ops_timed_out);
        trace.rec(kEvOpFail, src->tag, c->id, src->total, kTimedOut);
        src->failed = true;
        src->local_done = true;
        if (src->fail) {
          auto fail = src->fail; auto fctx = src->ctx;
          fires.push_back([fail, fctx] { fail(fctx, kTimedOut); });
        }
        if (!started) {
          // Untouched: withdraw cleanly from the dispatch queue.
          for (auto qit = c->stripe_q.begin(); qit != c->stripe_q.end();
               ++qit)
            if (qit->get() == src.get()) { c->stripe_q.erase(qit); break; }
          src->writers = 0;
          stripe_maybe_release(*src, fires);
        } else {
          // Chunks already promised on the wire: the group resets.
          src->writers = 0;
          stripe_maybe_release(*src, fires);
          conn_broken(c, fires);
        }
        return;
      }
      // Session backpressure may have parked it unframed: withdraw
      // cleanly from the waiting queue.
      if (c->sess) {
        auto& waiting = c->sess->waiting;
        for (auto it = waiting.begin(); it != waiting.end(); ++it) {
          TxItem& item = **it;
          if (!item.is_data || item.ctx != t.ctx || item.local_done) continue;
          auto fail = item.fail; auto ctx = item.ctx;
          bump(counters.ops_timed_out);
          trace.rec(kEvOpFail, 0, c->id, item.paylen, kTimedOut);
          item.local_done = true;
          if (fail) fires.push_back([fail, ctx] { fail(ctx, kTimedOut); });
          fire_release(item, fires, /*force=*/true);
          waiting.erase(it);
          return;
        }
      }
    }
  }

  // A SEND deadline against §18 flow-control state: a parked send sheds
  // cleanly (the overload degrades to an op timeout, the conn stays
  // healthy); an RTS-announced rendezvous send is PROMISED -- the
  // receiver holds a record a silent withdrawal would wedge -- so a
  // live session defers it (the resume re-announcement completes it
  // late) and a plain conn takes the started-send teardown.  Returns
  // true when the deadline was consumed here.
  bool expire_fc_send(Conn* c, void* ctx, FireList& fires) {
    for (auto it = c->fc_waiting.begin(); it != c->fc_waiting.end(); ++it) {
      TxItem& item = **it;
      if (!item.is_data || item.ctx != ctx || item.local_done) continue;
      bump(counters.ops_timed_out);
      bump(counters.sheds);
      trace.rec(kEvOpFail, item.tag, c->id, item.paylen, kTimedOut);
      item.local_done = true;
      if (item.fail) {
        auto fail = item.fail; auto fctx = item.ctx;
        fires.push_back([fail, fctx] { fail(fctx, kTimedOut); });
      }
      fire_release(item, fires, /*force=*/true);
      c->fc_waiting.erase(it);
      return true;
    }
    for (auto& [mid, ent] : c->fc_rts) {
      TxItem& item = *ent.item;
      if (item.ctx != ctx || item.local_done) continue;
      if (c->sess && !c->sess->expired) return true;  // completes late
      bump(counters.ops_timed_out);
      trace.rec(kEvOpFail, item.tag, c->id, item.paylen, kTimedOut);
      item.local_done = true;
      if (item.fail) {
        auto fail = item.fail; auto fctx = item.ctx;
        fires.push_back([fail, fctx] { fail(fctx, kTimedOut); });
      }
      conn_broken(c, fires);
      return true;
    }
    return false;
  }

  // ---------------------------------------------------------- keepalive
  void ka_tick(FireList& fires) {
    auto now = Clock::now();
    auto interval = std::chrono::duration<double>(ka_interval);
    auto window = std::chrono::duration<double>(ka_interval * ka_misses);
    std::vector<Conn*> cs;
    {
      std::lock_guard<std::mutex> g(mu);
      for (auto& [id, c] : conns) cs.push_back(c);
    }
    std::vector<Conn*> expired;
    for (Conn* c : cs) {
      if (!c->alive || !c->ka_ok) continue;
      if (c->sess && c->sess->suspended)
        continue;  // no transport to probe; the grace timer governs
      auto silent = now - c->last_rx;
      if (silent > window) expired.push_back(c);
      else if (silent >= interval)
        // Timestamped: the PONG doubles as a swscope clock sample.
        conn_send_ctl(c, T_PING, now_ns(), 0, "", fires);
    }
    for (Conn* c : expired) conn_expired(c, fires);
  }

  // Liveness window elapsed: declare the peer dead.  conn_broken's
  // liveness-active branch fails the streaming receive and (once no alive
  // conns remain) every queued receive -- the keepalive-enabled
  // replacement for recvs-pend-forever (core/engine.py _conn_expired is
  // the Python twin).
  void conn_expired(Conn* c, FireList& fires) {
    SW_DEBUG("peer %s liveness expired", c->peer_name.c_str());
    bump(counters.ka_misses);
    conn_broken(c, fires);
  }

  // ------------------------------------------------------ swscope gauges
  // Render the per-conn gauge snapshot (kGaugeNames order; the
  // core/telemetry.py GAUGE_NAMES twin) plus worker-level posted_recvs.
  // Engine-thread context only (or a quiescent worker): the values read
  // live engine-owned queues, which is exactly why sw_gauges marshals
  // here instead of maintaining lock-free shadows on the data path.
  std::string gauges_json() {
    std::string s = "{\"conns\": {";
    std::lock_guard<std::mutex> g(mu);
    bool first = true;
    for (auto& [id, c] : conns) {
      uint64_t depth = c->tx.size(), qbytes = 0, infl = 0;
      for (auto& ref : c->tx) {
        qbytes += ref->total() - ref->off;
        if (ref->is_data && ref->off < ref->total()) infl++;
      }
      uint64_t jb = 0, jf = 0;
      if (c->sess) {
        Session* ss = c->sess.get();
        depth += ss->waiting.size();
        for (auto& ref : ss->waiting) {
          qbytes += ref->total();
          if (ref->is_data) infl++;
        }
        jb = ss->journal_bytes;
        jf = ss->journal.size();
      }
      uint64_t inflr = (c->rx_msg ? 1 : 0) + c->devpull_pending.size();
      uint64_t sp = 0;  // chunks assigned to this lane but unwritten...
      for (auto& ref : c->tx)
        if (ref->stripe && ref->off < ref->total()) sp++;
      for (auto& [mid, src] : c->stripe_by_id)  // ...plus undisbursed
        if (!src->sacked && !src->failed) sp += src->pending.size();
      depth += c->fc_waiting.size();
      for (auto& ref : c->fc_waiting) {
        qbytes += ref->total();
        if (ref->is_data) infl++;
      }
      uint64_t credits = c->fc_credits > 0 ? (uint64_t)c->fc_credits : 0;
      const uint64_t vals[] = {depth, qbytes, infl, inflr, jb, jf, sp,
                               c->fc_unexp, credits,
                               (uint64_t)c->retx_offs.size(),
                               (uint64_t)c->zc_outstanding.size()};
      static_assert(sizeof(vals) / sizeof(vals[0]) ==
                        sizeof(kGaugeNames) / sizeof(kGaugeNames[0]),
                    "gauge names and values out of sync");
      char buf[96];
      int n = snprintf(buf, sizeof(buf), "%s\"%llu\": {", first ? "" : ", ",
                       (unsigned long long)id);
      s.append(buf, (size_t)n);
      for (size_t i = 0; i < sizeof(vals) / sizeof(vals[0]); i++) {
        n = snprintf(buf, sizeof(buf), "%s\"%s\": %llu", i == 0 ? "" : ", ",
                     kGaugeNames[i], (unsigned long long)vals[i]);
        s.append(buf, (size_t)n);
      }
      s += "}";
      first = false;
    }
    s += "}, \"posted_recvs\": " + std::to_string(matcher.posted.size()) +
         ", \"uring_depth\": " +
         std::to_string(uring.ok() ? (uint64_t)uring.sq_entries : 0) + "}";
    return s;
  }

  static void gauges_signal(const std::shared_ptr<GaugesWait>& wait,
                            std::string json) {
    {
      std::lock_guard<std::mutex> lg(wait->m);
      wait->json = std::move(json);
      wait->done = true;
    }
    wait->cv.notify_all();
  }

  // --------------------------------------------------------------- main
  void drain_ops(FireList& fires) {
    for (;;) {
      Op op;
      {
        std::lock_guard<std::mutex> g(mu);
        if (ops.empty() || status.load() != ST_RUNNING) return;
        op = ops.front();
        ops.pop_front();
      }
      if (op.kind == Op::GAUGES) {
        gauges_signal(op.gwait, gauges_json());
        continue;
      }
      if (op.kind == Op::DEVPULL_CLAIM) {
        if (devpull_claim_cb) {
          auto cb = devpull_claim_cb; auto ctx = devpull_cb_ctx;
          uint64_t rid = op.msg_id, rctx = op.rctx;
          int flags = op.flags;
          fires.push_back([cb, ctx, rid, rctx, flags] { cb(ctx, rid, rctx, flags); });
        }
        continue;
      }
      if (op.kind == Op::DEVPULL_PURGE) {
        std::lock_guard<std::mutex> g(mu);
        for (auto it = matcher.unexpected.begin(); it != matcher.unexpected.end(); ++it) {
          if ((*it)->remote && (*it)->remote_id == op.msg_id) {
            delete *it;
            matcher.unexpected.erase(it);
            break;
          }
        }
        continue;
      }
      if (op.kind == Op::SEND || op.kind == Op::SEND_DEVPULL ||
          op.kind == Op::DEVPULL_RESOLVED) {
        Conn* c = nullptr;
        {
          std::lock_guard<std::mutex> g(mu);
          auto it = conns.find(op.conn_id);
          if (it != conns.end()) c = it->second;
        }
        if (op.kind == Op::DEVPULL_RESOLVED) {
          if (op.flags) {  // pull landed: the record (if queued) is ready
            std::lock_guard<std::mutex> g(mu);
            matcher.mark_remote_ready(op.msg_id);
          }
          if (c) devpull_resolve(c, op.msg_id, fires);
        } else if (!c || !c->alive) {
          auto fail = op.fail; auto ctx = op.ctx;
          trace.rec(kEvOpFail, op.tag, op.conn_id, op.len, kNotConnected);
          if (fail) fires.push_back([fail, ctx] { fail(ctx, kNotConnected); });
          fire_op_release(op, fires);
        } else if (op.kind == Op::SEND_DEVPULL) {
          conn_send_devpull(c, op, fires);
        } else {
          conn_send_data(c, op, fires);
        }
      } else {
        start_flush(op, fires);
      }
    }
  }

  void do_close(FireList& fires) {
    {
      std::lock_guard<std::mutex> g(mu);
      while (!ops.empty()) {
        Op& op = ops.front();
        if (op.kind == Op::GAUGES) {
          // Never leave a sw_gauges caller parked on a dead engine: a
          // closed worker's gauges are all drained-to-zero by contract.
          gauges_signal(op.gwait,
                        "{\"conns\": {}, \"posted_recvs\": 0, "
                        "\"uring_depth\": 0}");
          ops.pop_front();
          continue;
        }
        if (op.kind == Op::DEVPULL_CLAIM && devpull_claim_cb) {
          // Deliver the claim so the embedder's close sweep can cancel the
          // receive (it left the matcher; nothing else can reach it).
          auto cb = devpull_claim_cb; auto cctx = devpull_cb_ctx;
          uint64_t rid = op.msg_id, rctx = op.rctx;
          int flags = op.flags;
          fires.push_back([cb, cctx, rid, rctx, flags] { cb(cctx, rid, rctx, flags); });
        }
        auto fail = op.fail; auto ctx = op.ctx;
        if (fail) {
          bump(counters.ops_cancelled);
          fires.push_back([fail, ctx] { fail(ctx, kCancelled); });
        }
        fire_op_release(op, fires);
        ops.pop_front();
      }
      matcher.cancel_all(fires);
    }
    for (auto* rec : flushes) {
      if (!rec->completed && rec->fail) {
        auto fail = rec->fail; auto ctx = rec->ctx;
        bump(counters.ops_cancelled);
        fires.push_back([fail, ctx] { fail(ctx, kCancelled); });
      }
      delete rec;
    }
    flushes.clear();
    for (auto& [id, c] : conns) conn_close_local(c, fires);
    for (auto* c : half_open) {
      c->alive = false;
      ep_del(c->fd);
      uring_unqueue(c);
      close(c->fd);
      c->fd = -1;
      delete c;
    }
    half_open.clear();
    if (listen_fd >= 0) {
      close(listen_fd);
      listen_fd = -1;
    }
    status.store(ST_CLOSED);
    if (close_done) {
      auto done = close_done; auto ctx = close_ctx;
      fires.push_back([done, ctx] { done(ctx); });
      close_done = nullptr;
    }
  }

  virtual bool setup(FireList& fires) = 0;

  void run() {
    engine_tid = std::this_thread::get_id();
    {
      FireList fires;
      bool ok = setup(fires);
      for (auto& f : fires) f();
      if (!ok) {
        cleanup_fds();
        unref();
        return;
      }
    }
    // Keepalive config sampled once per worker lifetime (config.py knobs).
    ka_interval = ka_interval_env();
    ka_misses = ka_misses_env();
    if (ka_interval > 0)
      next_ka = Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                   std::chrono::duration<double>(ka_interval));
    // §24 swfast levers, sampled once per worker lifetime.  Each is
    // strictly opt-in; env unset leaves this loop byte-identical to the
    // seed.  STARWAY_IOURING_PROBE_FAIL is the test hook for the
    // kernel-without-io_uring fallback ladder (probe fails -> epoll).
    busypoll_us = busypoll_us_env();
    zc_armed = zerocopy_enabled();
    zc_thresh = rndv_threshold();
    if (iouring_enabled() && !std::getenv("STARWAY_IOURING_PROBE_FAIL"))
      uring.init(256);
    // §25 stall sentinel, sampled once per worker lifetime like the
    // levers above (0 = off: the loop below takes no sentinel branch
    // beyond one double comparison per pass).
    stall_s = stall_ms_env() / 1e3;
    if (stall_s > 0) next_stall = Clock::now();
    epoll_event events[64];
    auto spin_until = Clock::time_point::min();
    for (;;) {
      if (status.load() == ST_CLOSING) break;
      int timeout = poll_timeout_ms();
      if (stall_s > 0) {
        // Scan at half the threshold so a wedge is flagged within ~1.5x.
        int cap_ms = (int)(stall_s * 500);
        if (cap_ms < 10) cap_ms = 10;
        if (timeout < 0 || timeout > cap_ms) timeout = cap_ms;
      }
      bool spinning = false;
      if (busypoll_us > 0 && Clock::now() < spin_until) {
        timeout = 0;  // §24 bounded busy-poll: nonblocking inside the window
        spinning = true;
      }
      int n = epoll_wait(epfd, events, 64, timeout);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      if (n > 0 && busypoll_us > 0) {
        if (spinning) bump(counters.busypoll_hits);
        spin_until = Clock::now() +
                     std::chrono::microseconds((int64_t)busypoll_us);
      }
      FireList fires;
      for (int i = 0; i < n; i++) {
        void* ptr = events[i].data.ptr;
        if (ptr == &evfd) {
          uint64_t buf;
          while (read(evfd, &buf, 8) == 8) {
          }
        } else if (ptr == &listen_fd) {
          accept_loop(fires);
        } else {
          Conn* c = (Conn*)ptr;
          if ((events[i].events & EPOLLERR) && !c->zc_outstanding.empty())
            zc_drain_errqueue(c, fires);  // §24 zerocopy notifications
          if (events[i].events & EPOLLOUT) conn_writable(c, fires);
          if ((events[i].events & (EPOLLIN | EPOLLHUP | EPOLLERR)) && c->alive)
            conn_readable(c, fires);
        }
      }
      check_timers(fires);
      if (stall_s > 0 && Clock::now() >= next_stall) {
        next_stall = Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                        std::chrono::duration<double>(stall_s / 2));
        stall_tick();
      }
      drain_ops(fires);
      fc_service(fires);  // §18 grants/CTS queued by matcher paths
      uring_service(fires);  // §24 batched submit of deferred TX (no-op off)
      for (auto& f : fires) f();
      for (Conn* z : sess_reap) delete z;
      sess_reap.clear();
    }
    FireList fires;
    do_close(fires);
    for (auto& f : fires) f();
    cleanup_fds();
    unref();
  }

  void accept_loop(FireList& fires) {
    for (;;) {
      sockaddr_in addr{};
      socklen_t alen = sizeof(addr);
      int fd = accept4(listen_fd, (sockaddr*)&addr, &alen, SOCK_NONBLOCK);
      if (fd < 0) return;
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto* c = new Conn();
      c->fd = fd;
      {
        std::lock_guard<std::mutex> g(mu);
        c->id = next_conn_id++;
      }
      char buf[64];
      inet_ntop(AF_INET, &addr.sin_addr, buf, sizeof(buf));
      c->remote_addr = buf;
      c->remote_port = ntohs(addr.sin_port);
      sockaddr_in local{};
      socklen_t llen = sizeof(local);
      if (getsockname(fd, (sockaddr*)&local, &llen) == 0) {
        inet_ntop(AF_INET, &local.sin_addr, buf, sizeof(buf));
        c->local_addr = buf;
        c->local_port = ntohs(local.sin_port);
      }
      // swrefine: accepted conns start in `estab` -- the pre-HELLO
      // accept state is folded into the same framed dispatch
      // (DESIGN.md §16, §22).
      trace.proto_ev(c->id, "st:estab");
      half_open.insert(c);
      ep_add(fd, EPOLLIN, c);
    }
  }

  void cleanup_fds() {
    uring.shutdown();
    if (epfd >= 0) {
      close(epfd);
      epfd = -1;
    }
    if (evfd >= 0) {
      close(evfd);
      evfd = -1;
    }
  }
};

struct ServerWorker : Worker {
  ServerWorker() { is_server = true; }
  bool setup(FireList&) override {
    ep_add(evfd, EPOLLIN, &evfd);
    ep_add(listen_fd, EPOLLIN, &listen_fd);
    return true;
  }
};

struct ClientWorker : Worker {
  bool setup(FireList& fires) override {
    ep_add(evfd, EPOLLIN, &evfd);
    // Nonblocking connect with 3s timeout.
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    SmSegment* sm_offer = nullptr;
    auto fail_connect = [&](const std::string& why) {
      if (fd >= 0) close(fd);
      if (sm_offer) {
        sm_offer->unlink();
        delete sm_offer;
        sm_offer = nullptr;
      }
      status.store(ST_CLOSED);
      if (c_status_cb) {
        auto cb = c_status_cb; auto ctx = c_status_ctx;
        std::string msg = std::string(kNotConnected) + ": " + why;
        fires.push_back([cb, ctx, msg] { cb(ctx, msg.c_str()); });
      }
      return false;
    };
    if (fd < 0) return fail_connect("socket() failed");
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)c_port);
    if (inet_pton(AF_INET, c_host.c_str(), &addr.sin_addr) != 1)
      return fail_connect("bad address " + c_host);
    const int cto_ms = connect_timeout_ms();
    int rc = ::connect(fd, (sockaddr*)&addr, sizeof(addr));
    if (rc < 0 && errno != EINPROGRESS) return fail_connect(strerror(errno));
    pollfd pfd{fd, POLLOUT, 0};
    if (poll(&pfd, 1, cto_ms) <= 0) return fail_connect("connect timeout");
    int err = 0;
    socklen_t elen = sizeof(err);
    getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen);
    if (err != 0) return fail_connect(strerror(err));
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // HELLO / HELLO_ACK handshake (blocking with poll deadlines).  Offer a
    // same-host shared-memory upgrade when enabled (see SmSegment).  A
    // session offer (STARWAY_SESSION) disables the sm upgrade: the rings
    // are a per-incarnation transport with no replay journal.
    bool sess_on = session_enabled();
    if (sm_enabled() && !sess_on) sm_offer = SmSegment::create(worker_id.substr(0, 8));
    std::string hello = std::string("{\"worker_id\": \"") + worker_id +
                        "\", \"mode\": \"" + c_mode + "\", \"name\": \"\"";
    if (sess_on)
      // Stable session id + epoch 0 (the acceptor assigns the real
      // epoch); sess_ack is our cumulative rx seq (0 for a new session).
      hello += std::string(", \"sess\": \"ok\", \"sess_id\": \"") + worker_id +
               "\", \"sess_epoch\": \"0\", \"sess_ack\": \"0\"";
    if (sm_offer) {
      char nonce_hex[17];
      snprintf(nonce_hex, sizeof(nonce_hex), "%016llx", (unsigned long long)sm_offer->nonce);
      hello += std::string(", \"sm_key\": \"") + sm_offer->key + "\", \"sm_nonce\": \"" +
               nonce_hex + "\", \"sm_ring\": \"" + std::to_string(sm_offer->ring_size) + "\"";
    }
    if (devpull_advertise)
      hello += ", \"cudaipc\": \"" + cudaipc_id + "\"";
    hello += ", \"ka\": \"ok\"";  // liveness capability, always offered
    int rails_n = stripe_rails_env();
    if (rails_n > 1) {
      // Multi-rail striping offer (DESIGN.md §17): a capable acceptor
      // confirms "rails": "ok" and we dial the extra lanes right after
      // the primary handshake.
      hello += ", \"rails\": \"" + std::to_string(rails_n) + "\"";
    }
    uint64_t fc_w = fc_window_env();
    if (fc_w > 0) {
      // Receiver-driven flow control offer (DESIGN.md §18): the value
      // is OUR unexpected-queue budget for the peer's eager traffic.
      hello += ", \"fc\": \"" + std::to_string(fc_w) + "\"";
    }
    bool integ = integrity_enabled();
    if (integ) {
      // End-to-end integrity offer (DESIGN.md §19): an integrity-capable
      // acceptor confirms "csum": "ok" and every later frame checksums.
      hello += ", \"csum\": \"1\"";
    }
    char tr_offer[17] = {0};
    if (trace.enabled) {
      // swscope stitching: offer a fresh trace-conn id (DESIGN.md §15).
      uint64_t r = 0;
      if (getrandom(&r, 8, 0) != 8) r = (uint64_t)(uintptr_t)this ^ now_ns();
      snprintf(tr_offer, sizeof(tr_offer), "%016llx", (unsigned long long)r);
      hello += std::string(", \"tr\": \"") + tr_offer + "\"";
    }
    hello += "}";
    std::vector<uint8_t> frame(HEADER_SIZE + hello.size());
    pack_header(frame.data(), T_HELLO, 0, hello.size());
    memcpy(frame.data() + HEADER_SIZE, hello.data(), hello.size());
    size_t off = 0;
    while (off < frame.size()) {
      ssize_t w = ::send(fd, frame.data() + off, frame.size() - off, MSG_NOSIGNAL);
      if (w < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          pollfd p2{fd, POLLOUT, 0};
          if (poll(&p2, 1, cto_ms) <= 0) return fail_connect("handshake send timeout");
          continue;
        }
        return fail_connect("handshake send failed");
      }
      off += (size_t)w;
    }
    auto read_exact = [&](uint8_t* out, size_t n) -> bool {
      size_t got = 0;
      while (got < n) {
        ssize_t r = ::recv(fd, out + got, n - got, 0);
        if (r > 0) {
          got += (size_t)r;
          continue;
        }
        if (r == 0) return false;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          pollfd p2{fd, POLLIN, 0};
          if (poll(&p2, 1, cto_ms) <= 0) return false;
          continue;
        }
        return false;
      }
      return true;
    };
    uint8_t hdr[HEADER_SIZE];
    if (!read_exact(hdr, HEADER_SIZE)) return fail_connect("handshake read failed");
    uint8_t type;
    uint64_t a, b;
    unpack_header(hdr, &type, &a, &b);
    // swcheck: state(hello-sent, HELLO_ACK, estab)
    // swcheck: state(hello-sent, OTHER, down)
    if (type != T_HELLO_ACK || b > 4096) return fail_connect("bad handshake frame");
    std::vector<uint8_t> body(b);
    if (b && !read_exact(body.data(), b)) return fail_connect("handshake body read failed");
    auto* c = new Conn();
    c->fd = fd;
    c->handshaken = true;
    c->mode = c_mode;
    std::string ack_body((char*)body.data(), body.size());
    c->peer_name = json_field(ack_body, "worker_id");
    if (devpull_advertise) c->cudaipc_peer = json_field(ack_body, "cudaipc");
    c->devpull_ok = !c->cudaipc_peer.empty();
    c->ka_ok = json_field(ack_body, "ka") == "ok";
    c->rails_ok = rails_n > 1 && json_field(ack_body, "rails") == "ok";
    c->unexp_cap = unexp_cap_env();
    if (fc_w > 0) {
      uint64_t peer_w =
          strtoull(json_field(ack_body, "fc").c_str(), nullptr, 10);
      if (peer_w > 0) {
        c->fc_ok = true;
        c->fc_window = peer_w;
        c->fc_credits = (int64_t)peer_w;
      }
    }
    c->csum_ok = integ && json_field(ack_body, "csum") == "ok";
    if (tr_offer[0] && json_field(ack_body, "tr") == "ok")
      memcpy(c->tr_hex, tr_offer, sizeof(c->tr_hex));
    if (sess_on && json_field(ack_body, "sess") == "ok") {
      c->sess = std::make_unique<Session>();
      c->sess->id = worker_id;
      c->sess->epoch = json_field(ack_body, "sess_epoch");
      c->sess->journal_cap = session_journal_bytes_env();
      c->sess->grace = session_grace_env();
    }
    if (sm_offer) {
      if (json_field(ack_body, "sm") == "ok") {
        c->adopt_sm(sm_offer, /*creator=*/true, /*defer_tx=*/false);
        sm_offer = nullptr;  // owned by the conn now
      } else {
        sm_offer->unlink();
        delete sm_offer;
        sm_offer = nullptr;
      }
    }
    sockaddr_in local{};
    socklen_t llen = sizeof(local);
    char buf[64];
    if (getsockname(fd, (sockaddr*)&local, &llen) == 0) {
      inet_ntop(AF_INET, &local.sin_addr, buf, sizeof(buf));
      c->local_addr = buf;
      c->local_port = ntohs(local.sin_port);
    }
    c->remote_addr = c_host;
    c->remote_port = c_port;
    {
      std::lock_guard<std::mutex> g(mu);
      c->id = next_conn_id++;
      conns[c->id] = c;
      primary_conn = c->id;
    }
    // swrefine: the blocking handshake above IS the hello-sent state --
    // HELLO written, HELLO_ACK consumed synchronously before the Conn
    // exists, so both events are recorded at its birth (DESIGN.md §22).
    trace.proto_ev(c->id, "st:hello-sent");
    trace.proto_ev(c->id, "rx:HELLO_ACK");
    ep_add(fd, EPOLLIN, c);
    trace.rec(kEvConnUp, 0, c->id);
    if (c->rails_ok) dial_rails(c, rails_n - 1, fires);
    if (c->tr_hex[0]) {
      // One-shot clock exchange at handshake: a timestamped PING whose
      // PONG yields the first EV_CLOCK sample even with keepalive off.
      conn_send_ctl(c, T_PING, now_ns(), 0, "", fires);
    }
    int expect = ST_INIT;
    status.compare_exchange_strong(expect, ST_RUNNING);
    if (c_status_cb) {
      auto cb = c_status_cb; auto ctx = c_status_ctx;
      fires.push_back([cb, ctx] { cb(ctx, ""); });
    }
    return true;
  }
};

// ------------------------------------------- §21 decode harness (pure)
//
// The engine-side half of the swcompose differential wire fuzzer: the
// structural decode rules of pump_frames (and SmRing::read_into's
// slot-record walk), runnable over a flat buffer with no worker and no
// I/O, rendered as the canonical outcome string core/frames.py
// decode_stream emits byte-identically.  Shares kCsumExempt/kCsumBody/
// kHeaderOnly/CTL_MAX/SM_REC_HDR and crc32c with the live parser, so
// the harness cannot drift from the engine on the table-driven rules.

struct DecodeOut {
  std::vector<std::string> entries;
  int extra = 0;
  void emit(const char* e) {
    if (entries.size() < 64)  // frames.DECODE_MAX_ENTRIES
      entries.emplace_back(e);
    else
      extra++;
  }
  std::string finish(const char* status, uint64_t consumed) {
    std::string s = status;
    s += " n=" + std::to_string(consumed) + " [";
    for (size_t i = 0; i < entries.size(); i++) {
      if (i) s += " ";
      s += entries[i];
    }
    if (extra) {
      if (!entries.empty()) s += " ";
      s += "+" + std::to_string(extra);
    }
    s += "]";
    return s;
  }
};

std::string wire_decode_stream(const uint8_t* buf, uint64_t n, bool csum) {
  uint64_t pos = 0, consumed = 0;
  bool pend = false;
  uint32_t pf = 0, ph = 0, accum = 0;
  DecodeOut o;
  char tmp[192];
  for (;;) {
    if (n - pos < HEADER_SIZE)
      return o.finish(pos == n ? "ok" : "short:header", consumed);
    uint8_t type;
    uint64_t a, b;
    unpack_header(buf + pos, &type, &a, &b);
    if (pend) accum = crc32c(buf + pos, HEADER_SIZE, accum);
    pos += HEADER_SIZE;
    if (csum) {
      // §19 verification gate, BEFORE dispatch (pump_frames twin).
      if (type == T_CSUM) {
        if (pend) return o.finish("reject(nested checksum prefix)", consumed);
        pend = true;
        pf = (uint32_t)a;
        ph = (uint32_t)b;
        accum = 0;
        snprintf(tmp, sizeof(tmp), "%u:%llu:%llu", type,
                 (unsigned long long)a, (unsigned long long)b);
        o.emit(tmp);
        consumed = pos;
        continue;
      }
      if (!csum_exempt(type)) {
        if (!pend) return o.finish("reject(frame without checksum)", consumed);
        if (type != T_SDATA && accum != ph)
          return o.finish("reject(frame header checksum)", consumed);
        bool body_follows = type == T_SDATA || (csum_body(type) && b > 0);
        if (!body_follows) {
          pend = false;
          if (accum != pf) return o.finish("reject(frame checksum)", consumed);
        }
      }
    }
    if (type == T_SDATA) {
      if (b <= SDATA_SUB_SIZE)
        return o.finish("reject(sdata sub-header)", consumed);
      if (n - pos < SDATA_SUB_SIZE) return o.finish("short:sub", consumed);
      if (pend) {
        accum = crc32c(buf + pos, SDATA_SUB_SIZE, accum);
        if (accum != ph)
          return o.finish("reject(stripe sub-header checksum)", consumed);
      }
      uint64_t mid, off, tot;
      memcpy(&mid, buf + pos, 8);
      memcpy(&off, buf + pos + 8, 8);
      memcpy(&tot, buf + pos + 16, 8);
      pos += SDATA_SUB_SIZE;
      uint64_t clen = b - SDATA_SUB_SIZE;
      if (clen > n - pos) return o.finish("short:body", consumed);
      if (pend) {
        accum = crc32c(buf + pos, (size_t)clen, accum);
        pend = false;
        if (accum != pf) {
          // Chunk payload corrupt, routing verified: the recoverable
          // T_SNACK retransmit -- an event, not a poison.
          pos += clen;
          snprintf(tmp, sizeof(tmp), "snack:%llu:%llu",
                   (unsigned long long)mid, (unsigned long long)off);
          o.emit(tmp);
          consumed = pos;
          continue;
        }
      }
      pos += clen;
      snprintf(tmp, sizeof(tmp), "%u:%llu:%llu:%llu:%llu:%llu", type,
               (unsigned long long)a, (unsigned long long)b,
               (unsigned long long)mid, (unsigned long long)off,
               (unsigned long long)tot);
      o.emit(tmp);
      consumed = pos;
      continue;
    }
    if (type == T_DATA) {
      if (b) {
        if (b > n - pos) return o.finish("short:body", consumed);
        if (pend) {
          accum = crc32c(buf + pos, (size_t)b, accum);
          pend = false;
          if (accum != pf)
            return o.finish("reject(payload checksum (DATA))", consumed);
        }
        pos += b;
      }
      snprintf(tmp, sizeof(tmp), "%u:%llu:%llu", type,
               (unsigned long long)a, (unsigned long long)b);
      o.emit(tmp);
      consumed = pos;
      continue;
    }
    if (type == T_HELLO || type == T_HELLO_ACK || type == T_DEVPULL ||
        type == T_RTS) {
      if (b == 0) return o.finish("reject(zero control body)", consumed);
      if (b > CTL_MAX) return o.finish("reject(oversized control body)", consumed);
      if (b > n - pos) return o.finish("short:body", consumed);
      if (pend) {
        // The ctl-completion verify consumes the envelope even for the
        // (nonsensical) exempt-frame-inside-envelope shape -- the live
        // parser clears pend at any ctl body end.
        accum = crc32c(buf + pos, (size_t)b, accum);
        pend = false;
        if (accum != pf)
          return o.finish("reject(control body checksum)", consumed);
      }
      pos += b;
      snprintf(tmp, sizeof(tmp), "%u:%llu:%llu", type,
               (unsigned long long)a, (unsigned long long)b);
      o.emit(tmp);
      consumed = pos;
      continue;
    }
    if (header_only_frame(type)) {
      snprintf(tmp, sizeof(tmp), "%u:%llu:%llu", type,
               (unsigned long long)a, (unsigned long long)b);
      o.emit(tmp);
      consumed = pos;
      continue;
    }
    return o.finish("reject(unknown frame type)", consumed);
  }
}

std::string wire_decode_recs(const uint8_t* buf, uint64_t n) {
  uint64_t pos = 0, consumed = 0, seq = 0;
  const uint64_t ring_size = 1ull << 20;  // shmring.DEFAULT_RING model size
  DecodeOut o;
  char tmp[32];
  for (;;) {
    if (n - pos == 0) return o.finish("ok", consumed);
    if (n - pos < SM_REC_HDR) return o.finish("short:rec-header", consumed);
    uint32_t ln, crc;
    memcpy(&ln, buf + pos, 4);
    memcpy(&crc, buf + pos + 4, 4);
    if (ln == 0 || ln > ring_size)
      return o.finish("reject(sm record header)", consumed);
    if ((uint64_t)ln > n - pos - SM_REC_HDR)
      return o.finish("short:rec-body", consumed);
    uint8_t seq8[8];
    memcpy(seq8, &seq, 8);
    uint32_t accum = crc32c(buf + pos + SM_REC_HDR, ln, crc32c(seq8, 8, 0));
    if (accum != crc) return o.finish("reject(sm record checksum)", consumed);
    seq++;
    pos += SM_REC_HDR + ln;
    consumed = pos;
    snprintf(tmp, sizeof(tmp), "r:%u", ln);
    o.emit(tmp);
  }
}

int worker_start(Worker* w) {
  w->epfd = epoll_create1(EPOLL_CLOEXEC);
  w->evfd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  if (w->epfd < 0 || w->evfd < 0) {
    w->cleanup_fds();
    return -1;
  }
  w->refs.fetch_add(1);  // engine thread reference
  std::thread([w] { w->run(); }).detach();
  return 0;
}

}  // namespace

// ------------------------------------------------------------- C surface

extern "C" {

// 2: sm transport; 3: op deadlines + PING/PONG peer liveness;
// 4: swtrace observability (sw_counters/sw_trace);
// 5: resilient sessions (T_SEQ/T_ACK, "sess" handshake, sw_set_event_cb);
// 6: swscope ("tr" handshake + EV_E2E ordinals, timestamped PING/PONG
//    clock samples, per-conn gauges via sw_gauges);
// 7: multi-rail striping (T_SDATA/T_SACK, "rails"/"rail_of" handshake,
//    chunk-level work stealing + offset-dedup reassembly);
// 8: receiver-driven flow control (T_CREDIT window grants, T_RTS/T_CTS
//    rendezvous pull, "fc" handshake, bounded unexpected queues +
//    deadline-aware shedding)
// 9: end-to-end integrity plane (T_CSUM per-frame CRC32C, T_SNACK
//    chunk-level retransmit, checksummed sm slot records, "csum"
//    handshake, "corrupt" poison reason -- DESIGN.md §19);
// 10: swcompose decode-contract hardening (zero/oversized ctl bodies and
//    zero-length striped chunks are protocol violations, T_CSUM prefix
//    truncates to the 32-bit CRC) + the sw_wire_decode differential
//    harness -- DESIGN.md §21
// 11: swfast opt-in hot-path levers (io_uring batched TX submission,
//    MSG_ZEROCOPY >= rndv payloads, bounded busy-poll) + the
//    sw_fast_probe capability export; no wire/HELLO change, seed path
//    byte-identical with the envs unset -- DESIGN.md §24
// 12: swpulse always-on latency/size histograms (kHistNames vocabulary,
//    sw_hists export) + the opt-in STARWAY_STALL_MS stall sentinel
//    (EV_STALL alerts, stall_alerts counter); no wire/HELLO change --
//    DESIGN.md §25
const char* sw_version() { return "starway-native-14"; }

// swfast capability probe (sw_engine.h, DESIGN.md §24): which levers can
// this build+kernel actually engage?  bit0 io_uring, bit1 MSG_ZEROCOPY,
// bit2 busy-poll.  Scratch resources only; nothing persists.
uint64_t sw_fast_probe() {
  uint64_t caps = 4;  // busy-poll needs nothing beyond the event loop
#if SW_HAVE_IOURING
  if (!std::getenv("STARWAY_IOURING_PROBE_FAIL")) {
    UringCore probe;
    if (probe.init(8)) caps |= 1;
    probe.shutdown();
  }
#endif
  {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd >= 0) {
      int one = 1;
      if (setsockopt(fd, SOL_SOCKET, SO_ZEROCOPY, &one, sizeof(one)) == 0)
        caps |= 2;
      close(fd);
    }
  }
  return caps;
}

// Portable cursor atomics for the Python engine's sm ring (sw_engine.h).
// std::atomic_ref would be C++20-tidy but libstdc++'s needs alignment UB
// care on char buffers; the builtin form compiles to ldar/stlr on ARM and
// plain mov on x86, which is exactly the contract.
uint64_t sw_atomic_load_u64(const void* p) {
  return __atomic_load_n(static_cast<const uint64_t*>(p), __ATOMIC_ACQUIRE);
}

void sw_atomic_store_u64(void* p, uint64_t v) {
  __atomic_store_n(static_cast<uint64_t*>(p), v, __ATOMIC_RELEASE);
}

// §19 integrity checksum (sw_engine.h): hardware CRC32C with software
// fallback; the Python engine calls this same export (core/frames.py) so
// mixed pairs agree bit-for-bit.
uint32_t sw_crc32c(const void* p, uint64_t n, uint32_t seed) {
  return crc32c(static_cast<const uint8_t*>(p), (size_t)n, seed);
}

// §21 swcompose differential decode harness (sw_engine.h): the engine's
// structural frame decoder over a flat buffer, canonical outcome string
// out -- the C++ half the wirefuzz analysis pass diffs against
// core/frames.py decode_stream and its grammar-derived oracle.
int sw_wire_decode(const void* p, uint64_t n, int mode, char* out, int cap) {
  if (!p && n) return -1;
  if (!out || cap <= 0) return -1;
  const uint8_t* buf = static_cast<const uint8_t*>(p);
  std::string res = mode == 2 ? wire_decode_recs(buf, n)
                              : wire_decode_stream(buf, n, mode == 1);
  size_t len = res.size() < (size_t)(cap - 1) ? res.size() : (size_t)(cap - 1);
  memcpy(out, res.data(), len);
  out[len] = 0;
  return (int)res.size();
}

// ----- client

void* sw_client_new(const char* worker_id) {
  auto* w = new ClientWorker();
  w->worker_id = worker_id ? worker_id : "";
  w->trace.init();
  w->matcher.ring = &w->trace;
  w->matcher.ctr = &w->counters;
  w->matcher.hst = &w->hists;
  return w;
}

int sw_client_connect(void* h, const char* host, int port, const char* mode,
                      sw_status_cb cb, void* ctx) {
  auto* w = (ClientWorker*)h;
  int expect = ST_VOID;
  if (!w->status.compare_exchange_strong(expect, ST_INIT)) return -1;
  w->c_host = host;
  w->c_port = port;
  w->c_mode = mode ? mode : "socket";
  w->c_status_cb = cb;
  w->c_status_ctx = ctx;
  return worker_start(w);
}

// ----- server

void* sw_server_new(const char* worker_id) {
  auto* w = new ServerWorker();
  w->worker_id = worker_id ? worker_id : "";
  w->trace.init();
  w->matcher.ring = &w->trace;
  w->matcher.ctr = &w->counters;
  w->matcher.hst = &w->hists;
  return w;
}

int sw_server_set_accept_cb(void* h, sw_accept_cb cb, void* ctx) {
  auto* w = (ServerWorker*)h;
  w->accept_cb = cb;
  w->accept_ctx = ctx;
  return 0;
}

// Returns the bound port (>0) or -errno.
int sw_server_listen(void* h, const char* addr, int port) {
  auto* w = (ServerWorker*)h;
  int expect = ST_VOID;
  if (!w->status.compare_exchange_strong(expect, ST_INIT)) return -EALREADY;
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd < 0) {
    int e = errno;
    w->status.store(ST_VOID);
    return -e;
  }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, addr, &sa.sin_addr) != 1) {
    close(fd);
    w->status.store(ST_VOID);
    return -EINVAL;
  }
  if (bind(fd, (sockaddr*)&sa, sizeof(sa)) < 0 || listen(fd, 512) < 0) {
    int e = errno;
    close(fd);
    w->status.store(ST_VOID);
    return -e;
  }
  socklen_t slen = sizeof(sa);
  getsockname(fd, (sockaddr*)&sa, &slen);
  w->listen_fd = fd;
  w->status.store(ST_RUNNING);
  if (worker_start(w) != 0) {
    close(fd);
    w->listen_fd = -1;
    w->status.store(ST_VOID);
    return -EIO;
  }
  return ntohs(sa.sin_port);
}

// ----- shared worker ops (h = client or server)

static Worker* W(void* h) { return (Worker*)h; }

int sw_send(void* h, uint64_t conn_id, const void* buf, uint64_t len, uint64_t tag,
            sw_done_cb done, sw_fail_cb fail, void* ctx,
            sw_done_cb release, void* release_ctx, double timeout_s) {
  Worker* w = W(h);
  {
    std::lock_guard<std::mutex> g(w->mu);
    if (w->status.load() != ST_RUNNING) return -1;
    Op op;
    op.kind = Op::SEND;
    op.conn_id = conn_id ? conn_id : w->primary_conn;
    op.buf = (const uint8_t*)buf;
    op.len = len;
    op.tag = tag;
    op.done = done;
    op.fail = fail;
    op.ctx = ctx;
    op.release = release;
    op.release_ctx = release_ctx;
    w->ops.push_back(op);
    // Recorded under mu, like sw_recv: once the lock drops the engine
    // thread may complete the op, and its DONE event must not precede
    // this POST in the ring.
    bump(w->counters.sends_posted);
    hbump(w->hists.msg_bytes, len);  // swpulse (§25)
    w->trace.rec(kEvSendPost, tag, conn_id, len);
  }
  if (timeout_s > 0) w->add_timer(Timer::SEND, ctx, timeout_s);
  w->wake();
  return 0;
}

void sw_set_devpull(void* h, int advertise, sw_devpull_cb cb,
                    sw_devpull_claim_cb claim_cb, void* ctx) {
  Worker* w = W(h);
  std::lock_guard<std::mutex> g(w->mu);
  w->devpull_advertise = advertise != 0;
  w->devpull_cb = cb;
  w->devpull_claim_cb = claim_cb;
  w->devpull_cb_ctx = ctx;
}

void sw_set_cudaipc(void* h, const char* identity) {
  Worker* w = W(h);
  std::lock_guard<std::mutex> g(w->mu);
  w->cudaipc_id = identity ? identity : "";
}

void sw_devpull_resolved(void* h, uint64_t conn_id, uint64_t msg_id, int ok) {
  // Callable from any thread (the embedder's pull-completion thread):
  // conn state is engine territory, so hop via the op queue.  `ok`
  // nonzero = the pull landed (a still-queued record becomes `ready` and
  // survives the sender's death, like a complete staged message).
  Worker* w = W(h);
  {
    std::lock_guard<std::mutex> g(w->mu);
    if (w->status.load() != ST_RUNNING) return;
    Op op;
    op.kind = Op::DEVPULL_RESOLVED;
    op.conn_id = conn_id;
    op.msg_id = msg_id;
    op.flags = ok;
    w->ops.push_back(op);
  }
  w->wake();
}

void sw_devpull_purge(void* h, uint64_t remote_id) {
  // A pull failed on a live conn: remove the matcher's record so it cannot
  // eat future receives (thread-safe; marshals to the engine thread).
  Worker* w = W(h);
  {
    std::lock_guard<std::mutex> g(w->mu);
    if (w->status.load() != ST_RUNNING) return;
    Op op;
    op.kind = Op::DEVPULL_PURGE;
    op.msg_id = remote_id;
    w->ops.push_back(op);
  }
  w->wake();
}

int sw_send_devpull(void* h, uint64_t conn_id, uint64_t tag,
                    const char* body, uint64_t len,
                    sw_done_cb done, sw_fail_cb fail, void* ctx) {
  Worker* w = W(h);
  {
    std::lock_guard<std::mutex> g(w->mu);
    if (w->status.load() != ST_RUNNING) return -1;
    Op op;
    op.kind = Op::SEND_DEVPULL;
    op.conn_id = conn_id ? conn_id : w->primary_conn;
    op.tag = tag;
    op.body.assign(body, (size_t)len);
    op.done = done;
    op.fail = fail;
    op.ctx = ctx;
    w->ops.push_back(op);
    bump(w->counters.sends_posted);  // under mu: POST must precede DONE
    // swpulse (§25): size of the advertised payload, not the descriptor
    // body -- the Python engine's submit_devpull twin.
    hbump(w->hists.msg_bytes, json_num_field(op.body, "n"));
    w->trace.rec(kEvSendPost, tag, conn_id, len);
  }
  w->wake();
  return 0;
}

int sw_recv(void* h, void* buf, uint64_t cap, uint64_t tag, uint64_t mask,
            sw_recv_cb done, sw_fail_cb fail, void* ctx, double timeout_s) {
  Worker* w = W(h);
  FireList fires;
  bool fc_work = false;
  {
    std::lock_guard<std::mutex> g(w->mu);
    if (w->status.load() != ST_RUNNING) return -1;
    // Posted before the matcher runs so the ring shows post -> match in
    // program order (bump/rec are lock-free; legal under mu).
    bump(w->counters.recvs_posted);
    w->trace.rec(kEvRecvPost, tag, 0, cap);
    PostedRecv pr;
    pr.buf = (uint8_t*)buf;
    pr.cap = cap;
    pr.tag = tag;
    pr.mask = mask;
    pr.done = done;
    pr.fail = fail;
    pr.ctx = ctx;
    Matcher::RemoteClaim claim;
    w->matcher.post_recv(pr, fires, &claim);
    if (claim.has) {
      // Deliver via the engine op queue: descriptor fires run on the
      // engine thread, so the embedder can never observe a claim before
      // the descriptor that created the record.
      Op op;
      op.kind = Op::DEVPULL_CLAIM;
      op.msg_id = claim.rid;
      op.rctx = claim.rctx;
      op.flags = claim.flags;
      w->ops.push_back(op);
      w->wake();
    }
    // §18: a claim/release above may have queued CTS or grant work the
    // engine thread must drain (fc_service).
    fc_work = !w->matcher.fc_cts.empty() || !w->matcher.pending_grants.empty();
  }
  if (fc_work) w->wake();
  // Armed after the matcher ran: an immediately-settled recv (matched a
  // complete unexpected message / truncated) leaves a no-op timer behind.
  // The wake makes the engine recompute its epoll timeout.
  if (timeout_s > 0) {
    w->add_timer(Timer::RECV, ctx, timeout_s);
    w->wake();
  }
  for (auto& f : fires) f();
  return 0;
}

int sw_flush(void* h, uint64_t conn_id, int conn_scoped,
             sw_done_cb done, sw_fail_cb fail, void* ctx, double timeout_s) {
  Worker* w = W(h);
  {
    std::lock_guard<std::mutex> g(w->mu);
    if (w->status.load() != ST_RUNNING) return -1;
    Op op;
    op.kind = Op::FLUSH;
    op.conn_id = conn_id;
    op.conn_scoped = conn_scoped != 0;
    op.done = done;
    op.fail = fail;
    op.ctx = ctx;
    w->ops.push_back(op);
    bump(w->counters.flushes_posted);  // under mu: POST must precede DONE
    w->trace.rec(kEvFlushPost, 0, conn_id);
  }
  if (timeout_s > 0) w->add_timer(Timer::FLUSH, ctx, timeout_s);
  w->wake();
  return 0;
}

int sw_close(void* h, sw_done_cb done, void* ctx) {
  Worker* w = W(h);
  {
    std::lock_guard<std::mutex> g(w->mu);
    int st = w->status.load();
    if (st != ST_RUNNING) return -1;
    w->close_done = done;
    w->close_ctx = ctx;
    w->status.store(ST_CLOSING);
  }
  w->wake();
  return 0;
}

int sw_status(void* h) { return W(h)->status.load(); }

uint64_t sw_primary_conn(void* h) { return W(h)->primary_conn; }

// List live+dead handshaken conn ids; returns count (may exceed cap).
int sw_list_conns(void* h, uint64_t* out, int cap) {
  Worker* w = W(h);
  std::lock_guard<std::mutex> g(w->mu);
  int n = 0;
  for (auto& [id, c] : w->conns) {
    if (n < cap) out[n] = id;
    n++;
  }
  return n;
}

// JSON conn info into out (returns body length or -1).
int sw_conn_info(void* h, uint64_t conn_id, char* out, int cap) {
  Worker* w = W(h);
  std::lock_guard<std::mutex> g(w->mu);
  auto it = w->conns.find(conn_id);
  if (it == w->conns.end()) return -1;
  Conn* c = it->second;
  char buf[1024];
  int n = snprintf(buf, sizeof(buf),
                   "{\"name\": \"%s\", \"mode\": \"%s\", \"alive\": %d, "
                   "\"local_addr\": \"%s\", \"local_port\": %d, "
                   "\"remote_addr\": \"%s\", \"remote_port\": %d, "
                   "\"transport\": \"%s\", \"devpull\": %d, \"rails\": %d, "
                   "\"cudaipc\": \"%s\"}",
                   c->peer_name.c_str(), c->mode.c_str(), c->alive ? 1 : 0,
                   c->local_addr.c_str(), c->local_port,
                   c->remote_addr.c_str(), c->remote_port,
                   c->sm_negotiated ? "sm" : "tcp", c->devpull_ok ? 1 : 0,
                   (int)c->rails.size(), c->cudaipc_peer.c_str());
  if (n < 0 || n >= cap) return -1;
  memcpy(out, buf, (size_t)n + 1);
  return n;
}

// Counter snapshot over the shared vocabulary as a JSON object
// (sw_engine.h).  Thread-safe: relaxed loads of the atomic registry.
int sw_counters(void* h, char* out, int cap) {
  Worker* w = W(h);
  Counters& c = w->counters;
  const uint64_t vals[] = {
      c.sends_posted.load(),   c.sends_completed.load(),
      c.recvs_posted.load(),   c.recvs_completed.load(),
      c.flushes_posted.load(), c.flushes_completed.load(),
      c.ops_timed_out.load(),  c.ops_cancelled.load(),
      c.bytes_tx.load(),       c.bytes_rx.load(),
      c.gather_passes.load(),  c.gather_items.load(),
      c.staging_hits.load(),   c.staging_misses.load(),
      c.ka_misses.load(),      c.reconnects.load(),
      c.sessions_resumed.load(), c.frames_replayed.load(),
      c.dup_frames_dropped.load(),
      c.acks_tx.load(),        c.acks_rx.load(),
      c.stripe_chunks_tx.load(), c.stripe_chunks_rx.load(),
      c.rail_resteals.load(),
      c.sends_parked.load(),   c.sheds.load(),
      c.csum_fail.load(),      c.chunk_retx.load(),
      c.reshard_bytes.load(),  c.reshard_rounds.load(),
      c.io_syscalls.load(),    c.hot_copies.load(),
      c.uring_submits.load(),  c.uring_sqes.load(),
      c.zc_sends.load(),       c.zc_notifies.load(),
      c.busypoll_hits.load(),
      c.stall_alerts.load(),
  };
  constexpr size_t kN = sizeof(kCounterNames) / sizeof(kCounterNames[0]);
  static_assert(sizeof(vals) / sizeof(vals[0]) == kN,
                "counter names and values out of sync");
  int off = 0;
  for (size_t i = 0; i < kN; i++) {
    int m = snprintf(out + off, cap > off ? (size_t)(cap - off) : 0,
                     "%s\"%s\": %llu", i == 0 ? "{" : ", ", kCounterNames[i],
                     (unsigned long long)vals[i]);
    if (m < 0 || off + m >= cap) return -1;
    off += m;
  }
  if (off + 2 >= cap) return -1;
  out[off++] = '}';
  out[off] = 0;
  return off;
}

// swpulse histogram snapshot (sw_engine.h, DESIGN.md §25): a JSON object
// {"<name>": [64 bucket counts], ...} over the kHistNames vocabulary, in
// declaration order.  Thread-safe: relaxed loads of the atomic arrays.
int sw_hists(void* h, char* out, int cap) {
  Worker* w = W(h);
  Hists& hs = w->hists;
  const std::atomic<uint64_t>* rows[] = {
      hs.send_local_us, hs.recv_wait_us, hs.flush_us,
      hs.park_us,       hs.pin_us,       hs.msg_bytes,
  };
  constexpr size_t kN = sizeof(kHistNames) / sizeof(kHistNames[0]);
  static_assert(sizeof(rows) / sizeof(rows[0]) == kN,
                "hist names and rows out of sync");
  int off = 0;
  for (size_t i = 0; i < kN; i++) {
    int m = snprintf(out + off, cap > off ? (size_t)(cap - off) : 0,
                     "%s\"%s\": [", i == 0 ? "{" : ", ", kHistNames[i]);
    if (m < 0 || off + m >= cap) return -1;
    off += m;
    for (int b = 0; b < kHistBuckets; b++) {
      m = snprintf(out + off, cap > off ? (size_t)(cap - off) : 0,
                   "%s%llu", b == 0 ? "" : ", ",
                   (unsigned long long)rows[i][b].load(
                       std::memory_order_relaxed));
      if (m < 0 || off + m >= cap) return -1;
      off += m;
    }
    if (off + 1 >= cap) return -1;
    out[off++] = ']';
  }
  if (off + 2 >= cap) return -1;
  out[off++] = '}';
  out[off] = 0;
  return off;
}

// Trace-ring dump as a JSON array, oldest first (sw_engine.h).  Reads the
// ring without locking; an entry mid-overwrite may render garbled but the
// JSON framing stays intact (ev written last; reason always terminated).
int sw_trace(void* h, char* out, int cap) {
  Worker* w = W(h);
  TraceRing& r = w->trace;
  if (cap < 3) return -1;
  int off = 0;
  out[off++] = '[';
  if (r.enabled) {
    uint64_t end = r.widx.load(std::memory_order_relaxed);
    uint64_t n = end < r.cap ? end : r.cap;
    bool first = true;
    for (uint64_t i = end - n; i < end; i++) {
      const TraceEvent& e = r.buf[(size_t)(i % r.cap)];
      if (!e.ev) continue;
      int m = snprintf(
          out + off, (size_t)(cap - off),
          "%s{\"t\": %.9f, \"ev\": \"%s\", \"tag\": %llu, \"conn\": %llu, "
          "\"n\": %llu, \"reason\": \"%s\"}",
          first ? "" : ", ", e.t, e.ev, (unsigned long long)e.tag,
          (unsigned long long)e.conn, (unsigned long long)e.nbytes, e.reason);
      if (m < 0 || off + m >= cap - 2) return -1;
      off += m;
      first = false;
    }
  }
  out[off++] = ']';
  out[off] = 0;
  return off;
}

// swscope gauge snapshot (sw_engine.h).  The gauges read live
// engine-owned queues, so the call marshals to the engine thread via the
// op queue and parks on a condvar; direct render when called ON the
// engine thread (a user callback) or when the engine is quiescent
// (VOID/CLOSED).  A wedged engine times out to -1 instead of hanging
// the sampler.
int sw_gauges(void* h, char* out, int cap) {
  Worker* w = W(h);
  std::string json;
  if (std::this_thread::get_id() == w->engine_tid) {
    json = w->gauges_json();
  } else {
    auto wait = std::make_shared<GaugesWait>();
    bool queued = false;
    {
      std::lock_guard<std::mutex> g(w->mu);
      int st = w->status.load();
      if (st == ST_INIT || st == ST_RUNNING || st == ST_CLOSING) {
        Op op;
        op.kind = Op::GAUGES;
        op.gwait = wait;
        w->ops.push_back(op);
        queued = true;
      }
    }
    if (queued) {
      w->wake();
      std::unique_lock<std::mutex> lk(wait->m);
      if (!wait->cv.wait_for(lk, std::chrono::seconds(2),
                             [&] { return wait->done; }))
        return -1;  // engine wedged: no snapshot beats a torn one
      json = wait->json;
    } else {
      // VOID / CLOSED: no engine thread is touching conn queues.
      json = w->gauges_json();
    }
  }
  int n = (int)json.size();
  // Cap too small: report the needed size (negated, incl. NUL) so the
  // caller can retry sized exactly -- a high-fan-out worker's snapshot
  // must not silently degrade to empty.  Distinct from the wedged -1
  // (n >= 20 always, so -(n + 1) never collides with it).
  if (n + 1 > cap) return -(n + 1);
  memcpy(out, json.c_str(), (size_t)n + 1);
  return n;
}

// Engine-event notifications (session resume/expiry) for the wrapper's
// flight recorder.  Persistent registration; fires on the engine thread
// with no locks held (FireList discipline).  Install before
// listen/connect.
void sw_set_event_cb(void* h, sw_event_cb cb, void* ctx) {
  Worker* w = W(h);
  std::lock_guard<std::mutex> g(w->mu);
  w->event_cb = cb;
  w->event_cb_ctx = ctx;
}

// Destructor path: never blocks, never fails.  Signals close if running and
// drops the Python reference; the engine thread frees the worker when done.
void sw_free(void* h) {
  Worker* w = W(h);
  int st = w->status.load();
  if (st == ST_RUNNING) {
    std::lock_guard<std::mutex> g(w->mu);
    w->close_done = nullptr;
    w->status.store(ST_CLOSING);
    w->wake();
  } else if (st == ST_INIT) {
    w->status.store(ST_CLOSING);
    w->wake();
  }
  w->unref();
}

}  // extern "C"
