"""Resilient-session state: sequence numbers, replay journal, resume.

The seed failure contract is "a dropped conn cancels every in-flight op"
(tests/test_basic.py).  ``STARWAY_SESSION=1`` (config.py) opts a
Client<->Server pair into riding through transient peer loss instead --
the way portable collective layers assume a reliable substrate
(arXiv:2112.01075) and multi-path transfer stacks re-issue work after a
path failure.  One :class:`SessionState` hangs off each session-enabled
``TcpConn`` (core/conn.py) and carries everything that must survive a
connection incarnation:

* **TX**: the next sequence number, and the bounded replay **journal** --
  the tx items (TxData/TxCtl/TxDevpull) of every sequenced frame, kept
  until the peer's cumulative ACK covers them.  Eager payloads are copied
  at framing time (the user may legally reuse the buffer once ``done``
  fires); rendezvous/chunked payloads are held by reference (delivery is
  only promised after a flush, and the journal pins the payload object
  until acked -- DESIGN.md §14 documents the stability requirement).
  When journaled-but-unacked bytes reach ``STARWAY_SESSION_JOURNAL_BYTES``
  new frames park in ``waiting`` unframed: the send *blocks* (completes
  late) rather than growing the journal without bound.
* **RX**: the cumulative in-order sequence received (``rx_cum``), the last
  cumulative ACK sent (``acked_sent``), and dedup bookkeeping -- a frame
  whose seq is already covered by ``rx_cum`` is drained and dropped
  (``dup_frames_dropped``), which is what makes replay exactly-once.
* **Lifecycle**: ``suspended`` (transport gone, resumable), ``expired``
  (grace elapsed or epoch mismatch: the terminal state), the resume
  deadline, and the client's redial backoff counter.

The wire protocol half lives in core/frames.py (T_SEQ/T_ACK and the
``sess``/``sess_id``/``sess_epoch``/``sess_ack`` handshake keys); the C++
engine implements the identical machine in native/sw_engine.cpp
(``Session``), and the two interoperate in mixed-engine pairs.
"""

from __future__ import annotations

import time
from collections import deque

from .. import config


class SessionState:
    """Per-conn session bookkeeping (both directions)."""

    __slots__ = (
        "sid", "epoch", "journal_cap", "grace",
        "tx_seq", "journal", "journal_bytes", "waiting", "peer_acked",
        "rx_cum", "acked_sent",
        "suspended", "expired", "deadline", "redial_attempt",
    )

    def __init__(self, sid: str, epoch: str):
        self.sid = sid
        self.epoch = epoch
        self.journal_cap = config.session_journal_bytes()
        self.grace = config.session_grace()
        # -- tx side
        self.tx_seq = 0            # last sequence number assigned
        self.journal: deque = deque()   # framed, unacked tx items (seq order)
        self.journal_bytes = 0
        self.waiting: deque = deque()   # unframed items parked by backpressure
        self.peer_acked = 0        # highest cumulative ACK received
        # -- rx side
        self.rx_cum = 0            # highest in-order seq fully processed
        self.acked_sent = 0        # last cumulative ACK we put on the wire
        # -- lifecycle
        self.suspended = False
        self.expired = False
        self.deadline = 0.0        # monotonic resume deadline while suspended
        self.redial_attempt = 0

    # ------------------------------------------------------------------ tx
    def next_seq(self) -> int:
        self.tx_seq += 1
        return self.tx_seq

    def has_room(self, nbytes: int) -> bool:
        """May a frame of ``nbytes`` be journaled now?  An empty journal
        always admits one frame (a single payload above the cap must not
        deadlock); parked items keep FIFO order, so nothing may be framed
        while ``waiting`` is non-empty."""
        if self.waiting:
            return False
        if not self.journal:
            return True
        return self.journal_bytes + nbytes <= self.journal_cap

    def journal_add(self, item, nbytes: int) -> None:
        self.journal.append(item)
        self.journal_bytes += nbytes

    def journal_trim(self, cum_ack: int) -> list:
        """Drop journal entries covered by the peer's cumulative ACK.
        Returns the dropped items (the caller releases any deferred
        payload pins)."""
        if cum_ack > self.peer_acked:
            self.peer_acked = cum_ack
        dropped = []
        while self.journal and self.journal[0].sess_seq <= cum_ack:
            item = self.journal.popleft()
            self.journal_bytes -= item.sess_nbytes
            dropped.append(item)
        if not self.journal:
            self.journal_bytes = 0
        return dropped

    # ----------------------------------------------------------- lifecycle
    def suspend(self) -> None:
        self.suspended = True
        self.deadline = time.monotonic() + self.grace

    def resume(self) -> None:
        self.suspended = False
        self.redial_attempt = 0

    def redial_delay(self) -> float:
        """Exponential backoff for the next redial attempt (the PR-1
        backoff shape: doubling base, capped; the caller adds jitter)."""
        self.redial_attempt += 1
        return min(1.0, 0.05 * (2 ** min(self.redial_attempt - 1, 5)))
