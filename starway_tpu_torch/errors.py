"""Error types for starway-tpu.

The reference surfaces failures as plain ``Exception(reason)`` built from UCS
status strings (reference: src/starway/__init__.py:127-128) and raises
``RuntimeError`` for lifecycle violations such as double close (reference:
tests/test_basic.py:500-511).  We keep those observable contracts:

* lifecycle violations raise :class:`StarwayStateError` (a ``RuntimeError``),
* operation failures are delivered to ``fail_callback(reason: str)`` where
  ``reason`` contains a stable keyword:

  - ``"cancel"``     -- op cancelled by local close (tests/test_basic.py:638-663)
  - ``"not connected"`` -- connect failure / op on dead endpoint
    (tests/test_basic.py:514-518), including peer-liveness expiry when
    keepalive is enabled (STARWAY_KEEPALIVE, see config.py)
  - ``"truncated"``  -- message larger than the posted receive buffer
  - ``"timed out"``  -- op deadline (``timeout=`` on asend/arecv/aflush/
    aconnect) expired before completion (tests/test_faults.py)
  - ``"session expired"`` -- a session-enabled connection (``STARWAY_SESSION``,
    see config.py) stayed dead past ``STARWAY_SESSION_GRACE``, or the peer
    answered the resume handshake with a new epoch; ops that were riding
    out the outage fail with this reason instead of completing late
    (tests/test_session.py)
  - ``"corrupt"``    -- the negotiated integrity plane (``STARWAY_INTEGRITY``,
    DESIGN.md §19) detected silent data corruption that cannot be repaired
    by a chunk retransmit: a frame-header/payload checksum mismatch on a
    non-striped frame, or a torn shared-memory ring record.  The poisoned
    connection resets; with ``STARWAY_SESSION=1`` it suspends and the
    journal replay re-delivers verified bytes instead (tests/test_integrity.py)
"""

from __future__ import annotations


class StarwayError(Exception):
    """Base class for all starway-tpu errors."""


class StarwayStateError(RuntimeError):
    """Lifecycle violation: op issued while the worker is in the wrong state.

    RuntimeError subclass so ``pytest.raises(RuntimeError)`` on double close
    matches the reference behaviour (tests/test_basic.py:508-511).
    """


# Stable reason strings passed to fail callbacks.  Keyword contracts mirror the
# reference's UCS status strings surfaced through Exception(reason).
REASON_CANCELLED = "Operation cancelled (local endpoint closed before completion)"
REASON_NOT_CONNECTED = "Endpoint is not connected"
REASON_TRUNCATED = "Message truncated: payload larger than posted receive buffer"
REASON_TIMEOUT = "Operation timed out (deadline exceeded before completion)"
REASON_SESSION_EXPIRED = "Session expired (resume window elapsed or peer restarted)"
REASON_CORRUPT = "Data integrity violation (corrupt frame detected)"
REASON_INTERNAL = "Internal transport error"
