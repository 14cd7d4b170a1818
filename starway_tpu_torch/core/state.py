"""Worker lifecycle states.

Mirrors the reference's 5-state lifecycle atomic (``0 void, 1 init,
2 running, 3 to-close, 4 closed``; reference: src/bindings/main.hpp:306-376,
SURVEY.md section 2 #5/#6).  Connect/listen are once-only transitions and a
second close raises (tests/test_basic.py:485-511).
"""

VOID = 0
INIT = 1
RUNNING = 2
CLOSING = 3
CLOSED = 4

NAMES = {VOID: "VOID", INIT: "INIT", RUNNING: "RUNNING", CLOSING: "CLOSING", CLOSED: "CLOSED"}
