"""Host runtime core: tag matching, connections, worker engines.

Layer L2 of the build (SURVEY.md section 1) -- the TPU-native replacement for
the reference's C++ binding core (src/bindings/).  A C++ implementation of
this engine lives in ``native/`` and is preferred when built
(``STARWAY_NATIVE=1``); this Python implementation is the portable fallback
and the behavioural specification.
"""

from .endpoint import ServerEndpoint
from .engine import ClientWorker, ServerWorker

__all__ = ["ServerEndpoint", "ClientWorker", "ServerWorker"]
