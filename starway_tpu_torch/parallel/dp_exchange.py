"""DP-boundary pytree transfer over the async P2P API.

The gradient transfer at a data-parallel boundary (BASELINE config 5, a
Llama-3 8B gradient tree between two ranks).  The unit of exchange is a
tree of tensors (a gradient tree, an activation dict); each leaf becomes
one tagged message, tags are ``base_tag + leaf_index``, and a flush
closes the batch.  Leaves are numbered in JAX's flatten order
(utils/tree.py: dict keys sorted), so a JAX rank running
``starway_tpu.parallel.dp_exchange`` and a torch rank running this module
exchange the same tree on one wire.

Ports unify the two directions of the Client/Server API so the same
transfer code runs on either side:

>>> await send_pytree(ClientPort(client), grads, base_tag=0x50000)
>>> grads2 = await recv_pytree(ServerPort(server), like=grads, base_tag=0x50000)
"""

from __future__ import annotations

import asyncio
from typing import Any

from ..device import DeviceBuffer
from ..utils.tree import tree_leaves, tree_unflatten

FULL_MASK = (1 << 64) - 1


class ClientPort:
    """Client side of a duplex link."""

    def __init__(self, client):
        self._c = client

    def asend(self, buf, tag):
        return self._c.asend(buf, tag)

    def arecv(self, buf, tag, mask=FULL_MASK):
        return self._c.arecv(buf, tag, mask)

    def aflush(self):
        return self._c.aflush()


class ServerPort:
    """Server side of a duplex link.

    Sends are bound to one endpoint; receives are worker-wide tag matches.
    With several peers exchanging concurrently, give each peer a disjoint
    ``base_tag`` range (the Trainer's DP exchange occupies
    ``[dp_base_tag, dp_base_tag + 0x40000)``): tags are the routing key."""

    def __init__(self, server, endpoint=None):
        self._s = server
        if endpoint is None:
            clients = server.list_clients()
            if not clients:
                raise ValueError("server has no connected endpoints")
            endpoint = next(iter(clients))
        self._ep = endpoint

    def asend(self, buf, tag):
        return self._s.asend(self._ep, buf, tag)

    def arecv(self, buf, tag, mask=FULL_MASK):
        return self._s.arecv(buf, tag, mask)

    def aflush(self):
        return self._s.aflush_ep(self._ep)


async def send_pytree(port, tree: Any, base_tag: int, *,
                      flush: bool = True) -> int:
    """Send every leaf of ``tree`` as a tagged message; returns the leaf
    count.

    Leaves go out concurrently (the engine pipelines them); ``flush=True``
    appends the delivery barrier so the batch survives a subsequent
    close.  A send completes once the leaf is snapshotted or staged, so
    the caller may overwrite the tensors afterwards."""
    leaves = tree_leaves(tree)
    await asyncio.gather(*(port.asend(leaf.detach(), base_tag + i)
                           for i, leaf in enumerate(leaves)))
    if flush:
        await port.aflush()
    return len(leaves)


async def recv_pytree(port, like: Any, base_tag: int, *, device=None) -> Any:
    """Receive a tree shaped like ``like``; returns the tree of received
    tensors, on ``device`` or on each leaf's own device."""
    sinks = [DeviceBuffer.like(leaf, device=device)
             for leaf in tree_leaves(like)]
    await asyncio.gather(*(port.arecv(sink, base_tag + i)
                           for i, sink in enumerate(sinks)))
    return tree_unflatten(like, [s.array for s in sinks])
