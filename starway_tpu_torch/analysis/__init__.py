"""The part of the JAX package's static analysis that the runtime protocol
monitor needs (``core/monitor.py``, ``STARWAY_MONITOR=1``): the protocol
model extracted from this package's own engine sources (``protomodel``,
``py_model``, ``base``) and the monitor automaton compiled from it
(``refine``, with its event corpus ``refine_corpus.txt``).  Stdlib only;
sources are parsed, never imported.  The other passes of the JAX
package's analysis gate are not part of the port."""
