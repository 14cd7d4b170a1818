"""Token-stream batching for the training loop (numpy only).

The port's own copy of the JAX package's ``utils/data.py``, kept apart so
that the port imports nothing of that package: a deterministic,
epoch-shuffled sampler of next-token windows over one flat token array.
Memmap-friendly — pass ``np.memmap`` (or use :func:`load_tokens`) and only
the touched windows are read from disk; batches come out as host
``np.ndarray`` so the caller places them (``torch.from_numpy(batch)
.to("cuda")``).  The same seed gives the same batches as the JAX copy.

>>> tokens = load_tokens("corpus.bin", dtype=np.uint16)
>>> for batch in TokenBatcher(tokens, batch_size=8, seq_len=1024, seed=0):
...     loss = trainer.step_sync(torch.from_numpy(batch).to("cuda"))
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np


def load_tokens(path: str, dtype=None) -> np.ndarray:
    """Memmap a flat token file: ``.npy`` (dtype from the header) or raw
    binary (``dtype`` required, e.g. ``np.uint16`` for GPT-2 BPE ids)."""
    p = Path(path)
    if p.suffix == ".npy":
        arr = np.load(p, mmap_mode="r")
        if dtype is not None and np.dtype(dtype) != arr.dtype:
            raise ValueError(
                f"{p} holds {arr.dtype} tokens, caller asked for "
                f"{np.dtype(dtype)}")
        return arr
    if dtype is None:
        raise ValueError(f"raw token file {p} needs an explicit dtype")
    return np.memmap(p, dtype=dtype, mode="r")


class TokenBatcher:
    """Deterministic epoch-shuffled ``[batch_size, seq_len + 1]`` windows.

    The stream is cut into non-overlapping windows of ``seq_len + 1``
    tokens (input + shifted target share the window, the convention
    ``loss_fn`` expects); each epoch visits every window exactly once in a
    seed-derived order (epoch folded into the seed, so order differs per
    epoch but is reproducible).  A trailing partial window is dropped, and
    the final partial batch of an epoch is dropped too — static shapes, no
    recompiles.

    ``epochs=None`` iterates forever; ``state``/``restore`` round-trip the
    cursor for checkpoint/resume alignment.
    """

    def __init__(self, tokens, batch_size: int, seq_len: int, *,
                 seed: int = 0, epochs: Optional[int] = None):
        if len(tokens) < seq_len + 1:
            raise ValueError(
                f"stream of {len(tokens)} tokens is shorter than one "
                f"window ({seq_len + 1})")
        self.tokens = tokens
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.epochs = epochs
        self.n_windows = len(tokens) // (seq_len + 1)
        self.batches_per_epoch = self.n_windows // batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"{self.n_windows} windows cannot fill one batch of "
                f"{batch_size}")
        self._epoch = 0
        self._batch = 0
        self._active = False

    # ------------------------------------------------------------ resume
    def state(self) -> dict:
        """Cursor + the geometry it is only valid against."""
        return {"epoch": self._epoch, "batch": self._batch,
                "seed": self.seed, "batch_size": self.batch_size,
                "seq_len": self.seq_len, "n_windows": self.n_windows}

    def restore(self, state: dict) -> None:
        """Resume from :meth:`state`; refuses a cursor whose geometry does
        not match this batcher (a changed batch size / sequence length /
        corpus would silently misalign which windows get visited)."""
        for key in ("seed", "batch_size", "seq_len", "n_windows"):
            if key in state and state[key] != getattr(self, key):
                raise ValueError(
                    f"batcher state mismatch: saved {key}={state[key]}, "
                    f"this batcher has {getattr(self, key)}")
        self._epoch = int(state["epoch"])
        self._batch = int(state["batch"])

    # ---------------------------------------------------------- iterate
    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n_windows)

    def reset(self) -> None:
        """Rewind to epoch 0 (re-iterating an epochs-bounded batcher).
        Refuses while an iterator is live — resetting the shared cursor
        under a running loop would silently rewind it."""
        if self._active:
            raise RuntimeError(
                "TokenBatcher.reset() with a live iterator; close it first")
        self._epoch = 0
        self._batch = 0

    def __iter__(self) -> "_BatcherIter":
        # The cursor is instance state (that is what makes state()/restore()
        # resume work), so iteration is single-consumer: a second live
        # iterator would silently interleave, and an exhausted bounded
        # batcher would silently yield nothing — both fail loudly instead.
        # The active mark is taken HERE, not at first next(), so two
        # iterators created back-to-back cannot both slip past the check;
        # the wrapper releases it on close/GC even if never advanced (a
        # bare generator's finally would not run in that case).
        if self.epochs is not None and self._epoch >= self.epochs:
            raise RuntimeError(
                "TokenBatcher exhausted; call reset() to re-iterate")
        if self._active:
            raise RuntimeError(
                "TokenBatcher supports one active iterator (the resume "
                "cursor is shared instance state)")
        self._active = True
        return _BatcherIter(self)

    def _gen(self) -> Iterator[np.ndarray]:
        w = self.seq_len + 1
        while self.epochs is None or self._epoch < self.epochs:
            order = self._order(self._epoch)
            while self._batch < self.batches_per_epoch:
                idx = order[self._batch * self.batch_size:
                            (self._batch + 1) * self.batch_size]
                batch = np.stack(
                    [np.asarray(self.tokens[i * w:(i + 1) * w]) for i in idx])
                self._batch += 1
                yield batch.astype(np.int32)
            self._batch = 0
            self._epoch += 1


class _BatcherIter:
    """Iterator handle owning the batcher's active mark: released on
    exhaustion, close(), or garbage collection — including before the
    first ``next()``."""

    __slots__ = ("_owner", "_gen")

    def __init__(self, owner: TokenBatcher):
        self._owner = owner
        self._gen = owner._gen()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._gen)
        except BaseException:
            self._release()
            raise

    def close(self) -> None:
        self._gen.close()
        self._release()

    __del__ = close

    def _release(self) -> None:
        if self._owner is not None:
            self._owner._active = False
            self._owner = None
