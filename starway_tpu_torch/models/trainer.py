"""Minimal training harness for the model family: the train step, host-side
telemetry (utils.trace.OpTimer), checkpointing (utils.checkpoint) and --
when a DP-boundary port is supplied -- averaged gradient exchange with a
peer rank over the transport (parallel/dp_exchange.py).

The port of the JAX package's ``models/trainer.py``.  The options that
need layers the port does not have yet raise ``NotImplementedError``:
``mesh``/``fsdp_axis`` (ZeRO sharding in the parallel layer) and the
training of mixture-of-experts models (``moe_fn``, ``with_moe_stats``,
expert configs: the next MoE slice); ROADMAP.md lists them.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..utils.trace import OpTimer, trace_span
from ..utils.tree import tree_leaves, tree_map
from .llama import (_MOE_TODO, LlamaConfig, apply_updates, make_train_step,
                    value_and_grad)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1 item 6: the rest "
        f"of the parallel layer)")


class Trainer:
    def __init__(self, cfg: LlamaConfig, tx, params,
                 attn_fn: Optional[Callable] = None,
                 donate: bool = True,
                 dp_port=None, dp_base_tag: int = 0x6000,
                 mesh=None, fsdp_axis: Optional[str] = None,
                 moe_fn: Optional[Callable] = None,
                 with_moe_stats: bool = False,
                 accum_steps: int = 1):
        """``tx``: an optimizer with ``init``/``update`` (utils.optim
        .adamw).  ``donate``: update the parameter tensors in place, where
        the JAX trainer donates their buffers; ``donate=False`` leaves the
        caller's ``params`` as they were.  ``accum_steps``: gradient
        accumulation over that many equal microbatches, float32 sums, one
        optimizer update (make_train_step).

        ``dp_port``: a ClientPort/ServerPort (parallel.dp_exchange) to a
        peer rank; :meth:`step_dp` then averages the gradients with the
        peer's every step before the update.  ``dp_base_tag``: start of
        the tag range the exchange occupies, ``[dp_base_tag, dp_base_tag
        + 1024 * 256)`` -- 1024 in-flight steps x 256 leaves -- so any
        other tree exchange on the same worker must use tags outside it.
        The exchange averages full-batch gradients: it refuses
        ``accum_steps > 1`` and ZeRO mode."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1 and dp_port is not None:
            raise ValueError(
                "accum_steps composes with the local/fsdp step only; the "
                "dp_port exchange path averages full-batch grads")
        if dp_port is not None and (mesh is not None
                                    or fsdp_axis is not None):
            raise ValueError("fsdp mode and dp_port are mutually exclusive")
        if mesh is not None or fsdp_axis is not None:
            raise _unported("mesh/fsdp_axis (ZeRO sharding)")
        if moe_fn is not None or with_moe_stats or cfg.n_experts > 0:
            raise NotImplementedError(_MOE_TODO)
        if dp_port is not None:
            # step_dp gives each step a 256-tag window (base advances by 256
            # per step); more leaves than that would collide across steps.
            n_leaves = len(tree_leaves(params))
            if n_leaves > 256:
                raise ValueError(
                    f"DP gradient exchange supports <= 256 pytree leaves per "
                    f"step; got {n_leaves} (stack per-layer params, or widen "
                    f"the tag window)")
        self.cfg = cfg
        self.tx = tx
        self.attn_fn = attn_fn
        self.donate = donate
        self.state = TrainState(params=params, opt_state=tx.init(params))
        self.timer = OpTimer()
        self.dp_port = dp_port
        self.dp_base_tag = dp_base_tag
        self._accum_step = None
        if accum_steps > 1:
            self._accum_step = make_train_step(
                cfg, tx, attn_fn, accum_steps=accum_steps, in_place=donate)

    def step_sync(self, batch) -> float:
        """One local step; returns the loss."""
        st = self.state
        if self._accum_step is not None:
            with self._span("accum_step"):
                st.params, st.opt_state, loss = self._accum_step(
                    st.params, st.opt_state, batch)
            st.step += 1
            return float(loss)
        with self._span("grad"):
            loss, grads = value_and_grad(st.params, batch, self.cfg,
                                         self.attn_fn)
        with self._span("apply"):
            st.params, st.opt_state = apply_updates(
                self.tx, st.params, st.opt_state, grads,
                in_place=self.donate)
        st.step += 1
        return float(loss)

    async def step_dp(self, batch) -> float:
        """One step with the gradients averaged across the DP port: the
        local gradients go out while the peer's come in, in this step's
        window of 256 tags, then ``(a + b) / 2`` is applied.  Both ranks
        compute the same sums, so ranks that start equal stay equal bit
        for bit."""
        from ..parallel.dp_exchange import recv_pytree, send_pytree

        if self.dp_port is None:
            raise ValueError("step_dp needs a Trainer built with dp_port")
        st = self.state
        with self._span("grad"):
            loss, grads = value_and_grad(st.params, batch, self.cfg,
                                         self.attn_fn)
        with self._span("dp_exchange"):
            base = self.dp_base_tag + (st.step % 1024) * 256
            send_task = asyncio.ensure_future(
                send_pytree(self.dp_port, grads, base_tag=base))
            peer = await recv_pytree(self.dp_port, like=grads, base_tag=base)
            await send_task
            grads = tree_map(lambda a, b: (a + b) / 2, grads, peer)
            del peer
        with self._span("apply"):
            st.params, st.opt_state = apply_updates(
                self.tx, st.params, st.opt_state, grads,
                in_place=self.donate)
        st.step += 1
        return float(loss)

    @contextlib.contextmanager
    def _span(self, name: str):
        """A host-clock span of the telemetry that is also a profiler
        range, so a trace attributes the device time to the phase."""
        with self.timer.span(name), trace_span(name):
            yield

    # ------------------------------------------------------------ ckpt
    def _tree(self) -> dict:
        return {"params": self.state.params,
                "opt_state": self.state.opt_state,
                "step": torch.tensor(self.state.step, dtype=torch.int32)}

    def save(self, path: str) -> str:
        from ..utils.checkpoint import save_pytree

        return save_pytree(path, self._tree())

    def restore(self, path: str) -> None:
        from ..utils.checkpoint import restore_pytree

        got = restore_pytree(path, self._tree())
        self.state = TrainState(params=got["params"],
                                opt_state=got["opt_state"],
                                step=int(got["step"]))

    def telemetry(self) -> dict:
        return self.timer.summary()
