"""Minimal training harness for the model family: the train step, host-side
telemetry (utils.trace.OpTimer) and checkpointing (utils.checkpoint).

The port of the JAX package's ``models/trainer.py`` for one device.  The
options that need layers the port does not have yet raise
``NotImplementedError``: ``dp_port`` (gradient exchange over the
transport), ``mesh``/``fsdp_axis`` (the parallel layer) and
mixture-of-experts models (``moe_fn``, ``with_moe_stats``, expert
configs); ROADMAP.md lists them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..utils.trace import OpTimer, trace_span
from .llama import (_MOE_TODO, LlamaConfig, apply_updates, make_train_step,
                    value_and_grad)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: the transport and "
        f"the parallel layer)")


class Trainer:
    def __init__(self, cfg: LlamaConfig, tx, params,
                 attn_fn: Optional[Callable] = None,
                 donate: bool = True,
                 dp_port=None,
                 mesh=None, fsdp_axis: Optional[str] = None,
                 moe_fn: Optional[Callable] = None,
                 with_moe_stats: bool = False,
                 accum_steps: int = 1):
        """``tx``: an optimizer with ``init``/``update`` (utils.optim
        .adamw).  ``donate``: update the parameter tensors in place, where
        the JAX trainer donates their buffers; ``donate=False`` leaves the
        caller's ``params`` as they were.  ``accum_steps``: gradient
        accumulation over that many equal microbatches, float32 sums, one
        optimizer update (make_train_step)."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if dp_port is not None:
            raise _unported("dp_port (DP gradient exchange over the "
                            "transport)")
        if mesh is not None or fsdp_axis is not None:
            raise _unported("mesh/fsdp_axis (ZeRO sharding)")
        if moe_fn is not None or with_moe_stats or cfg.n_experts > 0:
            raise NotImplementedError(_MOE_TODO)
        self.cfg = cfg
        self.tx = tx
        self.attn_fn = attn_fn
        self.donate = donate
        self.state = TrainState(params=params, opt_state=tx.init(params))
        self.timer = OpTimer()
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
