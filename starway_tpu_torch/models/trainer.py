"""Minimal training harness for the model family: the train step, host-side
telemetry (utils.trace.OpTimer), checkpointing (utils.checkpoint) and --
when a DP-boundary port is supplied -- averaged gradient exchange with a
peer rank over the transport (parallel/dp_exchange.py).

The port of the JAX package's ``models/trainer.py``: mixture-of-experts
models train with a ``moe_fn`` and their router health
(``with_moe_stats``), and ``mesh``/``fsdp_axis`` is ZeRO mode
(parallel/fsdp.py): parameters and optimizer state sharded over that axis.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch

from ..utils.trace import OpTimer, trace_span
from ..utils.tree import tree_leaves, tree_map
from .llama import LlamaConfig, apply_updates, make_train_step, value_and_grad


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


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
        ``accum_steps > 1`` and ZeRO mode.

        ``moe_fn``: the MoE dispatch of an expert model (for example
        :func:`~starway_tpu_torch.models.moe.make_sharded_moe`'s).
        ``with_moe_stats`` (a ``with_stats=True`` moe_fn): every step
        keeps the layer-stacked router health on ``last_moe_stats``.

        ``mesh`` + ``fsdp_axis``: ZeRO mode -- parameters and optimizer
        state sharded over that axis (parallel/fsdp.py ``fsdp_specs``),
        the batch cut over it, each weight gathered before its use and
        each gradient reduce-scattered (models/sharded.py)."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if accum_steps > 1 and dp_port is not None:
            raise ValueError(
                "accum_steps composes with the local/fsdp step only; the "
                "dp_port exchange path averages full-batch grads")
        if dp_port is not None and (mesh is not None
                                    or fsdp_axis is not None):
            raise ValueError("fsdp mode and dp_port are mutually exclusive")
        if with_moe_stats and mesh is not None:
            raise NotImplementedError(
                "with_moe_stats is not wired through the fused fsdp step; "
                "use the plain step or make_train_step(with_moe_stats=True)")
        if with_moe_stats and (moe_fn is None or cfg.n_experts == 0):
            raise ValueError(
                "with_moe_stats needs an expert config and a stats-producing"
                " moe_fn (make_sharded_moe(..., with_stats=True))")
        if (mesh is None) != (fsdp_axis is None):
            raise ValueError("pass mesh and fsdp_axis together")
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
        self.moe_fn = moe_fn
        self.with_moe_stats = with_moe_stats
        self.last_moe_stats = None
        self.donate = donate
        self._fsdp_step = None
        if mesh is not None:
            from ..parallel.fsdp import (fsdp_specs, make_fsdp_train_step,
                                         shard_tree)

            pspecs = fsdp_specs(params, mesh, axis=fsdp_axis)
            params = shard_tree(params, mesh, pspecs)
            self._fsdp_step = make_fsdp_train_step(
                make_train_step(cfg, tx, attn_fn, moe_fn,
                                accum_steps=accum_steps, in_place=True),
                mesh, pspecs, None, axis=fsdp_axis)
        self.state = TrainState(params=params, opt_state=tx.init(params))
        self.timer = OpTimer()
        self.dp_port = dp_port
        self.dp_base_tag = dp_base_tag
        self._accum_step = None
        if accum_steps > 1 and self._fsdp_step is None:
            self._accum_step = make_train_step(
                cfg, tx, attn_fn, moe_fn, accum_steps=accum_steps,
                with_moe_stats=with_moe_stats, in_place=donate)

    def step_sync(self, batch) -> float:
        """One local step; returns the loss."""
        st = self.state
        if self._accum_step is not None:
            with self._span("accum_step"):
                out = self._accum_step(st.params, st.opt_state, batch)
                st.params, st.opt_state, loss = out[:3]
                if self.with_moe_stats:
                    self.last_moe_stats = out[3]
            st.step += 1
            return float(loss)
        if self._fsdp_step is not None:
            with self._span("fsdp_step"):
                st.params, st.opt_state, loss = self._fsdp_step(
                    st.params, st.opt_state, batch)
            st.step += 1
            return float(loss)
        with self._span("grad"):
            loss, grads = self._grad(st.params, batch)
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
            loss, grads = self._grad(st.params, batch)
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

    def _grad(self, params, batch):
        """``(loss, grads)``; the router health is kept on
        ``last_moe_stats``."""
        val, grads = value_and_grad(params, batch, self.cfg, self.attn_fn,
                                    self.moe_fn,
                                    with_moe_stats=self.with_moe_stats)
        if self.with_moe_stats:
            val, self.last_moe_stats = val
        return val, grads

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
        """The npz checkpoint of the state (utils/checkpoint.py); in ZeRO
        mode the boxes this process holds, so each process of a group
        saves to a path of its own and restores from it."""
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
