"""AdamW for parameter trees, in optax's shape and algebra.

The JAX package trains with ``optax.adamw``; the port keeps its own copy
of that transformation so that it imports nothing of JAX.  Same surface
(``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)``), same defaults (b1 0.9, b2 0.999, eps 1e-8, weight_decay 1e-4)
and the same algebra, step by step:

    mu = (1 - b1) * g + b1 * mu,    nu = (1 - b2) * g**2 + b2 * nu,
    mu_hat = mu / (1 - b1**t),      nu_hat = nu / (1 - b2**t),
    update = -lr * (mu_hat / (sqrt(nu_hat + eps_root) + eps) + wd * p).

State dtypes follow optax: mu and nu in the parameter's dtype unless
``mu_dtype`` is given (mu only), the bias corrections computed in float32
and cast to the moment's dtype, and an int32 step count that saturates.
Scalar constants are rounded to the leaf's dtype before they multiply it,
as JAX's weakly typed Python scalars are, so a bfloat16 tree rounds where
optax's does.  The state is an ``AdamWState(count, mu, nu)`` whose leaves
flatten in the order of optax's ``ScaleByAdamState``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32 scalar: steps taken
    mu: Any
    nu: Any


class GradientTransformation(NamedTuple):
    init: Any
    update: Any


def _const(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (a JAX weak-typed scalar's value)."""
    return float(torch.tensor(x, dtype=dtype))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          mu_dtype: Optional[torch.dtype] = None,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw with a constant learning rate, on trees of tensors."""

    def init(params) -> AdamWState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=mu_dtype),
                        params),
            nu=tree_map(torch.zeros_like, params))

    def update(grads, state: AdamWState, params):
        if params is None:
            raise ValueError("adamw's weight decay needs the params")
        count = torch.where(
            state.count < torch.iinfo(torch.int32).max, state.count + 1,
            state.count)
        t = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)

        def moments(g, m, v):
            m = _const(1 - b1, g.dtype) * g + _const(b1, m.dtype) * m
            v = _const(1 - b2, g.dtype) * (g * g) + _const(b2, v.dtype) * v
            return m, v

        new = tree_map(moments, grads, state.mu, state.nu)
        mu = tree_map(lambda g, pair: pair[0], grads, new)
        nu = tree_map(lambda g, pair: pair[1], grads, new)

        def step(m, v, p):
            m_hat = m / bc1.to(m.dtype)
            v_hat = v / bc2.to(v.dtype)
            u = m_hat / (torch.sqrt(v_hat + _const(eps_root, v_hat.dtype))
                         + _const(eps, v_hat.dtype))
            u = u + _const(weight_decay, p.dtype) * p
            return _const(-learning_rate, u.dtype) * u

        updates = tree_map(step, mu, nu, params)
        if mu_dtype is not None:
            mu = tree_map(lambda m: m.to(mu_dtype), mu)
        return updates, AdamWState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init, update)
