"""The port's interleaved 1F1B (starway_tpu_torch.parallel.interleaved)
against the JAX package's on the same numpy inputs, case for case the twin
of tests/test_interleaved.py: the host-built slot tables array-equal to
JAX's for every (M, S, V) its tests sweep, their validity, the bubble's
shrink, and the schedule's loss, gradients and input cotangents against
JAX's (JAX on its virtual 8-device CPU mesh, the port's slots in one
process).  Tolerances, float32: losses rtol 1e-6, gradients and
cotangents atol 5e-6 with rtol 1e-5 (tests/test_torch_pipeline.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from starway_tpu.parallel import interleaved as jint
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu.parallel.pipeline import pipeline_ticks
from starway_tpu_torch.parallel import interleaved as tint
from starway_tpu_torch.parallel import make_mesh
from starway_tpu_torch.utils.optim import adamw

D = 8
LOSS_RTOL = 1e-6
GRAD_TOL = dict(atol=5e-6, rtol=1e-5)


def _jax_stage(w, x):
    return jnp.tanh(x @ w)


def _jax_loss(y, target):
    return jnp.mean((y - target) ** 2)


def _stage(w, x):
    # w: [D, D], one virtual stage's params.
    return torch.tanh(x @ w)


def _loss(y, target):
    return ((y - target) ** 2).mean()


def _same_tables(m, s, v):
    """The port's schedule for (m, s, v), every field equal to JAX's."""
    got = tint.build_interleaved_schedule(m, s, v)
    want = jint.build_interleaved_schedule(m, s, v)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, (m, s, v, field.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{(m, s, v)} "
                                                        f"{field.name}")
        else:
            assert a == b, (m, s, v, field.name)
    return got


def _arrays(seed, m, s, v):
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(v, s, D, D)) * 0.5).astype(np.float32)
    inputs = rng.normal(size=(m, 4, D)).astype(np.float32)
    targets = rng.normal(size=(m, 4, D)).astype(np.float32)
    return ws, inputs, targets


def _t(a):
    return torch.from_numpy(np.array(a))


def test_schedule_builds_at_high_chunk_counts():
    """The backward-injection loop runs ~V*M ticks, so its horizon scales
    with V*M: these build, as JAX's, with the same tables."""
    for m, s, v in [(800, 2, 5), (1000, 2, 8), (64, 8, 6)]:
        sched = _same_tables(m, s, v)
        assert sched.ticks >= v * m


def test_schedule_valid_random_sweep():
    """The JAX tests' random (M, S, V) sweep: every tuple builds the
    tables JAX builds and covers each (chunk, microbatch) once a stage
    slot a direction."""
    rng = np.random.default_rng(0)
    for _ in range(40):
        m = int(rng.integers(1, 17))
        s = int(rng.integers(1, 9))
        v = int(rng.integers(1, 5))
        sched = _same_tables(m, s, v)
        want = {(c, i) for c in range(v) for i in range(m)}
        for d in range(s):
            f = {(int(sched.f_chunk[t, d]), int(sched.f_micro[t, d]))
                 for t in range(sched.ticks) if sched.f_chunk[t, d] >= 0}
            b = {(int(sched.b_chunk[t, d]), int(sched.b_micro[t, d]))
                 for t in range(sched.ticks) if sched.b_chunk[t, d] >= 0}
            assert f == want and b == want, (m, s, v, d)


@pytest.mark.parametrize("m,s,v", [(4, 2, 2), (8, 4, 2), (2, 2, 3),
                                   (5, 2, 2), (3, 4, 2)])
def test_schedule_is_valid(m, s, v):
    """JAX's tables; one F and one B slot for every (chunk, microbatch)
    on every stage slot, each B after its F, one slot a tick within a
    chunk, forward ascending and backward descending."""
    sched = _same_tables(m, s, v)
    for d in range(s):
        f_tick, b_tick = {}, {}
        for t in range(sched.ticks):
            if sched.f_chunk[t, d] >= 0:
                key = (int(sched.f_chunk[t, d]), int(sched.f_micro[t, d]))
                assert key not in f_tick
                f_tick[key] = t
            if sched.b_chunk[t, d] >= 0:
                key = (int(sched.b_chunk[t, d]), int(sched.b_micro[t, d]))
                assert key not in b_tick
                b_tick[key] = t
        assert set(f_tick) == {(c, i) for c in range(v) for i in range(m)}
        assert set(b_tick) == set(f_tick)
        for key, tf in f_tick.items():
            assert b_tick[key] >= tf, "backward before forward"
    for c in range(v):
        for i in range(m):
            ticks_f = [next(t for t in range(sched.ticks)
                            if sched.f_chunk[t, d] == c
                            and sched.f_micro[t, d] == i) for d in range(s)]
            assert ticks_f == list(range(ticks_f[0], ticks_f[0] + s))
            ticks_b = [next(t for t in range(sched.ticks)
                            if sched.b_chunk[t, d] == c
                            and sched.b_micro[t, d] == i) for d in range(s)]
            assert ticks_b == list(range(ticks_b[0], ticks_b[0] - s, -1))


@pytest.mark.parametrize("m,s,v", [(4, 2, 2), (8, 4, 2), (2, 2, 3),
                                   (5, 2, 2)])
def test_interleaved_matches_jax(m, s, v):
    """Loss and gradients equal JAX's, M < S and odd M included."""
    ws, inputs, targets = _arrays(0, m, s, v)
    jloss, jgrads = jint.make_interleaved_pipeline_train(
        jax_mesh({"pp": s}), _jax_stage, _jax_loss, "pp", n_chunks=v,
        n_micro=m)(jnp.asarray(ws), jnp.asarray(inputs),
                   jnp.asarray(targets))
    loss, grads = tint.make_interleaved_pipeline_train(
        make_mesh({"pp": s}, device="cpu"), _stage, _loss, "pp",
        n_chunks=v, n_micro=m)(_t(ws), _t(inputs), _t(targets))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert grads.shape == ws.shape and grads.dtype == torch.float32
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), **GRAD_TOL)


def test_interleaved_shrinks_the_bubble():
    """JAX's tick counts, under its bound: the win over plain 1F1B is
    (V-1)(S-2) chunk passes for M >= S, and never worse than the V-1
    wraps' slack below."""
    for m, s, v in [(4, 4, 2), (8, 4, 2), (16, 4, 2), (8, 8, 4)]:
        sched = _same_tables(m, s, v)
        assert sched.ticks <= v * pipeline_ticks(m, s) - (v - 1) * (s - 2)
    for m, s, v in [(2, 4, 2), (1, 2, 2), (2, 2, 3), (4, 8, 2), (2, 4, 4)]:
        sched = _same_tables(m, s, v)
        assert sched.ticks <= v * pipeline_ticks(m, s) + (v - 1)


def test_interleaved_dp_composition_matches_jax():
    """pp x dp: the batch dim of each microbatch splits over dp; loss,
    gradients and the 1/ndp-scaled input cotangents equal JAX's; an
    unknown dp axis is refused."""
    m, s, v = 4, 2, 2
    ws, inputs, targets = _arrays(7, m, s, v)
    jloss, jgrads, jdx = jint.make_interleaved_pipeline_train(
        jax_mesh({"pp": s, "dp": 2}), _jax_stage, _jax_loss, "pp",
        n_chunks=v, n_micro=m, return_dx=True, dp_axis="dp")(
        jnp.asarray(ws), jnp.asarray(inputs), jnp.asarray(targets))
    mesh = make_mesh({"pp": s, "dp": 2}, device="cpu")
    loss, grads, dx = tint.make_interleaved_pipeline_train(
        mesh, _stage, _loss, "pp", n_chunks=v, n_micro=m, return_dx=True,
        dp_axis="dp")(_t(ws), _t(inputs), _t(targets))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jgrads), **GRAD_TOL)
    assert dx.shape == inputs.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **GRAD_TOL)
    with pytest.raises(ValueError, match="dp_axis"):
        tint.make_interleaved_pipeline_train(
            mesh, _stage, _loss, "pp", n_chunks=v, n_micro=m,
            dp_axis="nope")


def test_interleaved_trains_with_adamw():
    """Five steps (AdamW with weight decay 0 beside optax.adam): JAX's
    losses, going down."""
    m, s, v = 4, 2, 2
    ws, inputs, targets = _arrays(1, m, s, v)
    jstep = jint.make_interleaved_pipeline_train(
        jax_mesh({"pp": s}), _jax_stage, _jax_loss, "pp", n_chunks=v,
        n_micro=m)
    step = tint.make_interleaved_pipeline_train(
        make_mesh({"pp": s}, device="cpu"), _stage, _loss, "pp",
        n_chunks=v, n_micro=m)
    jtx, tx = optax.adam(1e-2), adamw(1e-2, weight_decay=0.0)
    jw, tw = jnp.asarray(ws), _t(ws)
    jopt, opt = jtx.init(jw), tx.init(tw)
    jlosses, losses = [], []
    for _ in range(5):
        jloss, jgrads = jstep(jw, jnp.asarray(inputs), jnp.asarray(targets))
        updates, jopt = jtx.update(jgrads, jopt, jw)
        jw = optax.apply_updates(jw, updates)
        loss, grads = step(tw, _t(inputs), _t(targets))
        updates, opt = tx.update(grads, opt, tw)
        tw = tw + updates
        jlosses.append(float(jloss))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
