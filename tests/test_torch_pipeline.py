"""The port's 1F1B pipeline and pipelined Llama (starway_tpu_torch.parallel.
pipeline, models/pp_llama.py) against the JAX package's on the same numpy
inputs: JAX on its virtual 8-device CPU mesh (tests/conftest.py), the port
on a mesh whose slots all sit in one process (parallel/sharding.py); one
test splits the port's mesh over two gloo processes.  Case for case the
twin of tests/test_pipeline.py, parametrisations included, plus the
port's own: the schedule under a caller's ``torch.no_grad()``, the stash
of at most ``stash_depth(S)`` inputs a slot, the hops of every tick, the
attention calls of a step, and the gloo run.

Tolerances, float32: losses rtol 1e-6 and gradients atol 5e-6 (the
existing parity tests', tests/test_torch_ring.py), rtol 1e-5 beside it
for leaves whose entries reach 1 (the head); the embedding gradient is a
scatter-add, ``index_add_`` here and ``.at[].add`` in JAX, summed in
another order, under the same bound."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from conftest import free_port
from starway_tpu.models import llama as jl
from starway_tpu.models import pp_llama as jpp
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu.parallel import pipeline as jpipe
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models import pp_llama as tpp
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.parallel import make_mesh
from starway_tpu_torch.parallel import pipeline as tpipe
from starway_tpu_torch.parallel.sharding import P
from starway_tpu_torch.utils.optim import adamw
from torch_port_util import pp_runs, to_numpy, tree_to_numpy

D = 8
LOSS_RTOL = 1e-6
GRAD_TOL = dict(atol=5e-6, rtol=1e-5)
TESTS = Path(__file__).resolve().parent


def _jax_stage(w, x):
    return jnp.tanh(x @ w[0])


def _jax_loss(y, target):
    return jnp.mean((y - target) ** 2)


def _stage(w, x):
    # w: [1, D, D], the slot's stage (its leading stage dim kept).
    return torch.tanh(x @ w[0])


def _loss(y, target):
    return ((y - target) ** 2).mean()


def _arrays(seed, m, n):
    rng = np.random.default_rng(seed)
    ws = (rng.normal(size=(n, D, D)) * 0.5).astype(np.float32)
    inputs = rng.normal(size=(m, 4, D)).astype(np.float32)
    targets = rng.normal(size=(m, 4, D)).astype(np.float32)
    return ws, inputs, targets


def _t(a):
    return torch.from_numpy(np.array(a))


def _full(x):
    return x.full() if hasattr(x, "full") else x


def _close(port, want, tol=GRAD_TOL, msg=""):
    """Every leaf of a port tree (sharded or not) against the JAX tree's."""
    if isinstance(want, dict):
        for key in want:
            _close(port[key], want[key], tol, f"{msg}/{key}")
        return
    np.testing.assert_allclose(to_numpy(_full(port)), np.asarray(want),
                               err_msg=msg, **tol)


def _close_loss(port, want):
    np.testing.assert_allclose(float(port), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("m", [8, 2])  # m=2 < n: a mostly-bubble pipe
def test_1f1b_matches_jax(m):
    n = 4
    ws, inputs, targets = _arrays(0, m, n)
    jstep = jpipe.make_pipeline_train(jax_mesh({"pp": n}), _jax_stage,
                                      _jax_loss, "pp")
    jloss, jgrads = jstep(jnp.asarray(ws), jnp.asarray(inputs),
                          jnp.asarray(targets))
    step = tpipe.make_pipeline_train(make_mesh({"pp": n}, device="cpu"),
                                     _stage, _loss, "pp")
    loss, grads = step(_t(ws), _t(inputs), _t(targets))
    _close_loss(loss, jloss)
    _close(grads, jgrads)


def test_1f1b_dp_composition_matches_jax():
    """pp x dp: each dp group pipelines its slice of every microbatch; the
    averaged loss, gradients and the 1/ndp-scaled input cotangents equal
    JAX's; an unknown dp axis is refused as in JAX."""
    n, m = 2, 4
    ws, inputs, targets = _arrays(3, m, n)
    jmesh = jax_mesh({"pp": n, "dp": 2})
    mesh = make_mesh({"pp": n, "dp": 2}, device="cpu")
    jl_, jg = jpipe.make_pipeline_train(jmesh, _jax_stage, _jax_loss, "pp",
                                        dp_axis="dp")(
        jnp.asarray(ws), jnp.asarray(inputs), jnp.asarray(targets))
    loss, grads = tpipe.make_pipeline_train(mesh, _stage, _loss, "pp",
                                            dp_axis="dp")(
        _t(ws), _t(inputs), _t(targets))
    _close_loss(loss, jl_)
    _close(grads, jg)
    with pytest.raises(ValueError, match="dp_axis"):
        tpipe.make_pipeline_train(mesh, _stage, _loss, "pp", dp_axis="nope")
    with pytest.raises(ValueError, match="pipeline axis"):
        tpipe.make_pipeline_train(mesh, _stage, _loss, "pp", dp_axis="pp")

    jout = jpipe.make_pipeline_train(jmesh, _jax_stage, _jax_loss, "pp",
                                     dp_axis="dp", return_dx=True)(
        jnp.asarray(ws), jnp.asarray(inputs), jnp.asarray(targets))
    out = tpipe.make_pipeline_train(mesh, _stage, _loss, "pp", dp_axis="dp",
                                    return_dx=True)(
        _t(ws), _t(inputs), _t(targets))
    _close_loss(out[0], jout[0])
    _close(out[1], jout[1])
    assert out[2].shape == inputs.shape and out[2].dtype == torch.float32
    _close(out[2], jout[2])


def test_1f1b_trains_with_adamw():
    """The gradients feed the optimizer as they are (laid out like the
    params): five AdamW steps (weight decay 0: optax.adam) give JAX's
    losses, and the loss goes down."""
    n, m = 2, 4
    ws, inputs, targets = _arrays(1, m, n)
    jstep = jpipe.make_pipeline_train(jax_mesh({"pp": n}), _jax_stage,
                                      _jax_loss, "pp")
    step = tpipe.make_pipeline_train(make_mesh({"pp": n}, device="cpu"),
                                     _stage, _loss, "pp")
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


def _llama_pair(seed, **kw):
    jcfg = jl.LlamaConfig.preset("debug", **kw)
    jp = jl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tl.LlamaConfig.preset("debug", **kw), jp, params_from_numpy(
        tree_to_numpy(jp), device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _pp_pair(jp, tp, jmesh, mesh, n_stages, n_chunks=1):
    """The JAX and port trees in the pipeline layout, sharded."""
    if n_chunks == 1:
        return (jpp.shard_pp_params(jpp.pp_split_params(jp, n_stages), jmesh),
                tpp.shard_pp_params(tpp.pp_split_params(tp, n_stages), mesh))
    return (jpp.shard_ppv_params(jpp.ppv_split_params(jp, n_stages, n_chunks),
                                 jmesh),
            tpp.shard_ppv_params(tpp.ppv_split_params(tp, n_stages, n_chunks),
                                 mesh))


def _llama_steps(axes, jcfg, tcfg, jp, tp, batch, n_micro, n_chunks=1,
                 **kw):
    jmesh, mesh = jax_mesh(axes), make_mesh(axes, device="cpu")
    jsh, tsh = _pp_pair(jp, tp, jmesh, mesh, axes["pp"], n_chunks)
    jout = jpp.make_pp_llama_train(jmesh, jcfg, n_micro=n_micro,
                                   n_chunks=n_chunks, **kw)(
        jsh, jnp.asarray(batch))
    out = tpp.make_pp_llama_train(mesh, tcfg, n_micro=n_micro,
                                  n_chunks=n_chunks, **kw)(
        tsh, torch.as_tensor(batch).long())
    return jout, out, tsh, mesh


def test_pp_llama_grads_match_jax():
    """The pipelined Llama: loss and every gradient (embed, every stage
    layer, head) equal JAX's; one AdamW step in the pipeline layout moves
    the stage params; the layout helpers round-trip and name the specs
    JAX's do."""
    # 8 layers over 4 stages: 2 a stage runs the in-stage loop.
    kw = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
              vocab_size=128)
    jcfg, tcfg, jp, tp = _llama_pair(0, **kw)
    batch = _tokens(0, 8, 13, 128)
    (jloss, jgrads), (loss, grads), tsh, _ = _llama_steps(
        {"pp": 4}, jcfg, tcfg, jp, tp, batch, 4)
    _close_loss(loss, jloss)
    _close(grads, jgrads)

    tx = adamw(1e-3)
    updates, _ = tx.update(grads, tx.init(tsh), tsh)
    assert float(updates["stages"]["wq"].full().abs().max()) > 0

    merged = tpp.pp_merge_params(tpp.pp_split_params(tp, 2))
    for key in ("embed", "lm_head", "final_norm"):
        assert torch.equal(merged[key], tp[key])
    for key, leaf in tp["layers"].items():
        assert torch.equal(merged["layers"][key], leaf)
    specs = tpp.pp_param_specs(tpp.pp_split_params(tp, 2))
    assert tuple(specs["stages"]["wq"]) == ("pp",)
    assert tuple(specs["embed"]) == ()


def test_pp_llama_scaled_embed_grads_match():
    """Gemma-style scaled embeddings: the chained embedding cotangent
    carries the sqrt(D) factor back (a dropped factor understates d embed
    by sqrt(D))."""
    kw = dict(n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
              vocab_size=64, scaled_embed=True, mlp_act="gelu_tanh")
    jcfg, tcfg, jp, tp = _llama_pair(4, **kw)
    (jloss, jgrads), (loss, grads), _, _ = _llama_steps(
        {"pp": 2}, jcfg, tcfg, jp, tp, _tokens(4, 4, 9, 64), 2)
    _close_loss(loss, jloss)
    _close(grads["embed"], jgrads["embed"])


def test_pp_llama_interleaved_grads_match_jax():
    """The interleaved schedule (2 chunks a stage slot): loss and every
    gradient equal JAX's, and the virtual layout round-trips."""
    kw = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
              vocab_size=128)
    jcfg, tcfg, jp, tp = _llama_pair(0, **kw)
    (jloss, jgrads), (loss, grads), _, _ = _llama_steps(
        {"pp": 2}, jcfg, tcfg, jp, tp, _tokens(0, 8, 13, 128), 4,
        n_chunks=2)
    _close_loss(loss, jloss)
    _close(grads, jgrads)
    merged = tpp.ppv_merge_params(tpp.ppv_split_params(tp, 2, 2))
    for key, leaf in tp["layers"].items():
        assert torch.equal(merged["layers"][key], leaf)


@pytest.mark.parametrize("n_chunks", [1, 2], ids=["plain", "interleaved"])
def test_pp_llama_dp_composition(n_chunks):
    """pp x dp on both schedules: each microbatch's rows split over dp."""
    kw = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
              vocab_size=128)
    jcfg, tcfg, jp, tp = _llama_pair(0, **kw)
    (jloss, jgrads), (loss, grads), _, _ = _llama_steps(
        {"pp": 2, "dp": 2}, jcfg, tcfg, jp, tp, _tokens(0, 8, 13, 128), 4,
        n_chunks=n_chunks, dp_axis="dp")
    _close_loss(loss, jloss)
    _close(grads, jgrads)


@pytest.mark.parametrize("n_chunks", [1, 2], ids=["plain", "interleaved"])
def test_pp_llama_sliding_window(n_chunks):
    """A windowed config trains windowed on both schedules, and an
    attn_fn that does not declare a window is refused."""
    kw = dict(n_layers=2 * n_chunks, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=96, vocab_size=128, sliding_window=4)
    jcfg, tcfg, jp, tp = _llama_pair(0, **kw)
    (jloss, jgrads), (loss, grads), _, mesh = _llama_steps(
        {"pp": 2}, jcfg, tcfg, jp, tp, _tokens(0, 4, 13, 128), 2,
        n_chunks=n_chunks)
    _close_loss(loss, jloss)
    _close(grads, jgrads)
    with pytest.raises(ValueError, match="handles_window"):
        tpp.make_pp_llama_train(mesh, tcfg, n_micro=2, n_chunks=n_chunks,
                                attn_fn=lambda q, k, v: q)


def test_schedule_formulas():
    """The 1F1B profile: M + 2(S-1) ticks, an O(S) stash; the same numbers
    as JAX's."""
    for m, s in ((8, 4), (8, 1), (10_000, 4), (3, 7)):
        assert tpipe.pipeline_ticks(m, s) == jpipe.pipeline_ticks(m, s)
        assert tpipe.pipeline_ticks(m, s, train=False) == \
            jpipe.pipeline_ticks(m, s, train=False)
        assert tpipe.bubble_fraction(m, s) == jpipe.bubble_fraction(m, s)
        assert tpipe.stash_depth(s) == jpipe.stash_depth(s)
    assert tpipe.pipeline_ticks(8, 4) == 14
    assert tpipe.pipeline_ticks(8, 4, train=False) == 11
    assert tpipe.bubble_fraction(8, 4) == pytest.approx(6 / 14)
    assert tpipe.bubble_fraction(10_000, 4) < 1e-3
    assert tpipe.stash_depth(4) == 7 and tpipe.stash_depth(1) == 1


def test_forward_emits_from_last_stage_only():
    """make_pipeline returns the last stage's outputs: JAX's, and the
    stages chained directly."""
    n, m = 4, 6
    ws, micro, _ = _arrays(2, m, n)
    jout = jpipe.make_pipeline(jax_mesh({"pp": n}), _jax_stage, "pp")(
        jnp.asarray(ws), jnp.asarray(micro))
    out = tpipe.make_pipeline(make_mesh({"pp": n}, device="cpu"), _stage,
                              "pp")(_t(ws), _t(micro))
    assert out.shape == (m, 4, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    h = _t(micro)
    for s in range(n):
        h = _stage(_t(ws)[s:s + 1], h)
    np.testing.assert_allclose(out.numpy(), h.numpy(), atol=1e-6)


# ------------------------------------------------------ the port's own


def test_schedule_under_no_grad_gives_the_same_bits():
    """A caller's torch.no_grad() changes nothing: the B slots replay
    under their own enable_grad (the port once lost layer gradients to
    an ambient no_grad)."""
    kw = dict(n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
              vocab_size=64)
    tcfg = tl.LlamaConfig.preset("debug", **kw)
    tp = tl.init_params(tcfg, seed=5, device="cpu")
    mesh = make_mesh({"pp": 2}, device="cpu")
    batch = torch.as_tensor(_tokens(5, 4, 9, 64)).long()
    step = tpp.make_pp_llama_train(mesh, tcfg, n_micro=2)
    sh = tpp.shard_pp_params(tpp.pp_split_params(tp, 2), mesh)
    loss, grads = step(sh, batch)
    with torch.no_grad():
        loss_ng, grads_ng = step(sh, batch)
    assert torch.equal(loss, loss_ng)
    flat, flat_ng = tpp.pp_merge_params(grads), tpp.pp_merge_params(grads_ng)
    for key, leaf in flat["layers"].items():
        assert leaf.abs().max() > 0, key
        assert torch.equal(leaf, flat_ng["layers"][key]), key
    for key in ("embed", "lm_head", "final_norm"):
        assert torch.equal(flat[key], flat_ng[key]), key


@pytest.mark.parametrize("m", [4, 16])
def test_stash_holds_at_most_stash_depth(m, monkeypatch):
    """Each stage slot keeps at most 2(S-1-s) + 1 inputs alive, S = 4, at
    any M (O(S), not O(M)); every tick posts both hops; the attention runs
    twice a layer and microbatch (F slot, B-slot replay) and its
    backward once."""
    n = 4
    peaks, hops = [], []

    class Counted(tpipe.Stash):
        def __init__(self, depth):
            super().__init__(depth)
            self.peak = 0
            peaks.append(self)

        def put(self, pos, x):
            super().put(pos, x)
            self.peak = max(self.peak,
                            sum(e is not None for e in self.entries))

    real_shift = tpipe.col.ring_shift

    def counted_shift(shards, mesh, axis, shift=1):
        hops.append(shift)
        return real_shift(shards, mesh, axis, shift)

    monkeypatch.setattr(tpipe, "Stash", Counted)
    monkeypatch.setattr(tpipe.col, "ring_shift", counted_shift)
    calls = {"fwd": 0, "bwd": 0}

    class Attn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            calls["fwd"] += 1
            ctx.save_for_backward(q, k, v)
            return tl.default_attn(q, k, v)

        @staticmethod
        def backward(ctx, do):
            calls["bwd"] += 1
            with torch.enable_grad():
                q, k, v = (t.detach().requires_grad_()
                           for t in ctx.saved_tensors)
                return torch.autograd.grad(tl.default_attn(q, k, v),
                                           (q, k, v), do)

    tcfg = tl.LlamaConfig.preset("debug", n_layers=8, d_model=32, n_heads=4,
                                 n_kv_heads=2, d_ff=48, vocab_size=64)
    tp = tl.init_params(tcfg, seed=6, device="cpu")
    mesh = make_mesh({"pp": n}, device="cpu")
    step = tpp.make_pp_llama_train(mesh, tcfg, n_micro=m,
                                   attn_fn=Attn.apply)
    step(tpp.shard_pp_params(tpp.pp_split_params(tp, n), mesh),
         torch.as_tensor(_tokens(6, m, 9, 64)).long())
    assert [p.peak for p in peaks] == [min(2 * (n - 1 - s) + 1, m)
                                      for s in range(n)]
    assert max(p.peak for p in peaks) <= tpipe.stash_depth(n)
    assert all(e is None for p in peaks for e in p.entries)
    ticks = tpipe.pipeline_ticks(m, n)
    assert hops == [1, -1] * ticks
    assert calls == {"fwd": 2 * m * tcfg.n_layers, "bwd": m * tcfg.n_layers}


def test_pp_mesh_numbers_its_slots_as_jax():
    """A pipeline axis is one more axis of slots, numbered row-major as
    JAX's devices; a stage's slots form a mesh of the other axes."""
    from starway_tpu_torch.parallel.sharding import AxisSlice

    mesh = make_mesh({"pp": 2, "dp": 2, "ep": 2}, device="cpu")
    jmesh = jax_mesh({"pp": 2, "dp": 2, "ep": 2})
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for i in range(mesh.size):
        c = mesh.slot_coords(i)
        assert ids[c["pp"], c["dp"], c["ep"]] == i
    sub = AxisSlice(mesh, "pp", 1)
    assert sub.shape == {"dp": 2, "ep": 2} and sub.size == 4
    assert list(sub.local_slots) == [0, 1, 2, 3]
    assert sub.slot_coords(3) == {"dp": 1, "ep": 1}
    assert sub.slot_at({"dp": 1, "ep": 0}) == 2
    assert sub.rank_of(2) == 0
    specs = tpp.pp_param_specs({"embed": 0, "stages": {"wq": 0},
                                "head": {"lm_head": 0}})
    assert specs["stages"]["wq"] == P("pp")


def test_pipeline_across_two_processes(tmp_path):
    """Four pipeline slots over two gloo processes, two stages each (and
    a dp x pp mesh whose data axis splits over them): the 1F1B steps,
    with every hop of every tick posted across the processes, give the
    one-process run's bits."""
    world = 2
    port = free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]\n"
            "from torch_port_util import pp_worker\n"
            "pp_worker(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent), str(r),
         str(world), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ref = pp_runs(None)
    seen = set()
    for r in range(world):
        got = np.load(tmp_path / f"out{r}.npz")
        for key in got.files:
            if key.endswith(("/held", "/total", "/sharded")):
                continue  # what this process holds of a sharded leaf
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
            seen.add(key)
    assert seen == {k for k in ref
                    if not k.endswith(("/held", "/total", "/sharded"))}
