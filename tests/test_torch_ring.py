"""The port's sequence-parallel ring attention (starway_tpu_torch.parallel,
ops/flash.py's ring-step partials, models.llama.make_sharded_attn) against
the JAX package's on the same numpy inputs: JAX on its virtual 8-device
CPU mesh (tests/conftest.py), the port on a mesh whose shards all sit in
one process, as the module docstring of parallel/sharding.py sets out;
one test splits the port's mesh over two gloo processes.

The JAX ring steps run its plain path unless a test asks for its Pallas
kernels (``use_kernel=True``, interpret mode); the port's wrappers take
their plain versions on the CPU (the CUDA kernels are held against those
on the card, tests/test_torch_cuda.py).  Tolerances are the JAX tests':
outputs and partials 2e-5, gradients atol 5e-5 with rtol 5e-4 (float32
sums over up to 8 ring steps in another order); value_and_grad of the
model: loss rtol 1e-6 and gradients 5e-6 (tests/test_torch_train.py's
2e-6 for one attention, with the ring's merges in another order)."""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import free_port
from starway_tpu.models import llama as jl
from starway_tpu.ops.attention import NEG_BIG
from starway_tpu.ops.attention import partial_attention as jax_partial
from starway_tpu.ops.attention import repeat_kv as jax_repeat_kv
from starway_tpu.ops.pallas_attention import (flash_partial as jax_fp,
                                              flash_partial_bwd as jax_fpb)
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu.parallel import make_ring_attention as jax_ring
from starway_tpu.parallel import make_zigzag_ring_attention as jax_zigzag
from starway_tpu.parallel import zigzag_indices as jax_zigzag_indices
from starway_tpu_torch.models import llama as tl
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.ops import flash as tflash
from starway_tpu_torch.parallel import (make_mesh, make_ring_attention,
                                        make_zigzag_ring_attention,
                                        ring_attention, zigzag_indices)
from starway_tpu_torch.utils.tree import tree_leaves
from torch_port_util import to_numpy, to_torch, tree_to_numpy

ATOL = 2e-5
GRAD_TOL = dict(atol=5e-5, rtol=5e-4)
TESTS = Path(__file__).resolve().parent
tring = importlib.import_module("starway_tpu_torch.parallel.ring_attention")


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in shapes]


def _qkv(seed, t, hq=4, hkv=4, d=32, b=2):
    return _arrays(seed, (b, hq, t, d), (b, hkv, t, d), (b, hkv, t, d),
                   (b, hq, t, d))


def _jax_run(fn, q, k, v, vd):
    """Output and the gradients of sum(out * vd), from one compile."""
    def both(q, k, v, vd):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(vd)

    out, grads = jax.jit(both)(*(jnp.asarray(x) for x in (q, k, v, vd)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_run(fn, q, k, v, vd):
    leaves = [to_torch(x).requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    (out * to_torch(vd)).sum().backward()
    return to_numpy(out), [to_numpy(x.grad) for x in leaves]


def _assert_same(got, want, **tol):
    out, grads = got
    np.testing.assert_allclose(out, want[0], atol=ATOL, rtol=ATOL)
    for g, w in zip(grads, want[1]):
        np.testing.assert_allclose(g, w, **(tol or GRAD_TOL))


# ------------------------------------------------------------ ring steps

STEP_CASES = [  # (q_offset, kv_offset, T, causal)
    (32, 0, 32, True),    # a whole past block
    (32, 32, 32, True),   # the diagonal
    (0, 32, 32, True),    # a dead block: every row sees nothing
    (0, 8, 16, True),     # rows 0..7 see nothing, rows 8.. part
    (16, 48, 32, False),  # a zigzag hi-lo style pair, no mask
]


@pytest.mark.parametrize("q_off,kv_off,t,causal", STEP_CASES)
def test_flash_partial_matches_jax_kernel(q_off, kv_off, t, causal):
    """flash_partial against the JAX Pallas _partial_kernel (interpret
    mode, 16-row blocks), GQA 2; rows that see no key are the identity."""
    q, k, v = _arrays(1, (2, 4, t, 16), (2, 2, t, 16), (2, 2, t, 16))
    want = jax_fp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off,
                  kv_off, causal=causal, block_q=16, block_k=16,
                  interpret=True)
    got = tflash.flash_partial(to_torch(q), to_torch(k), to_torch(v), q_off,
                               kv_off, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=ATOL,
                                   rtol=ATOL)
    o, m, l = (to_numpy(x) for x in got)
    dead = (q_off + np.arange(t) < kv_off) if causal else np.zeros(t, bool)
    assert (o[:, :, dead] == 0).all() and (l[:, :, dead] == 0).all()
    assert (m[:, :, dead] == np.float32(NEG_BIG)).all()
    assert (l[:, :, ~dead] > 0).all()


@pytest.mark.parametrize("q_off,kv_off,window", [(32, 0, 20), (32, 32, 7),
                                                 (64, 0, 40)])
def test_flash_partial_window_matches_jax_plain_step(q_off, kv_off, window):
    """A windowed ring step: the JAX kernel carries no band and JAX runs
    these steps through partial_attention, the function the port's
    windowed flash_partial computes."""
    q, k, v = _arrays(2, (2, 4, 32, 16), (2, 2, 32, 16), (2, 2, 32, 16))
    want = jax_partial(jnp.asarray(q), jax_repeat_kv(jnp.asarray(k), 2),
                       jax_repeat_kv(jnp.asarray(v), 2), q_offset=q_off,
                       kv_offset=kv_off, causal=True, window=window)
    got = tflash.flash_partial(to_torch(q), to_torch(k), to_torch(v), q_off,
                               kv_off, causal=True, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("q_off,kv_off,t,causal",
                         [c for c in STEP_CASES if c[2] == 32])
def test_flash_partial_bwd_matches_jax_kernel(q_off, kv_off, t, causal):
    """flash_partial_bwd against the JAX Pallas backward passes at ring
    offsets (interpret mode): float32 dq, grouped float32 dk/dv."""
    q, k, v, do = _arrays(3, (2, 4, t, 16), (2, 2, t, 16), (2, 2, t, 16),
                          (2, 4, t, 16))
    rng = np.random.default_rng(4)
    lse = rng.uniform(1.0, 3.0, (2, 4, t)).astype(np.float32)
    delta = rng.standard_normal((2, 4, t), np.float32)
    want = jax_fpb(*(jnp.asarray(x) for x in (q, do, k, v, lse, delta)),
                   q_off, kv_off, causal=causal, interpret=True)
    got = tflash.flash_partial_bwd(*(to_torch(x) for x in (q, do, k, v, lse,
                                                           delta)),
                                   q_off, kv_off, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), **GRAD_TOL)


# ------------------------------------------------------------ the rings


@pytest.mark.parametrize("causal,gqa", [(False, 1), (True, 2)])
def test_ring_attention_matches_jax(causal, gqa):
    """Ring attention on sp = 8, forward and gradients (the JAX tests at
    tests/test_parallel.py:50-75 and 181-201)."""
    q, k, v, vd = _qkv(5, 128, hkv=4 // gqa)
    want = _jax_run(jax_ring(jax_mesh({"sp": 8}), "sp", causal=causal),
                    q, k, v, vd)
    got = _port_run(make_ring_attention(make_mesh({"sp": 8}, device="cpu"),
                                        "sp", causal=causal), q, k, v, vd)
    _assert_same(got, want)


@pytest.mark.parametrize("gqa", [1, 2])
def test_zigzag_ring_attention_matches_jax(gqa):
    """Zigzag ring attention on sp = 8, grouped kv, forward and gradients
    (tests/test_parallel.py:91-105 and 204-227)."""
    q, k, v, vd = _qkv(6, 128, hkv=4 // gqa)
    want = _jax_run(jax_zigzag(jax_mesh({"sp": 8}), "sp"), q, k, v, vd)
    got = _port_run(make_zigzag_ring_attention(
        make_mesh({"sp": 8}, device="cpu"), "sp"), q, k, v, vd)
    _assert_same(got, want)


@pytest.mark.parametrize("window", [24, 64])
def test_windowed_ring_attention_matches_jax(window):
    """The windowed ring on sp = 8 (tests/test_parallel.py:294-328):
    out-of-band steps skipped, band-edge steps masked in the step."""
    q, k, v, vd = _qkv(7, 256)
    want = _jax_run(jax_ring(jax_mesh({"sp": 8}), "sp", causal=True,
                             window=window), q, k, v, vd)
    got = _port_run(make_ring_attention(make_mesh({"sp": 8}, device="cpu"),
                                        "sp", window=window), q, k, v, vd)
    _assert_same(got, want)


def test_ring_matches_jax_pallas_ring_steps():
    """Against the JAX ring whose steps run its Pallas kernels (interpret
    mode), sp = 2, GQA 2 (tests/test_parallel.py:230-249); the zigzag
    layout's unmasked pair is held against the Pallas partial in
    test_flash_partial_matches_jax_kernel."""
    q, k, v, vd = _qkv(8, 32, hq=2, hkv=1, d=16, b=1)
    jfn = jax_ring(jax_mesh({"sp": 2}), "sp", causal=True, use_kernel=True)
    tfn = make_ring_attention(make_mesh({"sp": 2}, device="cpu"), "sp")
    _assert_same(_port_run(tfn, q, k, v, vd), _jax_run(jfn, q, k, v, vd))


@pytest.mark.parametrize("s,n", [(256, 8), (64, 4), (24, 2)])
def test_zigzag_indices_match_jax(s, n):
    np.testing.assert_array_equal(zigzag_indices(s, n),
                                  jax_zigzag_indices(s, n))
    with pytest.raises(ValueError):
        zigzag_indices(s + 2, n)


def _counted(monkeypatch):
    """Count the ring's calls of the two step functions (the launches on
    CUDA tensors)."""
    calls = {"fwd": 0, "bwd": 0}

    def wrap(fn, key):
        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return counted

    monkeypatch.setattr(tring, "flash_partial",
                        wrap(tflash.flash_partial, "fwd"))
    monkeypatch.setattr(tring, "flash_partial_bwd",
                        wrap(tflash.flash_partial_bwd, "bwd"))
    return calls


@pytest.mark.parametrize("layout,n,window,want", [
    ("ring", 4, None, 16), ("zigzag", 4, None, 36), ("ring", 8, None, 64),
    ("zigzag", 2, None, 10), ("ring", 8, 24, 8 + 7 + 6)])
def test_ring_step_structure(monkeypatch, layout, n, window, want):
    """Every plain ring step runs, a dead causal one included: n^2 steps
    forward and backward; zigzag 2 n^2 + n; a band of 24 over shards of 16
    runs the diagonal and the live steps of two more rotations."""
    calls = _counted(monkeypatch)
    q, k, v, vd = _qkv(9, 16 * n, hq=2, hkv=1, d=16, b=1)
    mesh = make_mesh({"sp": n}, device="cpu")
    fn = (make_ring_attention(mesh, window=window) if layout == "ring"
          else make_zigzag_ring_attention(mesh))
    _port_run(fn, q, k, v, vd)
    assert calls == {"fwd": want, "bwd": want}


# ------------------------------------------------------------ the model


def _debug_pair(**kw):
    """The debug preset cut to one layer (the JAX compile is most of these
    tests' time)."""
    jcfg = jl.LlamaConfig.preset("debug", n_layers=1, **kw)
    tcfg = tl.LlamaConfig.preset("debug", n_layers=1, **kw)
    npp = tree_to_numpy(jl.init_params(jax.random.PRNGKey(3), jcfg))
    batch = np.random.default_rng(10).integers(0, 512, (2, 33), np.int32)
    return jcfg, tcfg, npp, batch


def _assert_tree_close(jgrads, tgrads, atol):
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tree_leaves(tgrads))
    for a, b in zip(jleaves, tree_leaves(tgrads)):
        np.testing.assert_allclose(to_numpy(b), np.asarray(a), atol=atol)


@pytest.mark.parametrize("layout", ["ring", "zigzag"])
def test_sharded_attn_value_and_grad_matches_jax(layout):
    """value_and_grad of the debug Llama with make_sharded_attn on sp = 4
    against jax.value_and_grad with the JAX make_sharded_attn on a
    {"dp": 1, "tp": 1, "sp": 4} mesh: the loss and every gradient leaf."""
    jcfg, tcfg, npp, batch = _debug_pair()
    jattn = jl.make_sharded_attn(jax_mesh({"dp": 1, "tp": 1, "sp": 4}),
                                 layout=layout)
    jv, jg = jax.jit(lambda p, b: jax.value_and_grad(jl.loss_fn)(
        p, b, jcfg, jattn))(jax.tree_util.tree_map(jnp.asarray, npp),
                            jnp.asarray(batch))
    tattn = tl.make_sharded_attn(make_mesh({"sp": 4}, device="cpu"),
                                 layout=layout)
    tv, tg = tl.value_and_grad(params_from_numpy(npp, device="cpu"),
                               torch.as_tensor(batch).long(), tcfg, tattn)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    _assert_tree_close(jg, tg, 5e-6)


def test_windowed_sharded_attn_matches_one_device():
    """On a sliding-window config the windowed make_sharded_attn slots in
    (resolve_attn_fn admits it through handles_window) and its
    value_and_grad equals the one-device windowed attention's, as the JAX
    package's tests/test_parallel.py:331-356 holds its forward."""
    _, tcfg, npp, batch = _debug_pair(sliding_window=6)
    attn = tl.make_sharded_attn(make_mesh({"sp": 4}, device="cpu"),
                                window=6)
    assert attn.handles_window and attn.window == 6
    params = params_from_numpy(npp, device="cpu")
    tokens = torch.as_tensor(batch).long()
    tv, tg = tl.value_and_grad(params, tokens, tcfg, attn)
    wv, wg = tl.value_and_grad(params, tokens, tcfg)
    np.testing.assert_allclose(float(tv), float(wv), rtol=1e-6)
    for a, b in zip(tree_leaves(wg), tree_leaves(tg)):
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), atol=5e-6)


def test_mesh_and_sharded_attn_refusals():
    """A pipeline axis is one more axis of slots, numbered row-major as
    JAX's devices; a band on zigzag and an undeclared or mismatched window
    are refused as in JAX."""
    pp = make_mesh({"pp": 2, "sp": 2}, device="cpu")
    ids = np.vectorize(lambda d: d.id)(jax_mesh({"pp": 2, "sp": 2}).devices)
    assert pp.size == 4 and list(pp.local_slots) == [0, 1, 2, 3]
    for i in range(pp.size):
        c = pp.slot_coords(i)
        assert ids[c["pp"], c["sp"]] == i
    # dp and tp above 1 make a grid of slots, row-major as JAX's devices.
    grid = make_mesh({"dp": 2, "tp": 2, "sp": 2}, device="cpu")
    assert grid.size == 8 and list(grid.local_slots) == list(range(8))
    assert grid.slot_coords(5) == {"dp": 1, "tp": 0, "sp": 1}
    assert grid.slot_at({"dp": 1, "tp": 0, "sp": 1}) == 5
    with pytest.raises(ValueError):
        make_mesh({"sp": 0}, device="cpu")
    mesh = make_mesh({"dp": 1, "tp": 1, "sp": 4}, device="cpu")
    assert mesh.device == torch.device("cpu") and mesh.world == 1
    assert list(mesh.local_range("sp")) == [0, 1, 2, 3]
    assert make_mesh({"sp": 2}).device.type == "cuda"
    with pytest.raises(ValueError, match="ring"):
        tl.make_sharded_attn(mesh, layout="zigzag", window=4)
    with pytest.raises(ValueError, match="layout"):
        tl.make_sharded_attn(mesh, layout="ulysses")
    cfg = tl.LlamaConfig.preset("debug", sliding_window=6)
    with pytest.raises(ValueError, match="handles_window"):
        tl.resolve_attn_fn(cfg, tl.make_sharded_attn(mesh))
    with pytest.raises(ValueError, match="window=4"):
        tl.resolve_attn_fn(cfg, tl.make_sharded_attn(mesh, window=4))
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="mesh"):
        ring_attention(q, q, q, make_mesh({"sp": 2}), "sp")
    with pytest.raises(ValueError, match="split"):
        ring_attention(q[:, :, :6], q[:, :, :6], q[:, :, :6],
                       make_mesh({"sp": 4}, device="cpu"), "sp")


def test_ring_across_two_processes(tmp_path):
    """sp = 4 over two gloo processes, two shards each: the edge shards go
    by torch.distributed point-to-point.  Each process's output and
    gradients equal the one-process run's slice, for ring and zigzag."""
    n, world = 4, 2
    q, k, v, vd = _qkv(11, 64, hkv=2, d=16)
    perm = zigzag_indices(64, n)
    np.savez(tmp_path / "in.npz", n=n, q=q, k=k, v=v, vd=vd,
             **{"z" + name: x[:, :, perm]
                for name, x in zip(("q", "k", "v", "vd"), (q, k, v, vd))})
    port = free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]\n"
            "from torch_port_util import ring_worker\n"
            "ring_worker(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent), str(r),
         str(world), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    mesh = make_mesh({"sp": n}, device="cpu")
    want = {
        "ring": _port_run(make_ring_attention(mesh), q, k, v, vd),
        "zigzag": _port_run(
            lambda *a: tring.zigzag_ring_attention(*a, mesh),
            q[:, :, perm], k[:, :, perm], v[:, :, perm], vd[:, :, perm])}
    s = 64 // world
    for r in range(world):
        got = np.load(tmp_path / f"out{r}.npz")
        for name, (out, grads) in want.items():
            cut = (slice(None), slice(None), slice(r * s, (r + 1) * s))
            np.testing.assert_allclose(got[name], out[cut], atol=1e-6)
            for x, g in zip("qkv", grads):
                np.testing.assert_allclose(got[f"{name}_d{x}"], g[cut],
                                           atol=1e-6)
