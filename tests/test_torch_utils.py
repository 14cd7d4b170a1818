"""The port's training utilities against the JAX package's and optax on
the same numpy inputs: ``utils.optim.adamw`` against ``optax.adamw``,
``utils.checkpoint`` round trips in the port and across the two packages
(npz layout, JAX flatten order), ``utils.data`` batches, and the
``utils.trace`` helpers on ``torch.profiler``.

Tolerances: float32 AdamW updates and state rtol 1e-6 / atol 1e-9 (the
same algebra; the bias corrections' powers may differ by a float32 ulp);
bfloat16 trees 1 bfloat16 ulp relative (1e-2: XLA and PyTorch may keep a
product in float32 one step longer)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from starway_tpu.utils import checkpoint as jax_checkpoint
from starway_tpu.utils.data import TokenBatcher as JaxBatcher
from starway_tpu_torch.utils import (OpTimer, TokenBatcher, adamw,
                                     load_tokens, profile_to, trace_span)
from starway_tpu_torch.utils.checkpoint import restore_pytree, save_pytree
from starway_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                          tree_unflatten)
from torch_port_util import to_numpy, to_torch


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(dtype),
            "layers": {"b": rng.standard_normal((3,)).astype(dtype),
                       "a": rng.standard_normal((2, 4)).astype(dtype)}}


def _jax_tree(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch_tree(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


@pytest.mark.parametrize("kw", [dict(), dict(weight_decay=0.1, eps=1e-6),
                                dict(b1=0.8, b2=0.95, eps_root=1e-9)])
def test_adamw_matches_optax(kw):
    """Five updates of a float32 tree with fresh gradients each step."""
    params = _tree(0)
    jtx, ttx = optax.adamw(3e-3, **kw), adamw(3e-3, **kw)
    jp, tp = _jax_tree(params), _torch_tree(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    assert ts.count.dtype == torch.int32 and int(ts.count) == 0
    for step in range(5):
        g = _tree(10 + step)
        ju, js = jtx.update(_jax_tree(g), js, jp)
        tu, ts = ttx.update(_torch_tree(g), ts, tp)
        for a, b in zip(jax.tree_util.tree_leaves((ju, js)),
                        tree_leaves((tu, ts))):
            np.testing.assert_allclose(to_numpy(b), np.asarray(a),
                                       rtol=1e-6, atol=1e-9)
        jp = optax.apply_updates(jp, ju)
        tp = tree_map(lambda p, u: p + u, tp, tu)
    assert int(ts.count) == 5


@pytest.mark.parametrize("mu_dtype", [None, "float32"])
def test_adamw_bf16_state_dtypes_match_optax(mu_dtype):
    """bfloat16 params: mu and nu stay bfloat16 unless mu_dtype is given
    (then mu only), as optax keeps them; updates agree to a bfloat16 ulp."""
    params = _tree(1)
    jtx = optax.adamw(1e-2, mu_dtype=mu_dtype and jnp.float32)
    ttx = adamw(1e-2, mu_dtype=mu_dtype and torch.float32)
    jp, tp = _jax_tree(params, jnp.bfloat16), _torch_tree(params,
                                                          torch.bfloat16)
    js, ts = jtx.init(jp), ttx.init(tp)
    for step in range(3):
        g = _tree(20 + step)
        ju, js = jtx.update(_jax_tree(g, jnp.bfloat16), js, jp)
        tu, ts = ttx.update(_torch_tree(g, torch.bfloat16), ts, tp)
    for a, b in zip(jax.tree_util.tree_leaves((ju, js)),
                    tree_leaves((tu, ts))):
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype)
        a = np.asarray(a, np.float32)
        np.testing.assert_allclose(to_numpy(b), a, rtol=1e-2,
                                   atol=1e-2 * np.abs(a).max())


def test_tree_order_is_jax_flatten_order():
    tree = {"z": torch.zeros(1), "a": (torch.ones(2), None,
                                       {"c": torch.ones(3), "b": 4})}
    jtree = {"z": 0, "a": (1, None, {"c": 2, "b": 3})}
    order = jax.tree_util.tree_leaves(jtree)
    got = tree_leaves(tree_unflatten(tree, order))
    assert got == [1, 3, 2, 0]  # a.0, a.2.b, a.2.c, z
    assert list(tree_unflatten(tree, order)) == ["z", "a"]  # keys kept


def test_checkpoint_round_trip(tmp_path):
    """float32, bfloat16 and int leaves and a Python int round-trip bit
    for bit; the manifest records each leaf's dtype and shape; restore
    casts to the like tree and refuses a mismatched one."""
    tree = {"params": _torch_tree(_tree(2)),
            "bf16": torch.randn(4, 6).to(torch.bfloat16),
            "count": torch.tensor(7, dtype=torch.int32), "step": 3}
    assert save_pytree(str(tmp_path / "ck"), tree) == "npz"
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["n"] == 6
    assert {s["dtype"] for s in manifest["leaves"]} == {
        "bfloat16", "int32", "float32", "int64"}
    like = tree_map(lambda x: torch.zeros_like(x) if torch.is_tensor(x)
                    else x, tree)
    got = restore_pytree(str(tmp_path / "ck"), like)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        if torch.is_tensor(a):
            assert b.dtype == a.dtype and torch.equal(a, b)
        else:
            assert int(b) == a
    bad = dict(like, bf16=torch.zeros(4, 5))
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(str(tmp_path / "ck"), bad)
    with pytest.raises(ValueError, match="structure"):
        restore_pytree(str(tmp_path / "ck"), {"params": like["params"]})


def test_checkpoint_crosses_packages(tmp_path, monkeypatch):
    """A float32 params checkpoint written by the JAX package's
    save_pytree (npz backend) restores in the port, and the port's
    restores in the JAX package; a bfloat16 JAX leaf is read bit for
    bit."""
    monkeypatch.setattr(jax_checkpoint, "_have_orbax", lambda: False)
    params = _tree(3)
    jax_checkpoint.save_pytree(str(tmp_path / "jax"), _jax_tree(params))
    got = restore_pytree(str(tmp_path / "jax"), _torch_tree(_tree(4)))
    for a, b in zip(jax.tree_util.tree_leaves(params), tree_leaves(got)):
        np.testing.assert_array_equal(to_numpy(b), a)

    save_pytree(str(tmp_path / "port"), _torch_tree(params))
    back = jax_checkpoint.restore_pytree(str(tmp_path / "port"),
                                         _jax_tree(_tree(5)))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a)

    bf = _jax_tree(params, jnp.bfloat16)
    jax_checkpoint.save_pytree(str(tmp_path / "bf16"), bf)
    got = restore_pytree(str(tmp_path / "bf16"),
                         _torch_tree(params, torch.bfloat16))
    for a, b in zip(jax.tree_util.tree_leaves(bf), tree_leaves(got)):
        assert b.dtype == torch.bfloat16
        torch.testing.assert_close(b, to_torch(a), atol=0, rtol=0)


def test_checkpoint_refuses_orbax(tmp_path):
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "manifest.json").write_text(json.dumps(
        {"backend": "orbax", "n": 1, "leaves": [{"shape": [2],
                                                 "dtype": "float32"}]}))
    with pytest.raises(RuntimeError, match="orbax"):
        restore_pytree(str(ck), {"x": torch.zeros(2)})
    (tmp_path / "bare").mkdir()  # manifest-less, no npz: an orbax layout
    with pytest.raises(RuntimeError, match="npz"):
        restore_pytree(str(tmp_path / "bare"), {"x": torch.zeros(2)})


def test_token_batcher_matches_jax_copy(tmp_path):
    tokens = np.arange(1000, dtype=np.uint16)
    np.save(tmp_path / "t.npy", tokens)
    tokens.tofile(tmp_path / "t.bin")
    ours = load_tokens(str(tmp_path / "t.npy"))
    assert np.array_equal(load_tokens(str(tmp_path / "t.bin"),
                                      dtype=np.uint16), ours)
    a = TokenBatcher(ours, batch_size=3, seq_len=15, seed=4, epochs=2)
    b = JaxBatcher(tokens, batch_size=3, seq_len=15, seed=4, epochs=2)
    got, want = list(a), list(b)
    assert len(got) == len(want) == 2 * (1000 // 16 // 3)
    for x, y in zip(got, want):
        assert x.dtype == np.int32 and np.array_equal(x, y)
    assert a.state() == b.state()
    with pytest.raises(ValueError, match="dtype"):
        load_tokens(str(tmp_path / "t.bin"))


def test_trace_helpers(tmp_path):
    timer = OpTimer()
    for _ in range(3):
        with timer.span("step"):
            pass
    timer.record("io", 0.5)
    summary = timer.summary()
    assert summary["step"]["count"] == 3.0
    assert summary["io"]["p50_us"] == pytest.approx(5e5)
    with profile_to(str(tmp_path / "prof")) as prof:
        with trace_span("train_step"):
            torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").exists()
    assert "train_step" in {e.key for e in prof.key_averages()}
