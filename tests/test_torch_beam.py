"""The port's beam search (starway_tpu_torch.models.beam) against the JAX
package's on the same parameters: sequences, scores (1e-4) and
``finished`` equal JAX's with and without eos, on a W8A16 tree with an
int8 cache; ``beams=1`` is greedy ``generate()``; every score is its
beam's teacher-forced logprob sum (up to and including its first eos);
ties between candidates keep the lower index first, as JAX's
``lax.top_k`` does; a sliding-window model searches through a full cache
with the window mask, held against the JAX package's windowed generate()
and forward.  Debug preset, float32, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import forward as jax_forward
from starway_tpu.models import generate as jax_generate
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models.beam import generate_beam as jax_generate_beam
from starway_tpu.ops.quantize import quantize_params as jax_quantize_params
from starway_tpu_torch.models import (LlamaConfig, forward, generate,
                                      generate_beam)
from starway_tpu_torch.models.beam import top_k_stable
from starway_tpu_torch.models.convert import params_from_numpy
from torch_port_util import tree_to_numpy

SCORE_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, LlamaConfig.preset("debug"), jp, params_from_numpy(
        tree_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(1, 512, (2, 8), np.int32)


def _teacher_scores(params, cfg, prompt, out):
    """[B, K] sums of the emitted tokens' logprobs, by a plain forward."""
    B, K, _ = out.shape
    P = prompt.shape[1]
    seqs = torch.cat([prompt[:, None].expand(B, K, P), out], dim=2
                     ).reshape(B * K, -1)
    lp = torch.log_softmax(forward(params, seqs[:, :-1], cfg), dim=-1)
    got = lp[:, P - 1:].gather(-1, seqs[:, P:, None])[..., 0]
    return got.sum(-1).reshape(B, K)


def _assert_like_jax(j, t):
    (jo, js, jf), (to, ts, tf) = j, t
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("eos", [False, True])
def test_beam_matches_jax(model, prompt, eos):
    jcfg, tcfg, jp, tp = model
    tprompt = torch.as_tensor(prompt).long()
    eos_id = None
    if eos:  # the first beam's second token: some beams finish
        free = generate_beam(tp, tcfg, tprompt, 8, beams=3, return_all=True)
        eos_id = int(free[0][0, 0, 1])
    j = jax_generate_beam(jp, jcfg, jnp.asarray(prompt), 8, beams=3,
                          eos_id=eos_id, return_all=True)
    t = generate_beam(tp, tcfg, tprompt, 8, beams=3, eos_id=eos_id,
                      return_all=True)
    _assert_like_jax(j, t)
    out, scores, fin = t
    assert bool((scores[:, 1:] <= scores[:, :-1] + 1e-5).all())
    if not eos:
        torch.testing.assert_close(scores, _teacher_scores(tp, tcfg, tprompt,
                                                           out),
                                   atol=1e-3, rtol=1e-4)
        for b in range(2):
            assert len({tuple(out[b, k].tolist()) for k in range(3)}) == 3
        return
    assert fin.any(), "no beam finished: the eos case is vacuous"
    for b in range(2):
        for k in range(3):
            row = out[b, k].tolist()
            if not (fin[b, k] and eos_id in row):
                continue
            i = row.index(eos_id)
            assert all(tok == eos_id for tok in row[i:])
            upto = _teacher_scores(tp, tcfg, tprompt[b:b + 1],
                                   out[b:b + 1, k:k + 1, :i + 1])
            assert abs(float(upto) - float(scores[b, k])) < 1e-3


def test_beam1_is_greedy(model, prompt):
    _, tcfg, _, tp = model
    tprompt = torch.as_tensor(prompt).long()
    assert torch.equal(generate_beam(tp, tcfg, tprompt, 10, beams=1),
                       generate(tp, tcfg, tprompt, 10))
    free = generate(tp, tcfg, tprompt, 8)
    eos = int(free[0, 8 + 2])
    assert torch.equal(generate_beam(tp, tcfg, tprompt, 8, beams=1,
                                     eos_id=eos),
                       generate(tp, tcfg, tprompt, 8, eos_id=eos))


def test_beam_quantized_trees_match_jax(model, prompt):
    """W8A16 weights and an int8 cache through beam search: every cache
    leaf, the scales included, follows its beam."""
    _, _, jp, _ = model
    kw = dict(kv_quant="int8")
    jcfg8, tcfg8 = JaxConfig.preset("debug", **kw), LlamaConfig.preset(
        "debug", **kw)
    jq = jax_quantize_params(jp)
    tq = params_from_numpy(tree_to_numpy(jq), device="cpu")
    tprompt = torch.as_tensor(prompt).long()
    assert torch.equal(generate_beam(tq, tcfg8, tprompt, 6, beams=1),
                       generate(tq, tcfg8, tprompt, 6))
    j = jax_generate_beam(jq, jcfg8, jnp.asarray(prompt), 6, beams=3,
                          return_all=True)
    t = generate_beam(tq, tcfg8, tprompt, 6, beams=3, return_all=True)
    _assert_like_jax(j, t)
    torch.testing.assert_close(t[1], _teacher_scores(tq, tcfg8, tprompt,
                                                     t[0]), atol=0.15,
                               rtol=0)


def test_top_k_keeps_the_lower_index_first_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    values, indices = top_k_stable(x, 3)
    assert indices.tolist() == [[1, 2, 4], [0, 1, 2]]
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))


def test_beam_ties_pick_as_jax():
    """A model whose head is zero scores every token alike: each step is
    all ties, so the beams are set by the tie order alone: the K lowest
    flat indices, which are beam 0's tokens 0..K-1, every step; they
    equal JAX's."""
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jp["lm_head"] = jnp.zeros_like(jp["lm_head"])
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    j = jax_generate_beam(jp, jcfg, jnp.asarray(prompt), 4, beams=3,
                          return_all=True)
    t = generate_beam(tp, LlamaConfig.preset("debug"),
                      torch.as_tensor(prompt).long(), 4, beams=3,
                      return_all=True)
    _assert_like_jax(j, t)
    assert t[0][0].tolist() == [[0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 2]]


def test_windowed_beam_uses_the_window():
    """The port searches a sliding-window model through a full cache with
    the window mask (the JAX package refuses such a config): beams=1 is
    the JAX package's greedy generate() on the windowed config, which
    decodes through the rolling cache, and every score is its beam's
    teacher-forced sum under the JAX package's windowed forward."""
    jcfg = JaxConfig.preset("debug", sliding_window=4)
    cfg = LlamaConfig.preset("debug", sliding_window=4)
    jp = jax_init_params(jax.random.PRNGKey(0), JaxConfig.preset("debug"))
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    prompt = np.random.default_rng(1).integers(1, 512, (2, 7), np.int32)
    tprompt = torch.as_tensor(prompt).long()
    want = jax_generate(jp, jcfg, jnp.asarray(prompt), 6)
    np.testing.assert_array_equal(
        generate_beam(tp, cfg, tprompt, 6, beams=1).numpy(),
        np.asarray(want))
    out, scores, _ = generate_beam(tp, cfg, tprompt, 6, beams=3,
                                   return_all=True)
    B, K, N = out.shape
    P = prompt.shape[1]
    seqs = np.concatenate([np.broadcast_to(prompt[:, None], (B, K, P)),
                           out.numpy()], axis=2).reshape(B * K, P + N)
    lp = jax.nn.log_softmax(jax_forward(jp, jnp.asarray(seqs[:, :-1]), jcfg),
                            axis=-1)
    teacher = np.take_along_axis(np.asarray(lp)[:, P - 1:],
                                 seqs[:, P:, None], axis=-1)[..., 0]
    np.testing.assert_allclose(scores.numpy(),
                               teacher.sum(-1).reshape(B, K),
                               atol=SCORE_ATOL)


def test_beam_validation(model, prompt):
    _, tcfg, _, tp = model
    tprompt = torch.as_tensor(prompt).long()
    with pytest.raises(ValueError, match="beams"):
        generate_beam(tp, tcfg, tprompt, 4, beams=0)
    with pytest.raises(ValueError, match="beams"):
        generate_beam(tp, tcfg, tprompt, 4, beams=513)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate_beam(tp, tcfg, tprompt, 0)
    with pytest.raises(ValueError, match="max_len"):
        generate_beam(tp, tcfg, tprompt, 8, max_len=10)
