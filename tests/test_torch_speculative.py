"""The port's speculative decoders (starway_tpu_torch.models.speculative)
against the JAX package's on the same parameters: greedy
``generate_speculative`` (gamma 2, 4, 6; a self-draft; eos fill; the
truncation draft; int8 caches; a windowed model; the qwen2 and gemma
families) and ``generate_lookup`` (ngram 1, 2, 3) give JAX's tokens, and
the acceptance stats equal JAX's exactly; ragged rows equal solo rows;
``_lookup_propose`` and the validation keywords match.  The sampled paths
are held by distribution, as the port samples from a ``torch.Generator``:
every token in the target's top-k support, and the second token's
marginal over 4096 rows within total variation 0.12 of the exactly
computed target marginal and 0.05 nearer it than the draft's.

Left out, with the JAX package's tensor-parallel cases: the port has no
tensor-parallel mesh (ROADMAP.md, Queue 1 item 6).  The MoE case is in
tests/test_torch_moe.py.  Debug preset, float32, on the CPU."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import init_params as jax_init_params
from starway_tpu_torch.models import (LlamaConfig, draft_from_truncation,
                                      forward, generate, generate_lookup,
                                      generate_speculative)
from starway_tpu_torch.models.convert import params_from_numpy
from torch_port_util import tree_to_numpy

jgen = importlib.import_module("starway_tpu.models.generate")
jspec = importlib.import_module("starway_tpu.models.speculative")
tspec = importlib.import_module("starway_tpu_torch.models.speculative")


def _pair(seed, **kw):
    jcfg = JaxConfig.preset("debug", **kw)
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, LlamaConfig.preset("debug", **kw), jp, params_from_numpy(
        tree_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def target():
    return _pair(0)


@pytest.fixture(scope="module")
def draft():
    return _pair(1, n_layers=1)


def _prompt(seed, b, p):
    return np.random.default_rng(seed).integers(1, 512, (b, p), np.int32)


def _spec(target, draft, prompt, max_new, **kw):
    jcfg, tcfg, jp, tp = target
    jdcfg, tdcfg, jdp, tdp = draft
    j = jspec.generate_speculative(jp, jcfg, jdp, jdcfg, jnp.asarray(prompt),
                                   max_new, **kw)
    t = generate_speculative(tp, tcfg, tdp, tdcfg, torch.as_tensor(prompt),
                             max_new, **kw)
    return j, t


def _look(target, prompt, max_new, **kw):
    jcfg, tcfg, jp, tp = target
    j = jspec.generate_lookup(jp, jcfg, jnp.asarray(prompt), max_new, **kw)
    t = generate_lookup(tp, tcfg, torch.as_tensor(prompt), max_new, **kw)
    return j, t


def _equal(j, t, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


@pytest.mark.parametrize("gamma", [2, 4, 6])
def test_greedy_speculative_matches_jax(target, draft, gamma):
    prompt = _prompt(0, 3, 10)
    (j, js), (t, ts) = _spec(target, draft, prompt, 17, gamma=gamma,
                             return_stats=True)
    _equal(j, t)
    for name in ("macro_steps", "accepted"):
        _equal(js[name], ts[name], name)
    _, tcfg, _, tp = target
    assert torch.equal(t, generate(tp, tcfg, torch.as_tensor(prompt), 17))


def test_greedy_self_draft_and_stats(target):
    prompt = _prompt(1, 2, 6)
    (j, js), (t, ts) = _spec(target, target, prompt, 11, gamma=5,
                             return_stats=True)
    _equal(j, t)
    for name in ("macro_steps", "accepted"):
        _equal(js[name], ts[name], name)
    steps, acc = ts["macro_steps"], ts["accepted"]
    assert bool(((acc + steps) >= 10).all())  # a + 1 emitted a live step
    assert float(acc.sum() / (steps.sum() * 4)) >= 0.9


def test_greedy_speculative_eos_fill(target, draft):
    _, tcfg, _, tp = target
    prompt = _prompt(2, 2, 8)
    free = generate(tp, tcfg, torch.as_tensor(prompt), 10)
    eos = int(free[0, 8 + 2])  # row 0 stops early
    j, t = _spec(target, draft, prompt, 10, gamma=4, eos_id=eos)
    _equal(j, t)
    assert torch.equal(t, generate(tp, tcfg, torch.as_tensor(prompt), 10,
                                   eos_id=eos))
    assert (t[0, 11:] == eos).all()


def test_decoders_max_new_one(target, draft):
    from starway_tpu_torch.models import generate_beam

    _, tcfg, _, tp = target
    prompt = _prompt(9, 2, 5)
    want = generate(tp, tcfg, torch.as_tensor(prompt), 1)
    j, t = _spec(target, draft, prompt, 1, gamma=3)
    _equal(j, t)
    assert torch.equal(t, want)
    assert torch.equal(generate_lookup(tp, tcfg, torch.as_tensor(prompt), 1,
                                       gamma=3), want)
    assert torch.equal(generate_beam(tp, tcfg, torch.as_tensor(prompt), 1,
                                     beams=3), want)


def test_speculative_validation(target, draft):
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    prompt = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="gamma"):
        generate_speculative(tp, tcfg, dp, dcfg, prompt, 4, gamma=1)
    with pytest.raises(ValueError, match="max_new_tokens"):
        generate_speculative(tp, tcfg, dp, dcfg, prompt, 0)
    with pytest.raises(ValueError, match="vocab"):
        generate_speculative(tp, tcfg, dp,
                             LlamaConfig.preset("debug", vocab_size=64),
                             prompt, 4)
    with pytest.raises(ValueError, match="ngram"):
        generate_lookup(tp, tcfg, prompt, 4, ngram=0)
    with pytest.raises(ValueError, match="gamma"):
        generate_lookup(tp, tcfg, prompt, 4, gamma=1)
    with pytest.raises(ValueError, match="prompt_lengths"):
        generate_lookup(tp, tcfg, prompt, 4, prompt_lengths=[5])
    moe = LlamaConfig.preset("debug", n_experts=4)  # droppy: 1.25 < 4
    with pytest.raises(ValueError, match="dropless"):
        generate_speculative(tp, moe, dp, dcfg, prompt, 4)
    with pytest.raises(ValueError, match="dropless"):
        generate_lookup(tp, moe, prompt, 4)


def test_windowed_speculative_matches_jax():
    """A sliding-window model speculates through full caches with window
    masks; generate() decodes it through the rolling cache: same tokens,
    and the JAX decoders' tokens too."""
    win = _pair(0, sliding_window=6)
    _, tcfg, _, tp = win
    prompt = _prompt(9, 2, 9)
    want = generate(tp, tcfg, torch.as_tensor(prompt), 12)
    j, t = _spec(win, win, prompt, 12, gamma=4)
    _equal(j, t)
    assert torch.equal(t, want)
    j, t = _look(win, prompt, 12, gamma=4, ngram=2)
    _equal(j, t)
    assert torch.equal(t, want)


def test_windowed_speculative_cache_of_window_size():
    """P + max_new + gamma == window: the decoders take one slot more, as
    chunk_decode_step reads a cache of the window's size as rolling; the
    JAX decoders' tokens, and generate()'s."""
    win = _pair(0, sliding_window=12)
    _, tcfg, _, tp = win
    prompt = _prompt(3, 1, 4)
    want = generate(tp, tcfg, torch.as_tensor(prompt), 5)
    j, t = _spec(win, win, prompt, 5, gamma=3)
    _equal(j, t)
    assert torch.equal(t, want)
    j, t = _look(win, prompt, 5, gamma=3)
    _equal(j, t)
    assert torch.equal(t, want)


def test_speculative_int8_cache(target, draft):
    q_target = _pair(0, kv_quant="int8")
    q_draft = _pair(1, n_layers=1, kv_quant="int8")
    prompt = _prompt(5, 2, 7)
    j, t = _spec(q_target, q_draft, prompt, 9, gamma=4)
    _equal(j, t)
    _, tcfg, _, tp = q_target
    assert torch.equal(t, generate(tp, tcfg, torch.as_tensor(prompt), 9))


def test_truncation_draft(target):
    jcfg, tcfg, jp, tp = target
    dp, dcfg = draft_from_truncation(tp, tcfg, 1)
    assert dcfg.n_layers == 1
    assert torch.equal(dp["layers"]["wq"], tp["layers"]["wq"][:1])
    assert dp["embed"] is tp["embed"]
    assert dp["layers"]["wq"].data_ptr() == tp["layers"]["wq"].data_ptr()
    jdp, jdcfg = jspec.draft_from_truncation(jp, jcfg, 1)
    prompt = _prompt(7, 2, 8)
    j = jspec.generate_speculative(jp, jcfg, jdp, jdcfg, jnp.asarray(prompt),
                                   10, gamma=3)
    t = generate_speculative(tp, tcfg, dp, dcfg, torch.as_tensor(prompt), 10,
                             gamma=3)
    _equal(j, t)
    for bad in (2, 0):
        with pytest.raises(ValueError, match="n_layers"):
            draft_from_truncation(tp, tcfg, bad)
    # W8A16 pairs slice too.
    from starway_tpu_torch.ops.quantize import quantize_params

    qp, _ = draft_from_truncation(quantize_params(tp), tcfg, 1)
    assert qp["layers"]["wq"]["q"].shape[0] == 1
    assert qp["layers"]["wq"]["s"].shape[0] == 1


def test_lookup_propose_matches_jax():
    seq = np.asarray([[9, 5, 7, 2, 5, 7, 3, 0, 0, 0, 0, 0],
                      [1, 2, 1, 2, 1, 2, 1, 0, 0, 0, 0, 0]], np.int32)
    pos = np.asarray([5, 6], np.int32)
    got = tspec._lookup_propose(torch.as_tensor(seq).long(),
                                torch.as_tensor(pos).long(), ngram=2, gamma=4)
    np.testing.assert_array_equal(got.numpy(), [[2, 5, 7], [2, 1, 0]])
    rng = np.random.default_rng(3)
    for ngram in (1, 2, 3):
        for gamma in (2, 5):
            seq = rng.integers(0, 4, (4, 16)).astype(np.int32)
            pos = rng.integers(0, 16, 4).astype(np.int32)
            want = jspec._lookup_propose(jnp.asarray(seq), jnp.asarray(pos),
                                         ngram=ngram, gamma=gamma)
            got = tspec._lookup_propose(torch.as_tensor(seq).long(),
                                        torch.as_tensor(pos).long(),
                                        ngram=ngram, gamma=gamma)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_lookup_greedy_matches_jax(target, ngram):
    prompt = _prompt(0, 2, 10)
    (j, js), (t, ts) = _look(target, prompt, 15, gamma=4, ngram=ngram,
                             return_stats=True)
    _equal(j, t)
    for name in ("macro_steps", "accepted"):
        _equal(js[name], ts[name], name)
    _, tcfg, _, tp = target
    assert torch.equal(t, generate(tp, tcfg, torch.as_tensor(prompt), 15))
    if ngram == 2:
        assert int(ts["accepted"].sum()) > 0  # a greedy loop repeats


def test_ragged_speculative_matches_solo_rows(target, draft):
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    P, lengths = 12, [5, 12]
    prompt = np.zeros((2, P), np.int32)
    rng = np.random.default_rng(6)
    for i, n in enumerate(lengths):
        prompt[i, :n] = rng.integers(1, 512, n)
    j, spec = _spec(target, draft, prompt, 7, gamma=3,
                    prompt_lengths=lengths)
    _equal(j, spec)
    j, look = _look(target, prompt, 7, gamma=3, ngram=2,
                    prompt_lengths=lengths)
    _equal(j, look)
    for i, n in enumerate(lengths):
        solo = generate(tp, tcfg, torch.as_tensor(prompt[i:i + 1, :n]), 7)
        assert torch.equal(spec[i], solo[0, n:]), i
        assert torch.equal(look[i], solo[0, n:]), i


@pytest.mark.parametrize("flavour", ["qwen2", "gemma"])
def test_family_configs_speculate(flavour):
    kw = (dict(attn_bias=True) if flavour == "qwen2"
          else dict(mlp_act="gelu_tanh", scaled_embed=True))
    jcfg = JaxConfig.preset("debug", **kw)
    jp = jax_init_params(jax.random.PRNGKey(7), jcfg)
    if flavour == "qwen2":
        jp["layers"]["bq"] = 0.3 * jax.random.normal(
            jax.random.PRNGKey(8), jp["layers"]["bq"].shape)
    fam = (jcfg, LlamaConfig.preset("debug", **kw), jp,
           params_from_numpy(tree_to_numpy(jp), device="cpu"))
    prompt = _prompt(7, 2, 6)
    j, t = _spec(fam, fam, prompt, 9, gamma=4)
    _equal(j, t, flavour)


def test_accept_emit_rule():
    """The rule on hand-made inputs: leading accepts, the correction from
    the residual, the clamped advance at the budget, a frozen row."""
    V, G = 4, 3
    drafts = torch.tensor([[1, 2], [1, 2], [3, 3]])
    logits = torch.full((3, G, V), -5.0)
    logits[0, 0, 1] = logits[0, 1, 2] = logits[0, 2, 0] = 5.0  # all accept
    logits[1, 0, 1] = logits[1, 1, 3] = 5.0  # second rejected -> 3
    logits[2, :, 0] = 5.0
    out = torch.zeros((3, 4 + G), dtype=torch.long)
    n_out = torch.tensor([1, 3, 4])  # row 2 done (max_new 4)
    t_pend = torch.tensor([7, 7, 7])
    pos = torch.tensor([10, 10, 10])
    stats = torch.zeros((3, 2), dtype=torch.long)
    pd = torch.nn.functional.one_hot(drafts, V).float()
    out, n_out, t_pend, pos, stats, emit = tspec._accept_emit(
        drafts, pd, logits, None, out, n_out, t_pend, pos, stats,
        greedy=True, G=G, max_new=4, probs_of=None)
    assert emit.tolist() == [[1, 2, 0], [1, 3, 0], [0, 0, 0]]
    assert n_out.tolist() == [4, 4, 4]  # row 1 clamped to 1 more
    assert pos.tolist() == [13, 11, 10]
    assert t_pend.tolist() == [0, 7, 7]  # row 1 clamped: keeps its pending
    assert stats.tolist() == [[1, 2], [1, 1], [0, 0]]
    assert out[0, 1:4].tolist() == [1, 2, 0]


def test_sampled_speculative_respects_target_support(target, draft):
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    TOP_K = 4
    prompt = torch.as_tensor(_prompt(8, 2, 6))
    gen = torch.Generator().manual_seed(11)
    outs = [generate_speculative(tp, tcfg, dp, dcfg, prompt, 10, gamma=3,
                                 temperature=1.0, top_k=TOP_K, generator=gen),
            generate_lookup(tp, tcfg, prompt, 10, gamma=3, ngram=2,
                            temperature=1.0, top_k=TOP_K, generator=gen)]
    P = prompt.shape[1]
    for out in outs:
        gen_logits = forward(tp, out[:, :-1], tcfg)[:, P - 1:]
        kth = torch.sort(gen_logits, dim=-1).values[:, :, -TOP_K]
        tok = gen_logits.gather(-1, out[:, P:, None])[..., 0]
        assert bool((tok >= kth - 1e-3).all())


def test_sampled_speculative_preserves_target_distribution():
    """V = 32, one layer each, temperature 1, 4096 rows: the second new
    token's empirical marginal against the exact target and draft
    marginals (sum over the first token t of q0(t) q1(. | prompt + t))."""
    V = 32
    tiny = dict(vocab_size=V, d_model=32, n_layers=1, n_heads=2,
                n_kv_heads=2, d_ff=64)
    _, cfg, _, tparams = _pair(3, **tiny)
    dparams = _pair(4, **tiny)[3]
    B = 4096
    prompt = torch.tensor([[3, 7, 1, 9]]).repeat(B, 1)
    P = prompt.shape[1]

    def exact_marginal(params):
        q0 = torch.softmax(forward(params, prompt[:1], cfg)[0, -1], -1)
        ext = torch.cat([prompt[:1].repeat(V, 1),
                         torch.arange(V)[:, None]], dim=1)
        q1 = torch.softmax(forward(params, ext, cfg)[:, -1], -1)
        return (q0 @ q1).numpy()

    target_m, draft_m = exact_marginal(tparams), exact_marginal(dparams)
    assert 0.5 * np.abs(target_m - draft_m).sum() > 0.15  # the test has power
    out = generate_speculative(tparams, cfg, dparams, cfg, prompt, 2,
                               gamma=3, temperature=1.0,
                               generator=torch.Generator().manual_seed(7))
    emp = np.bincount(out[:, P + 1].numpy(), minlength=V) / B
    tvd_target = 0.5 * np.abs(emp - target_m).sum()
    tvd_draft = 0.5 * np.abs(emp - draft_m).sum()
    assert tvd_target < 0.12, tvd_target
    assert tvd_draft > tvd_target + 0.05, (tvd_draft, tvd_target)

