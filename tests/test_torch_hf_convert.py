"""The port's HuggingFace conversion (starway_tpu_torch.models.hf_convert)
against transformers and against the JAX package's converter, on tiny
random HF models built here (no download).

* ``config_from_hf`` gives JAX's ``LlamaConfig`` field for field for every
  family (Llama, Mistral, Qwen2, Gemma, Phi-3, Mixtral) and every
  ``rope_scaling`` kind, and refuses what JAX refuses with its message;
* ``params_from_hf`` gives JAX's tree leaf for leaf, bit for bit in
  float32 and bfloat16, the int8 codes and scales of ``quantize="int8"``,
  Mixtral's expert leaves; from a model, a state dict with or without the
  ``model.`` prefix, and a tied head;
* the converted models' logits match transformers' (atol 2e-4-3e-4, rtol
  2e-3, as the JAX package's tests hold its own) and greedy generation is
  token for token transformers', the Mistral model through the port's
  rolling cache.  Mixtral (the JAX package's test config) matches
  transformers' logits at atol 3e-4, rtol 2e-3, and its greedy and ragged
  generation token for token; its training stays refused (ROADMAP.md,
  Queue 1 item 6)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from starway_tpu.models import hf_convert as jhf  # noqa: E402
from starway_tpu_torch.models import (config_from_hf, forward,  # noqa: E402
                                      generate, loss_fn, params_from_hf)
from torch_port_util import to_numpy  # noqa: E402

SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=112,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128,
             attn_implementation="eager")
HALF = 16  # longrope factors: head_dim 32 -> 16
LONGROPE = {"type": "longrope",
            "short_factor": [1.0 + 0.05 * i for i in range(HALF)],
            "long_factor": [2.0 + 0.1 * i for i in range(HALF)]}

# family: (config class, model class, config kwargs, seed, logit atol)
FAMILIES = {
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(num_hidden_layers=3, rope_theta=10000.0,
                   tie_word_embeddings=False), 0, 2e-4),
    "llama_head_dim": ("LlamaConfig", "LlamaForCausalLM",
                       dict(head_dim=32, tie_word_embeddings=False), 5, 2e-4),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(sliding_window=6), 3, 2e-4),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
              dict(rope_theta=10000.0, tie_word_embeddings=False), 9, 2e-4),
    "qwen2_window": ("Qwen2Config", "Qwen2ForCausalLM",
                     dict(use_sliding_window=True, sliding_window=6,
                          max_window_layers=0, tie_word_embeddings=False),
                     21, 2e-4),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(head_dim=32), 13,
              3e-4),
    "phi3": ("Phi3Config", "Phi3ForCausalLM",
             dict(vocab_size=33000, tie_word_embeddings=False), 17, 3e-4),
    "phi35_longrope": ("Phi3Config", "Phi3ForCausalLM",
                       dict(num_attention_heads=2, num_key_value_heads=2,
                            max_position_embeddings=256,
                            original_max_position_embeddings=64,
                            rope_scaling=LONGROPE, tie_word_embeddings=False,
                            pad_token_id=0), 13, 3e-4),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM",
                dict(num_local_experts=4, num_experts_per_tok=2,
                     tie_word_embeddings=False), 11, None),
}
ROPE_SCALINGS = {
    "linear": {"rope_type": "linear", "factor": 2.0},
    "llama3": {"rope_type": "llama3", "factor": 4.0, "low_freq_factor": 1.0,
               "high_freq_factor": 2.0,
               "original_max_position_embeddings": 64},
    "yarn": {"rope_type": "yarn", "factor": 4.0,
             "original_max_position_embeddings": 32},
    "yarn_mscale": {"rope_type": "yarn", "factor": 8.0,
                    "original_max_position_embeddings": 16,
                    "beta_fast": 24.0, "beta_slow": 2.0, "mscale": 0.707,
                    "mscale_all_dim": 0.5},
}

_MODELS = {}


def hf_model(family):
    """The family's tiny random model (built once a process); Qwen2's
    zero-initialised biases are randomised, so a dropped bias shows."""
    if family not in _MODELS:
        if family in ROPE_SCALINGS:
            spec = ("LlamaConfig", "LlamaForCausalLM",
                    dict(rope_theta=10000.0, tie_word_embeddings=False,
                         rope_scaling=dict(ROPE_SCALINGS[family])), 7, 3e-4)
        else:
            spec = FAMILIES[family]
        cfg_cls, model_cls, kw, seed, _ = spec
        hf_cfg = getattr(transformers, cfg_cls)(**dict(SMALL, **kw))
        torch.manual_seed(seed)
        model = getattr(transformers, model_cls)(hf_cfg).eval()
        if family.startswith("qwen2"):
            with torch.no_grad():
                for layer in model.model.layers:
                    for proj in (layer.self_attn.q_proj,
                                 layer.self_attn.k_proj,
                                 layer.self_attn.v_proj):
                        proj.bias.normal_(0.0, 0.5)
        _MODELS[family] = model
    return _MODELS[family]


def _tree_equal(got, want, path=""):
    """Leaf for leaf, bit for bit."""
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _tree_equal(g, w, f"{path}/{key}")
            continue
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, f"{path}/{key}"
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), w.view(np.int16),
                err_msg=f"{path}/{key}")
        else:
            assert g.is_contiguous(), f"{path}/{key}"
            np.testing.assert_array_equal(to_numpy(g), w,
                                          err_msg=f"{path}/{key}")


@pytest.mark.parametrize("family", sorted(FAMILIES) + sorted(ROPE_SCALINGS))
def test_config_from_hf_matches_jax(family):
    hf_cfg = hf_model(family).config
    got = dataclasses.asdict(config_from_hf(hf_cfg, dtype="float32"))
    want = dataclasses.asdict(jhf.config_from_hf(hf_cfg, dtype="float32"))
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_from_hf_matches_jax(family, dtype):
    model = hf_model(family)
    cfg = config_from_hf(model.config, dtype=dtype)
    jcfg = jhf.config_from_hf(model.config, dtype=dtype)
    got = params_from_hf(model, cfg, device="cpu")
    _tree_equal(got, jhf.params_from_hf(model, jcfg))
    if family == "mixtral":
        assert got["layers"]["moe"]["w_gate"].shape == (2, 4, 64, 112)
        with pytest.raises(NotImplementedError):
            params_from_hf(model, cfg, quantize="int8", device="cpu")
    elif dtype == "bfloat16":  # the W8A16 tree from the serving dtype
        _tree_equal(params_from_hf(model, cfg, quantize="int8",
                                   device="cpu"),
                    jhf.params_from_hf(model, jcfg, quantize="int8"))


def test_params_from_state_dicts():
    """A state dict converts as the model does, with or without the
    ``model.`` prefix; without ``lm_head`` the head is the embedding's
    transpose; a dtype name or a torch dtype."""
    model = hf_model("llama")
    cfg = config_from_hf(model.config, dtype="float32")
    want = params_from_hf(model, cfg, device="cpu")
    state = dict(model.state_dict())
    _tree_equal(params_from_hf(state, cfg, device="cpu"), _np(want))
    bare = {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in state.items()}
    _tree_equal(params_from_hf(bare, cfg, torch.float32, device="cpu"),
                _np(want))
    tied = {k: v for k, v in state.items() if k != "lm_head.weight"}
    got = params_from_hf(tied, cfg, device="cpu")
    assert torch.equal(got["lm_head"], got["embed"].t())
    _tree_equal(got, _np(jhf.params_from_hf(tied, jhf.config_from_hf(
        model.config, dtype="float32"))))
    with pytest.raises(ValueError, match="quantize"):
        params_from_hf(model, cfg, quantize="int4", device="cpu")


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("family", [f for f in sorted(FAMILIES)
                                    if f != "mixtral"]
                         + sorted(ROPE_SCALINGS))
def test_logits_and_generation_match_transformers(family):
    """Logits against the HF forward (both longrope regimes for Phi-3.5:
    90 tokens is past its original 64), and greedy generation token for
    token: the prefill and the cached decode, the rolling cache where the
    window is shorter than the run."""
    model = hf_model(family)
    atol = FAMILIES[family][4] if family in FAMILIES else 3e-4
    cfg = config_from_hf(model.config, dtype="float32")
    params = params_from_hf(model, cfg, device="cpu")
    lengths = (50, 90) if family in ROPE_SCALINGS or "longrope" in family \
        else (17,)
    vocab = min(cfg.vocab_size, 1000)
    for S in lengths:
        tokens = torch.as_tensor(np.random.default_rng(S).integers(
            0, vocab, (2, S)))
        with torch.no_grad():
            ref = model(tokens).logits
        torch.testing.assert_close(forward(params, tokens, cfg), ref,
                                   atol=atol, rtol=2e-3)
    prompt = torch.tensor([[7, 3, 11, 5]])
    with torch.no_grad():
        ref = model.generate(prompt, max_new_tokens=10, do_sample=False,
                             pad_token_id=0)
    ours = generate(params, cfg, prompt, 10)
    assert torch.equal(ours[:, :ref.shape[1]], ref)


def test_mixtral_converts_and_forward_refuses():
    """Mixtral converts dropless; its forward serves, and its loss trains:
    cross-entropy plus ``moe_aux_coef * aux / n_layers`` of the
    forward's balance term."""
    model = hf_model("mixtral")
    cfg = config_from_hf(model.config, dtype="float32")
    assert (cfg.n_experts, cfg.moe_top_k, cfg.moe_swiglu,
            cfg.moe_capacity_factor) == (4, 2, True, 4.0)
    params = params_from_hf(model, cfg, device="cpu")
    assert forward(params, torch.tensor([[1, 2, 3]]), cfg).shape == (
        1, 3, cfg.vocab_size)
    batch = torch.tensor([[1, 2, 3, 4]])
    logits, aux = forward(params, batch[:, :-1], cfg, return_aux=True)
    want = (torch.nn.functional.cross_entropy(logits[0], batch[0, 1:])
            + cfg.moe_aux_coef * aux / cfg.n_layers)
    torch.testing.assert_close(loss_fn(params, batch, cfg), want,
                               rtol=1e-6, atol=1e-6)


def test_mixtral_logits_and_generation_match_transformers():
    """The twin of tests/test_hf_convert.py::test_mixtral_logits_and_
    generation_match_transformers, on its config and seed: logits against
    MixtralForCausalLM, greedy generation token for token through the
    prefill and the cached MoE decode, and ragged rows equal to their solo
    runs."""
    hf_cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(11)
    hf = transformers.MixtralForCausalLM(hf_cfg).eval()
    cfg = config_from_hf(hf.config, dtype="float32")
    params = params_from_hf(hf, cfg, device="cpu")
    assert params["layers"]["moe"]["w_gate"].shape == (2, 4, 64, 112)

    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, 256, (2, 16)))
    with torch.no_grad():
        ref = hf(tokens).logits
    torch.testing.assert_close(forward(params, tokens, cfg), ref, atol=3e-4,
                               rtol=2e-3)
    prompt = torch.tensor([[6, 2, 9]])
    with torch.no_grad():
        ref = hf.generate(prompt, max_new_tokens=10, do_sample=False,
                          pad_token_id=0)
    assert torch.equal(generate(params, cfg, prompt, 10)[:, :ref.shape[1]],
                       ref)
    rows = [[6, 2, 9, 4, 1], [7, 3]]
    padded = torch.tensor([r + [0] * (5 - len(r)) for r in rows])
    ragged = generate(params, cfg, padded, 6, prompt_lengths=[5, 2])
    for b, r in enumerate(rows):
        solo = generate(params, cfg, torch.tensor([r]), 6)[0, len(r):]
        assert torch.equal(ragged[b], solo), b


def _refusal_cases():
    base = hf_model("llama").config
    cases = {}
    cfg = copy.deepcopy(base)
    cfg.attention_bias = True
    cases["o_proj_bias"] = cfg
    cfg = copy.deepcopy(base)
    cfg.mlp_bias = True
    cases["mlp_bias"] = cfg
    cfg = copy.deepcopy(base)
    cfg.rope_scaling = {"rope_type": "dynamic", "factor": 2.0}
    cases["dynamic_rope"] = cfg
    cfg = copy.deepcopy(base)
    cfg.partial_rotary_factor = 0.5
    cases["partial_rotary"] = cfg
    cfg = copy.deepcopy(base)
    cfg.hidden_act = "relu"
    cases["relu"] = cfg
    cfg = copy.deepcopy(base)
    cfg.hidden_size, cfg.head_dim = 66, None
    cases["head_dim"] = cfg
    cases["qwen2_mixed_window"] = transformers.Qwen2Config(
        vocab_size=64, hidden_size=32, intermediate_size=48,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        use_sliding_window=True, sliding_window=8, max_window_layers=2)
    cases["gemma2"] = transformers.Gemma2Config(
        vocab_size=64, hidden_size=32, intermediate_size=48,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16)
    cfg = copy.deepcopy(base)
    cfg.rope_scaling = {"rope_type": "yarn", "factor": 2.0}
    cfg.max_position_embeddings = None
    cases["yarn_without_orig"] = cfg
    return cases


def test_config_refusals_match_jax():
    """Every config the tree cannot represent is refused, with JAX's
    exception type and message."""
    for name, hf_cfg in _refusal_cases().items():
        with pytest.raises(Exception) as want:
            jhf.config_from_hf(hf_cfg)
        with pytest.raises(want.type) as got:
            config_from_hf(hf_cfg)
        assert str(got.value) == str(want.value), name
    # Qwen2 windowed on every layer by max_window_layers >= n_layers: off.
    qcfg = transformers.Qwen2Config(
        vocab_size=64, hidden_size=32, intermediate_size=48,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        use_sliding_window=True, sliding_window=8, max_window_layers=2)
    assert config_from_hf(qcfg).sliding_window is None


def test_state_dict_refusals_match_jax():
    """Biases the tree cannot hold, in a state dict that reached
    params_from_hf without config_from_hf's checks."""
    model = hf_model("llama")
    cfg = config_from_hf(model.config, dtype="float32")
    jcfg = jhf.config_from_hf(model.config, dtype="float32")
    state = dict(model.state_dict())
    o_bias = dict(state, **{"model.layers.0.self_attn.o_proj.bias":
                            torch.zeros(64)})
    phi = dict(hf_model("phi3").state_dict())
    fused_bias = dict(phi, **{"model.layers.0.self_attn.qkv_proj.bias":
                              torch.zeros(64 + 2 * 32)})
    phi_cfg = config_from_hf(hf_model("phi3").config, dtype="float32")
    phi_jcfg = jhf.config_from_hf(hf_model("phi3").config, dtype="float32")
    for st, c, jc in ((o_bias, cfg, jcfg), (fused_bias, phi_cfg, phi_jcfg)):
        with pytest.raises(NotImplementedError) as want:
            jhf.params_from_hf(st, jc)
        with pytest.raises(NotImplementedError) as got:
            params_from_hf(st, c, device="cpu")
        assert str(got.value) == str(want.value)


def test_gemma_norm_fold_and_tied_head():
    model = hf_model("gemma")
    cfg = config_from_hf(model.config, dtype="float32")
    assert cfg.mlp_act == "gelu_tanh" and cfg.scaled_embed
    params = params_from_hf(model, cfg, device="cpu")
    assert float(params["layers"]["attn_norm"].mean()) > 0.5  # 1 + w
    assert torch.equal(params["lm_head"], params["embed"].t())
    unfolded = params_from_hf(model, cfg, norm_plus_one=False, device="cpu")
    torch.testing.assert_close(params["final_norm"],
                               unfolded["final_norm"] + 1.0)
