"""Serve a HuggingFace model through the PyTorch port's decode path.

Twin of examples/serve_hf.py: convert a transformers causal LM into the
port's parameter tree (models/hf_convert.py), then answer a RAGGED batch
of prompts (different lengths, one call) with greedy or sampled decoding
and eos-fill, and cross-check one row against transformers' own
``generate``.

Without ``--model`` it builds the original's tiny random model of the
chosen ``--arch`` offline (``torch.manual_seed(0)``, no download) and
serves it in float32; ``--model DIR`` reads a local checkpoint only and
serves it in bfloat16.  On the card (the default) the prompts run through
the flash forward (csrc/flash_fwd.cu), each decode step through the
decode kernel (csrc/decode_attention.cu), and ``--quantize int8``'s W8A16
weights through the int8 GEMV (csrc/int8_gemv.cu); ``--device cpu`` runs
their plain versions.  ``serve`` takes the parameter tree.

Usage:  python examples/torch/serve_hf.py [--model DIR] [--max-new 12]
        [--arch llama|llama31|qwen2|qwen25|mixtral|gemma|phi3|phi35]
        [--quantize int8] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

ARCHS = ["llama", "llama31", "qwen2", "qwen25", "mixtral", "gemma", "phi3",
         "phi35"]
ROWS = [[11, 3, 9, 1, 4, 2, 8], [7, 5], [2, 6, 1, 9]]  # the ragged batch


def demo_model(arch: str):
    """The original's tiny random model of ``arch`` (examples/serve_hf.py),
    built offline from ``torch.manual_seed(0)``."""
    import torch
    import transformers

    torch.manual_seed(0)
    dims = dict(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=256, attn_implementation="eager")
    if arch == "qwen2":
        # Qwen2-style: q/k/v projection biases.
        return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**dims))
    if arch == "qwen25":
        # Qwen2.5-long style: Qwen2 biases + YaRN rope scaling.
        return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
            **dims, rope_scaling={
                "rope_type": "yarn", "factor": 4.0,
                "original_max_position_embeddings": 64}))
    if arch == "mixtral":
        # Mixtral-style: SwiGLU top-2 MoE FFN (dropless conversion).
        return transformers.MixtralForCausalLM(transformers.MixtralConfig(
            **dims, num_local_experts=4, num_experts_per_tok=2))
    if arch == "gemma":
        # Gemma-style: GeGLU, (1+w) norms, sqrt(d)-scaled embeddings.
        return transformers.GemmaForCausalLM(transformers.GemmaConfig(
            **dims, head_dim=32))
    if arch == "phi3":
        # Phi-3-style: fused qkv_proj + gate_up_proj, split at conversion
        # (Phi3Config's default pad_token_id needs vocab > 32000).
        return transformers.Phi3ForCausalLM(transformers.Phi3Config(
            **{**dims, "vocab_size": 33000}))
    if arch == "phi35":
        # Phi-3.5/128k style: Phi-3 projections + LongRoPE per-dim
        # short/long factor lists.
        half = (dims["hidden_size"] // dims["num_attention_heads"]) // 2
        return transformers.Phi3ForCausalLM(transformers.Phi3Config(
            **{**dims, "vocab_size": 33000},
            original_max_position_embeddings=64,
            rope_scaling={
                "type": "longrope",
                "short_factor": [1.0 + 0.05 * i for i in range(half)],
                "long_factor": [2.0 + 0.1 * i for i in range(half)]}))
    extra = {}
    if arch == "llama31":
        # Llama-3.1-style: head_dim pinned independently of
        # hidden_size // n_heads, banded llama3 rope scaling.
        extra = dict(head_dim=32, rope_scaling={
            "rope_type": "llama3", "factor": 4.0,
            "low_freq_factor": 1.0, "high_freq_factor": 2.0,
            "original_max_position_embeddings": 64})
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **dims, **extra))


def serve(params, cfg, *, max_new: int = 12, temperature: float = 0.0,
          quantize: str = "none", hf=None) -> dict:
    """The ragged batch, the eos-fill run and, given the transformers model
    ``hf`` in the controlled configuration (greedy, float32, unquantized),
    the token-exact cross-check of row 0.  Returns the tokens (``new``,
    ``filled``) and ``match`` (None when not checked)."""
    import torch

    from starway_tpu_torch.models.generate import generate

    dev = params["embed"].device
    extras = "".join(
        [f" hd={cfg.head_dim}(override)" if cfg.head_dim_override else "",
         f" rope_scaling={cfg.rope_scaling[0]}" if cfg.rope_scaling else "",
         " (W8A16 int8 weights)" if quantize == "int8" else ""])
    print(f"converted: {cfg.n_layers}L d={cfg.d_model} "
          f"Hq={cfg.n_heads}/Hkv={cfg.n_kv_heads} V={cfg.vocab_size}"
          f"{extras}")

    # A ragged batch: three "requests" of different lengths, one call.
    P = max(map(len, ROWS))
    padded = torch.tensor([r + [0] * (P - len(r)) for r in ROWS],
                          device=dev)
    lengths = torch.tensor([len(r) for r in ROWS], device=dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    new = generate(params, cfg, padded, max_new, prompt_lengths=lengths,
                   temperature=temperature, generator=gen()).cpu()
    for b, r in enumerate(ROWS):
        print(f"request {b} ({len(r)} tokens) -> {new[b].tolist()}")

    # eos-fill: force the first continuation token as the terminator; that
    # row comes back all-eos while the others are untouched.  Same
    # sampling settings as the run above, so the first token recurs.
    eos = int(new[0][0])
    filled = generate(params, cfg, padded, max_new, prompt_lengths=lengths,
                      eos_id=eos, temperature=temperature,
                      generator=gen()).cpu()
    print(f"with eos_id={eos}: request 0 -> {filled[0].tolist()}")

    # Token-exact cross-check only in the controlled configuration: greedy
    # + the float32 demo model + full-precision weights.  (A real --model
    # runs bf16 here vs float32 in transformers, quantized weights are a
    # slightly different model by design, and transformers may stop early
    # at its eos: tokens can legitimately differ.)
    match = None
    if hf is not None and temperature == 0.0 and quantize == "none":
        with torch.no_grad():
            ref = hf.generate(torch.tensor([ROWS[0]]), max_new_tokens=max_new,
                              do_sample=False, pad_token_id=0).cpu()
        match = new[0].tolist() == ref[0, len(ROWS[0]):].tolist()
        print("row 0 matches transformers.generate:", match)
    return {"new": new.numpy(), "filled": filled.numpy(), "match": match}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None,
                    help="local HF checkpoint dir (default: tiny random "
                         "model)")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quantize", choices=["none", "int8"], default="none",
                    help="int8 = W8A16 weight-only serving tree "
                         "(half the weight memory; see ops/quantize.py)")
    ap.add_argument("--arch", choices=ARCHS, default="llama",
                    help="demo-model flavour: llama31 = decoupled head_dim "
                         "+ llama3 rope scaling; qwen2 = q/k/v projection "
                         "biases; mixtral = SwiGLU top-2 MoE experts; "
                         "gemma = GeGLU + (1+w) norms + scaled embeddings; "
                         "phi3 = fused qkv/gate_up projections, "
                         "qwen25 = Qwen2 biases + YaRN rope, "
                         "phi35 = Phi-3 projections + LongRoPE")
    ap.add_argument("--device", default="cuda",
                    help="where the converted model runs (default: the card)")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    # transformers on its PyTorch backend only: where TensorFlow is
    # installed, transformers would import it, and TensorFlow imports JAX.
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    import transformers

    from starway_tpu_torch.models import config_from_hf, params_from_hf

    if args.model:
        # Auto class: real checkpoints of every served family load through
        # their own architecture; local files only, never a download.
        hf = transformers.AutoModelForCausalLM.from_pretrained(
            args.model, local_files_only=True)
    else:
        hf = demo_model(args.arch)
    hf.eval()

    cfg = config_from_hf(hf.config, dtype="float32" if args.model is None
                         else "bfloat16")
    params = params_from_hf(hf, cfg, quantize=args.quantize,
                            device=args.device)
    with torch.no_grad():
        res = serve(params, cfg, max_new=args.max_new,
                    temperature=args.temperature, quantize=args.quantize,
                    hf=hf if args.model is None else None)
    if res["match"] is False:
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
