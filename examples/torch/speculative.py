"""Speculative decoding on the PyTorch port: draft-proposed tokens,
target-verified.

Twin of examples/speculative.py.  A cheap draft model proposes ``gamma -
1`` tokens; the target checks the whole chunk in ONE forward and keeps
the accepted prefix (plus one corrected or bonus token), so the target's
KV cache streams once per accepted run instead of once per token.
Greedy output matches plain ``generate()`` token for token: the draft
changes how fast tokens appear.  Three drafters (a shallow random model,
the target's own first layer, the target itself) and prompt-lookup, each
with its acceptance line.

The tiny debug model (float32, head_dim 16) runs on the card by default:
the verify chunk attends through the decode kernel at C = gamma
(csrc/decode_attention.cu), the prompts through the flash forward
(csrc/flash_fwd.cu); ``--device cpu`` runs their plain versions.
``decode`` takes the parameter trees, so the JAX package's, carried
across, decode the same way.

Usage:  python examples/torch/speculative.py [--gamma 4] [--max-new 24]
            [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def decode(params, cfg, dparams, dcfg, *, gamma: int = 4,
           max_new: int = 24) -> dict:
    """The demo on the target tree ``params`` and the shallow draft
    ``dparams``: returns ``{name: (tokens, stats)}`` and the reference
    ``generate()`` tokens under ``"generate"``."""
    import numpy as np
    import torch

    from starway_tpu_torch.models.generate import generate
    from starway_tpu_torch.models.speculative import (draft_from_truncation,
                                                      generate_lookup,
                                                      generate_speculative)

    dev = params["embed"].device
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 8), dtype=np.int32), device=dev).long()

    ref = generate(params, cfg, prompt, max_new)
    results = {"generate": ref.cpu().numpy()}

    def report(name, out, stats):
        same = bool(torch.equal(out, ref))
        steps = stats["macro_steps"].cpu().numpy().astype(np.float64)
        acc = stats["accepted"].cpu().numpy().astype(np.float64)
        rate = acc.sum() / max(steps.sum() * (gamma - 1), 1)
        amort = (acc.sum() + steps.sum()) / max(steps.sum(), 1)
        print(f"{name}: bit-identical to generate(): {same}; "
              f"acceptance {rate:.0%}, {amort:.2f} tokens/target-pass "
              f"(gamma={gamma})")
        assert same, "greedy speculative output diverged from generate()"
        results[name] = (out.cpu().numpy(),
                         {k: v.cpu().numpy() for k, v in stats.items()})

    # A FREE draft: the target's own first layer (no second checkpoint).
    tparams, tcfg = draft_from_truncation(params, cfg, 1)
    for name, dp, dc in (("shallow draft (1L, random)", dparams, dcfg),
                         ("truncation draft (target[:1])", tparams, tcfg),
                         ("self-draft (acceptance ~1)", params, cfg)):
        out, stats = generate_speculative(
            params, cfg, dp, dc, prompt, max_new, gamma=gamma,
            return_stats=True)
        report(name, out, stats)
    # Prompt-lookup: no draft model at all; proposals copy the latest
    # matching n-gram continuation from the sequence's own history.
    out, stats = generate_lookup(params, cfg, prompt, max_new, gamma=gamma,
                                 ngram=2, return_stats=True)
    report("prompt-lookup (ngram=2, draft-free)", out, stats)
    print("ok")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="where the models run (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from starway_tpu_torch.models import LlamaConfig, init_params

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = LlamaConfig.preset("debug")
    dcfg = LlamaConfig.preset("debug", n_layers=1)
    params = init_params(cfg, seed=0, device=args.device)
    dparams = init_params(dcfg, seed=1, device=args.device)
    with torch.no_grad():
        return decode(params, cfg, dparams, dcfg, gamma=args.gamma,
                      max_new=args.max_new)


if __name__ == "__main__":
    main()
