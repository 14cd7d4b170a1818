"""Continuous batching on the PyTorch port: a request stream through a
fixed slot set.

Twin of examples/serve_continuous.py.  Requests arrive over time (here:
submitted between decode chunks), cohabit the slot batch, finish at
different lengths, and free their slot for the next arrival at once.
Greedy outputs are bit-identical to one-at-a-time ``generate()`` calls;
the demo cross-checks one request against that oracle, then shows prefix
caching (``register_prefix``).

The tiny debug model (float32, head_dim 16) runs on the card by default:
the decode kernel (csrc/decode_attention.cu) and the flash forward
(csrc/flash_fwd.cu) serve it; ``--device cpu`` runs their plain versions.
``serve`` takes the parameter tree, so any tree of the debug config (a
converted checkpoint, the JAX package's carried across) serves the same
stream.

Usage:  python examples/torch/serve_continuous.py [--requests 12]
            [--slots 3] [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def serve(params, cfg, *, requests: int = 12, slots: int = 3, chunk: int = 8,
          temperature: float = 0.0) -> dict:
    """The demo on ``params``: returns the stream (``reqs``, ``done``)
    and, greedy, the prefix part (``prefix``, ``suffixes``,
    ``prefix_done``)."""
    import numpy as np
    import torch

    from starway_tpu_torch.models import SlotServer
    from starway_tpu_torch.models.generate import generate

    srv = SlotServer(params, cfg, n_slots=slots, max_len=96, chunk=chunk,
                     temperature=temperature, seed=7)

    rng = np.random.default_rng(0)
    reqs = {}
    t0 = time.time()
    done = {}
    # Arrivals interleave with decode chunks: the continuous part.
    for i in range(requests):
        prompt = list(rng.integers(1, cfg.vocab_size,
                                   int(rng.integers(2, 16))))
        max_new = int(rng.integers(4, 12))
        reqs[srv.submit(prompt, max_new)] = (prompt, max_new)
        done.update(srv.step())
    done.update(srv.run())
    dt = time.time() - t0

    total = sum(len(v) for v in done.values())
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s wall) through {slots} slots")
    for rid in sorted(done)[:4]:
        print(f"  req {rid}: +{len(done[rid])} tokens {done[rid].tolist()}")
    out = {"reqs": reqs, "done": done, "tokens": total, "seconds": dt}

    if temperature == 0.0 and done:
        rid0 = sorted(done)[0]
        prompt, max_new = reqs[rid0]
        solo = generate(params, cfg, torch.tensor([prompt]), max_new)
        want = solo[0, len(prompt):].cpu().numpy()
        assert (done[rid0] == want).all(), "continuous != standalone greedy!"
        print(f"  req {rid0} cross-checked against standalone generate(): OK")

    # Prefix caching: a shared "system prompt" prefilled ONCE; requests
    # submit only their suffix and still generate exactly what
    # generate(prefix + suffix) would.
    if temperature == 0.0:
        system = list(rng.integers(1, cfg.vocab_size, 11))
        pid = srv.register_prefix(system)
        suffixes = [list(rng.integers(1, cfg.vocab_size, n))
                    for n in (3, 5, 2)]
        prids = [srv.submit(s, 6, prefix=pid) for s in suffixes]
        pdone = srv.run()
        for prid, suffix in zip(prids, suffixes):
            solo = generate(params, cfg, torch.tensor([system + suffix]), 6)
            want = solo[0, len(system) + len(suffix):].cpu().numpy()
            assert (pdone[prid] == want).all(), "prefix != full-prompt!"
        print(f"  prefix caching: {len(prids)} suffix-only requests over "
              f"one {len(system)}-token cached prefix, all match "
              f"generate(prefix + suffix)")
        out.update(prefix=system, suffixes=suffixes,
                   prefix_done=[pdone[p] for p in prids])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from starway_tpu_torch.models import LlamaConfig, init_params

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = LlamaConfig.preset("debug")
    params = init_params(cfg, seed=0, device=args.device)
    with torch.no_grad():
        return serve(params, cfg, requests=args.requests, slots=args.slots,
                     chunk=args.chunk, temperature=args.temperature)


if __name__ == "__main__":
    main()
