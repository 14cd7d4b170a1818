"""A served model BEHIND the transport, on the PyTorch port.

Twin of examples/serve_remote.py.  One process runs a SlotServer
(continuous batching) bridged onto a starway_tpu_torch Server; requests
arrive as tagged messages, admission interleaves them into the running
batch, and each request's tokens stream back per decode chunk over its
own connection (models/remote_serving.py).  Three client sessions submit
concurrently, print their streams as chunks arrive, and every greedy
result is cross-checked against standalone ``generate()``.

The tiny debug model (float32, head_dim 16) runs on the card by default:
the decode kernel (csrc/decode_attention.cu) and the flash forward
(csrc/flash_fwd.cu) serve it; ``--device cpu`` runs their plain versions.
``serve_remote`` takes the parameter tree.  The bridge listens on port 0
and reads its port back, so several runs (parallel test workers) can
share a host.

Run:  python examples/torch/serve_remote.py          (in-process fast path)
      STARWAY_TLS=tcp python examples/torch/serve_remote.py   (real sockets)
      STARWAY_NATIVE=1 STARWAY_TLS=tcp python examples/torch/serve_remote.py
      (each with --device cpu to run on the CPU)
"""

import argparse
import asyncio
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

REQUESTS = [(5, 12), (9, 6), (3, 9), (7, 4), (4, 10)]  # (prompt, budget)


async def serve_remote(params, cfg) -> dict:
    """The demo on ``params``: returns the requests and each stream's
    tokens (``reqs``, ``outs``) and the stream chunks (``chunks``)."""
    import numpy as np
    import torch

    from starway_tpu_torch.models import SlotServer
    from starway_tpu_torch.models.generate import generate
    from starway_tpu_torch.models.remote_serving import (
        RemoteGenerateSession, RemoteSlotServer)

    slot = SlotServer(params, cfg, n_slots=2, max_len=64, chunk=4)
    bridge = RemoteSlotServer(slot)
    bridge.server.listen("127.0.0.1", 0)
    port = json.loads(bridge.server.get_worker_address())["port"]
    serve_task = asyncio.create_task(bridge.serve())

    rng = np.random.default_rng(0)
    reqs = [(list(map(int, rng.integers(1, cfg.vocab_size, n))), m)
            for n, m in REQUESTS]

    sessions = [await RemoteGenerateSession.aconnect("127.0.0.1", port)
                for _ in range(3)]
    print(f"3 sessions connected (client ids "
          f"{[s.client_id for s in sessions]}); "
          f"{len(reqs)} requests over 2 slots")
    streams = {}

    async def one(i, prompt, max_new):
        chunks = []
        out = await sessions[i % 3].generate(
            prompt, max_new, on_tokens=lambda c: chunks.append(list(c)))
        print(f"  req {i}: {len(out)} tokens in {len(chunks)} stream "
              f"chunks {chunks}")
        streams[i] = chunks
        return out

    outs = await asyncio.gather(*(one(i, p, m)
                                  for i, (p, m) in enumerate(reqs)))

    bridge.stop()
    await serve_task
    for s in sessions:
        await s.aclose()
    await bridge.aclose()

    for i, ((prompt, max_new), got) in enumerate(zip(reqs, outs)):
        want = generate(params, cfg, torch.tensor([prompt]),
                        max_new)[0, len(prompt):].cpu().numpy()
        assert np.array_equal(got, want), f"request {i} diverged"
        assert [t for c in streams[i] for t in c] == list(map(int, got)), (
            f"request {i}: the stream chunks do not add up to its tokens")
    print(f"all {len(reqs)} streams cross-checked against standalone "
          f"generate(): OK")
    return {"reqs": reqs, "outs": [np.asarray(o) for o in outs],
            "chunks": [streams[i] for i in range(len(reqs))]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
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
        return asyncio.run(serve_remote(params, cfg))


if __name__ == "__main__":
    main()
