"""Pipeline-parallel Llama training on the PyTorch port: plain 1F1B and
interleaved chunks.

Trains the same tiny model two ways over a pp (x dp) mesh of the port
(starway_tpu_torch.parallel.make_mesh: every slot in this process) and
shows that the schedules agree (the same math, another fill cost):

* plain 1F1B: one stage a slot (parallel/pipeline.py);
* interleaved: 2 virtual chunks a slot (parallel/interleaved.py), whose
  fill is (V-1)(S-2) ticks shorter.

Runs on the card by default, on the CPU with ``--device cpu``.

Usage:  python examples/torch/pp_training.py [--steps 4] [--dp]
            [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--dp", action="store_true",
                    help="compose with data parallelism (pp2 x dp2 mesh)")
    ap.add_argument("--device", default="cuda",
                    help="where the slots live (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from starway_tpu_torch.models import (LlamaConfig, init_params,
                                          make_pp_llama_train,
                                          pp_split_params, ppv_split_params,
                                          shard_pp_params, shard_ppv_params)
    from starway_tpu_torch.models.llama import apply_updates
    from starway_tpu_torch.parallel import make_mesh
    from starway_tpu_torch.utils.optim import adamw

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = LlamaConfig.preset("debug", n_layers=4, d_model=64, n_heads=4,
                             n_kv_heads=2, d_ff=96, vocab_size=256)
    params = init_params(cfg, seed=0, device=args.device)
    axes = {"pp": 2, "dp": 2} if args.dp else {"pp": 2}
    mesh = make_mesh(axes, device=args.device)
    dp_axis = "dp" if args.dp else None
    batch = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 17)), device=args.device).long()

    loss_by_schedule = {}
    for name, n_chunks in (("plain 1F1B", 1), ("interleaved x2", 2)):
        if n_chunks == 1:
            pp = shard_pp_params(pp_split_params(params, 2), mesh)
        else:
            pp = shard_ppv_params(ppv_split_params(params, 2, 2), mesh)
        step = make_pp_llama_train(mesh, cfg, n_micro=4, n_chunks=n_chunks,
                                   dp_axis=dp_axis)
        tx = adamw(3e-3)
        opt = tx.init(pp)
        losses = []
        for _ in range(args.steps):
            loss, grads = step(pp, batch)
            pp, opt = apply_updates(tx, pp, opt, grads)
            losses.append(float(loss))
        print(f"{name:15s} mesh={axes}: losses "
              f"{[round(l, 4) for l in losses]}")
        assert all(np.isfinite(losses))
        if args.steps >= 2:
            assert losses[-1] < losses[0]
        loss_by_schedule[name] = losses

    a, b = loss_by_schedule.values()
    np.testing.assert_allclose(a, b, rtol=1e-5)  # same math, pinned
    print("both schedules train with matching losses: the same math")


if __name__ == "__main__":
    main()
