"""SPMD training tour on the PyTorch port: ZeRO/FSDP and pipeline-parallel
Llama.

Twin of examples/spmd_training.py.  The mesh's slots all sit on one
device (``starway_tpu_torch.parallel.make_mesh``: the card by default,
the CPU with ``--device cpu``), so one card runs every slot at its real
shape.  Three parts:

  1. Trainer in ZeRO mode: params + Adam state sharded 1/N over "fsdp",
     each weight gathered before its use and each gradient
     reduce-scattered (models/sharded.py).
  2. The same ZeRO step assembled from the low-level pieces
     (parallel/fsdp.py ``fsdp_specs`` + ``shard_tree`` +
     ``make_fsdp_train_step``) for custom training loops.
  3. End-to-end pipeline-parallel Llama (models/pp_llama.py): embed +
     1F1B over "pp" + head, every parameter receiving gradients.

On the card every part's forward and backward run the flash kernels
(csrc/flash_fwd.cu, csrc/flash_bwd.cu).  ``tour`` takes the three parts'
parameter trees.

Usage:  python examples/torch/spmd_training.py [--devices 8] [--steps 4]
            [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def config():
    from starway_tpu_torch.models import LlamaConfig

    return LlamaConfig.preset("debug", d_model=64, n_heads=4, n_kv_heads=4,
                              d_ff=128, vocab_size=256, n_layers=4)


def tour(trees, cfg, *, devices: int = 8, steps: int = 4,
         device: str = "cuda") -> dict:
    """The three parts on ``trees`` (one parameter tree each, the
    original's PRNGKey(0), (1) and (2)); returns each part's last loss."""
    import numpy as np
    import torch

    from starway_tpu_torch.models import (make_pp_llama_train,
                                          make_train_step, pp_split_params,
                                          shard_pp_params)
    from starway_tpu_torch.models.llama import apply_updates
    from starway_tpu_torch.models.trainer import Trainer
    from starway_tpu_torch.parallel import (fsdp_specs, make_fsdp_train_step,
                                            make_mesh, shard_tree)
    from starway_tpu_torch.utils.optim import adamw
    from starway_tpu_torch.utils.tree import tree_leaves

    rng = np.random.default_rng(0)
    batch = lambda: torch.as_tensor(  # noqa: E731
        rng.integers(0, cfg.vocab_size, (devices, 33), dtype=np.int32),
        device=device).long()
    losses = {}

    # -- 1. High-level: Trainer in ZeRO mode ------------------------------
    mesh = make_mesh({"fsdp": devices}, device=device)
    trainer = Trainer(cfg, adamw(3e-3), trees[0], mesh=mesh,
                      fsdp_axis="fsdp")
    for _ in range(steps):
        loss = trainer.step_sync(batch())
    emb = trainer.state.params["embed"]
    first = min(emb.shards, key=lambda slot: slot.index)
    shard = tuple(emb.shards[first].shape)
    print(f"[fsdp/Trainer] {steps} steps, loss={loss:.4f}, "
          f"embed shard {shard} of {tuple(emb.shape)}")
    losses["fsdp_trainer"] = float(loss)

    # -- 2. Low-level: the same ZeRO step from parts ----------------------
    params = trees[1]
    tx = adamw(3e-3)
    pspecs = fsdp_specs(params, mesh)
    ospecs = fsdp_specs(tx.init(params), mesh)
    p = shard_tree(params, mesh, pspecs)
    o = shard_tree(tx.init(params), mesh, ospecs)
    step = make_fsdp_train_step(make_train_step(cfg, tx), mesh, pspecs, ospecs)
    for _ in range(steps):
        p, o, loss = step(p, o, batch())
    print(f"[fsdp/manual]  {steps} steps, loss={float(loss):.4f}")
    losses["fsdp_manual"] = float(loss)

    # -- 3. Pipeline-parallel Llama (1F1B, all grads) ---------------------
    # Stage count must divide n_layers; microbatch count must divide the
    # batch: derive both from the slot budget instead of assuming 4/8.
    pp_n = max(d for d in (4, 2, 1) if d <= devices and cfg.n_layers % d == 0)
    n_micro, bsz = 4, 8
    mesh_pp = make_mesh({"pp": pp_n}, device=device)
    pp_params = shard_pp_params(pp_split_params(trees[2], pp_n), mesh_pp)
    pp_step = make_pp_llama_train(mesh_pp, cfg, n_micro=n_micro)
    tx_pp = adamw(3e-3)
    opt_pp = tx_pp.init(pp_params)
    fixed = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (bsz, 33), dtype=np.int32),
        device=device).long()
    for _ in range(steps):
        loss, grads = pp_step(pp_params, fixed)
        for g in tree_leaves(grads):
            assert bool(torch.isfinite(g).all()) and bool(g.ne(0).any()), (
                "a parameter received no gradient")
        pp_params, opt_pp = apply_updates(tx_pp, pp_params, opt_pp, grads)
    print(f"[pp-llama]     {pp_n} stages x {cfg.n_layers // pp_n} layers, "
          f"{steps} steps on one batch, loss={float(loss):.4f}")
    losses["pp"] = float(loss)
    assert all(np.isfinite(list(losses.values())))
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="the mesh's slots (all on --device)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="where the slots live (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from starway_tpu_torch.models import init_params

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        sys.exit("no CUDA device: pass --device cpu to run on the CPU")
    cfg = config()
    trees = [init_params(cfg, seed=s, device=args.device) for s in range(3)]
    return tour(trees, cfg, devices=args.devices, steps=args.steps,
                device=args.device)


if __name__ == "__main__":
    main()
