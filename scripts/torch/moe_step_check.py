"""How far apart `chip_smoke.py` phase 23's MoE step lands under attention
implementations that all hold the attention's own tolerances: Mixtral-8x7B
widths, one layer, top-2 of 8 experts at capacity factor 1.25, batch
[2, 2049], AdamW at `chip_smoke.LR_TRAIN`, the MoE through
`make_sharded_moe` over {"dp": 2, "ep": 2, "tp": 2} as the phase runs it.

Prints one JSON line: the loss and the loss after one AdamW step of the
unsharded tree with the flash kernels (as planned, and at 64-row q tiles
where the kernel has another height) and with the plain attention
(`flash_forward_reference`), and of the sharded tree with the flash
kernels; then each after-step loss's gap to the sharded step's, the
quantity phase 23 holds to `MESH_AFTER_REL_TOL`.  Top-2 routing with
token drops is discontinuous, so these gaps measure how much of that limit
the attention's rounding alone uses.

    python3 scripts/torch/moe_step_check.py

Needs a CUDA card (~80 GB of device memory free).
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("moe_step_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from starway_tpu_torch.models import init_params, param_specs
    from starway_tpu_torch.models.moe import make_sharded_moe
    from starway_tpu_torch.ops import flash
    from starway_tpu_torch.parallel import make_mesh, shard_tree
    from starway_tpu_torch.utils.cuda_timing import card_name

    dev = torch.device("cuda:0")
    cfg = cs.mixtral_config(n_layers=cs.MESH_MOE_LAYERS,
                            moe_capacity_factor=1.25, remat=True,
                            remat_policy="dots")
    params = init_params(cfg, cs.SEED + 312, device=dev)
    batch = cs.train_batch(cfg, cs.MESH_BATCH["batch"],
                           cs.MESH_BATCH["seq"] + 1, cs.SEED + 313, dev)
    mesh = make_mesh({"dp": 2, "ep": 2, "tp": 2}, device=dev)
    moe_fn = make_sharded_moe(mesh, k=cfg.moe_top_k, swiglu=True,
                              capacity_factor=cfg.moe_capacity_factor)
    out = {"card": card_name()}
    planned = flash.fwd_q_rows
    for label, attn, rows in (("flash", None, None),
                              ("flash_64_rows", None, 64),
                              ("plain", cs.plain_attn, None)):
        flash.fwd_q_rows = ((lambda *a, **k: rows) if rows
                            else planned)
        w = cs.unsharded_step(cfg, params, batch, attn_fn=attn,
                              moe_fn=moe_fn)
        out[label] = dict(loss=w["loss"], after=w["after"])
        del w
        torch.cuda.empty_cache()
    flash.fwd_q_rows = planned
    sh = shard_tree(params, mesh, param_specs(cfg))
    loss, _ms, _traced, after = cs.sharded_step(cfg, sh, batch,
                                                moe_fn=moe_fn)
    out["sharded"] = dict(loss=loss, after=after)
    out["after_gap_to_sharded"] = {
        k: abs(out[k]["after"] - after) / abs(out[k]["after"])
        for k in ("flash", "flash_64_rows", "plain")}
    out["limit"] = cs.MESH_AFTER_REL_TOL
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
