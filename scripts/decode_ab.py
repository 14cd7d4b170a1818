"""Serving speed of two checkouts of the port on one card, alternated.

    python3 scripts/decode_ab.py PARENT_DIR CHANGE_DIR

Each directory is a checkout of the repo (``git archive`` unpacked).  The
two run as parent, change, change, parent, each in a process of its own
that imports that checkout's ``starway_tpu_torch`` and ``chip_smoke.py``:
it builds the kernels, serves ``chip_smoke.py`` phase 4's twelve requests
on llama3-8b widths (a warm run, then a measured one) and times
``decode_step`` at B=8, pos 1000, 20 steps at a time: with a
synchronization after them (step ms) and without (the host's enqueue
ms).  One JSON line each, then the card's name and power limit.  Needs
CUDA; compare the two only within one run of this script.
"""

import json
import subprocess
import sys
import time


def one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    torch.set_grad_enabled(False)
    import chip_smoke as cs
    from starway_tpu_torch.models import LlamaConfig, init_params
    from starway_tpu_torch.models.generate import decode_step, init_cache
    from starway_tpu_torch.ops import _build

    _build.build()
    _build.library()
    dev = torch.device("cuda:0")
    cfg = LlamaConfig.preset("llama3-8b")
    reqs = cs.make_requests(cfg)
    params = init_params(cfg, cs.SEED, device=dev)
    cs.serve(params, cfg, reqs)
    st = cs.serve(params, cfg, reqs)[1]
    cache = init_cache(cfg, 8, 2048, device=dev)
    tok = torch.zeros(8, dtype=torch.long, device=dev)
    pos = torch.full((8,), 1000, dtype=torch.int32, device=dev)
    for _ in range(5):
        decode_step(params, cache, tok, pos, cfg)
    step_ms, enqueue_ms = [], []
    for out, wait in ((step_ms, True), (enqueue_ms, False)):
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                decode_step(params, cache, tok, pos, cfg)
            if wait:
                torch.cuda.synchronize()
            out.append((time.perf_counter() - t) / 20 * 1e3)
            torch.cuda.synchronize()
    return dict(tree=tree, tokens_per_s=st["tokens_per_s"],
                median_chunk_ms=st["median_chunk_ms"],
                admission_s=st["admission_s"], decode_step_ms=sorted(step_ms),
                enqueue_ms=sorted(enqueue_ms))


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("AB", json.dumps(one(sys.argv[2])), flush=True)
        return 0
    parent, change = sys.argv[1:3]
    failed = False
    for tree in (parent, change, change, parent):
        out = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        lines = [l for l in out.stdout.splitlines() if l.startswith("AB ")]
        if lines:
            print(lines[-1], flush=True)
        else:
            failed = True
            print(f"FAILED {tree}: {out.stderr[-2000:]}", flush=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
