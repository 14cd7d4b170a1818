"""Helpers shared by the tests that hold the PyTorch port
(starway_tpu_torch) against the JAX package: arrays cross between the two
as numpy, on the CPU."""

import numpy as np
import torch

from starway_tpu_torch.models.convert import params_from_numpy

# The shapes here are tiny: one intra-op thread keeps these tests from
# oversubscribing the cores that the suite's parallel workers share with
# the timing-sensitive transport tests.
torch.set_num_threads(1)


def to_torch(x) -> torch.Tensor:
    """A JAX or numpy array as a CPU torch tensor (bfloat16 bit for bit)."""
    return params_from_numpy(np.asarray(x), device="cpu")


def to_numpy(t) -> np.ndarray:
    """A torch tensor as float32/int numpy (bfloat16 widens exactly)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def tree_to_numpy(tree):
    """A JAX parameter tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def ring_worker(rank: int, world: int, port: int, folder: str) -> None:
    """One process of a ``torch.distributed`` (gloo) ring-attention run:
    reads ``in.npz`` from ``folder`` (global q, k, v and the output
    cotangent vd, and the zigzag-ordered copies), runs ring attention and
    zigzag ring attention over its slice on a mesh ``{"sp": n}`` split
    over ``world`` processes, and writes the output and the gradients of
    its slice to ``out<rank>.npz``."""
    import torch.distributed as dist

    from starway_tpu_torch.parallel import (make_mesh, ring_attention,
                                            zigzag_ring_attention)

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        data = np.load(f"{folder}/in.npz")
        n = int(data["n"])
        mesh = make_mesh({"sp": n}, device="cpu", group=dist.group.WORLD)
        out = {}
        for name, fn in (("ring", ring_attention),
                         ("zigzag", zigzag_ring_attention)):
            pre = "" if name == "ring" else "z"
            s = data[pre + "q"].shape[2] // world
            cut = slice(rank * s, (rank + 1) * s)
            leaves = [torch.from_numpy(data[pre + x][:, :, cut].copy())
                      .requires_grad_() for x in ("q", "k", "v")]
            o = fn(*leaves, mesh, "sp")
            (o * torch.from_numpy(data[pre + "vd"][:, :, cut].copy())
             ).sum().backward()
            out[name] = o.detach().numpy()
            for x, leaf in zip("qkv", leaves):
                out[f"{name}_d{x}"] = leaf.grad.numpy()
        np.savez(f"{folder}/out{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
