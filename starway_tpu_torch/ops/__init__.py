"""Attention, quantization and the hand-written CUDA kernels of the port:
``decode.decode_attention``, ``paged.paged_decode_attention``,
``flash.flash_forward``, ``flash.flash_backward_delta``,
``flash.flash_backward_dkv`` / ``flash.flash_backward_dq``, the ring
step's ``flash.flash_partial`` and ``flash.flash_partial_bwd``, and
``gemv.int8_matmul``, each beside its plain PyTorch version.  ``collectives`` rotates sequence shards around a
mesh axis (parallel/sharding.py).

Importing these modules builds nothing; the kernels compile on first use
(``_build.library``)."""


def _wrappers() -> dict:
    from .decode import decode_attention
    from .flash import (flash_backward_delta, flash_backward_dkv,
                        flash_backward_dq, flash_forward, flash_partial,
                        flash_partial_bwd)
    from .gemv import int8_matmul
    from .paged import paged_decode_attention

    return {"decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "flash_forward": flash_forward,
            "flash_backward_delta": flash_backward_delta,
            "flash_backward_dkv": flash_backward_dkv,
            "flash_backward_dq": flash_backward_dq,
            "flash_partial": flash_partial,
            "flash_partial_bwd": flash_partial_bwd,
            "int8_matmul": int8_matmul}


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset; for
    the wrappers with a route on Hopper's wgmma, also those launches under
    "<name>/wgmma" ("decode_attention/tma": csrc/decode_tma.cu's)."""
    counts = {}
    for name, fn in _wrappers().items():
        counts[name] = fn.launches
        for route in ("wgmma", "tma"):
            if hasattr(fn, f"{route}_launches"):
                counts[f"{name}/{route}"] = getattr(fn, f"{route}_launches")
    return counts


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        for route in ("wgmma", "tma"):
            if hasattr(fn, f"{route}_launches"):
                setattr(fn, f"{route}_launches", 0)
        if hasattr(fn, "regime_launches"):  # int8_matmul, by regime
            fn.regime_launches = dict.fromkeys(fn.regime_launches, 0)
