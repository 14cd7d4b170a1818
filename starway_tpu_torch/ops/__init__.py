"""Attention, quantization and the hand-written CUDA kernels of the serving
path: ``decode.decode_attention``, ``flash.flash_forward`` and
``gemv.int8_matmul``, each beside its plain PyTorch version.

Importing these modules builds nothing; the kernels compile on first use
(``_build.library``)."""


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset."""
    from .decode import decode_attention
    from .flash import flash_forward
    from .gemv import int8_matmul

    return {"decode_attention": decode_attention.launches,
            "flash_forward": flash_forward.launches,
            "int8_matmul": int8_matmul.launches}


def reset_launch_counts() -> None:
    from .decode import decode_attention
    from .flash import flash_forward
    from .gemv import int8_matmul

    for fn in (decode_attention, flash_forward, int8_matmul):
        fn.launches = 0
