"""Attention, quantization and the hand-written CUDA kernels of the port:
``decode.decode_attention``, ``flash.flash_forward``,
``flash.flash_backward_dkv`` / ``flash.flash_backward_dq`` and
``gemv.int8_matmul``, each beside its plain PyTorch version.

Importing these modules builds nothing; the kernels compile on first use
(``_build.library``)."""


def _wrappers() -> dict:
    from .decode import decode_attention
    from .flash import flash_backward_dkv, flash_backward_dq, flash_forward
    from .gemv import int8_matmul

    return {"decode_attention": decode_attention,
            "flash_forward": flash_forward,
            "flash_backward_dkv": flash_backward_dkv,
            "flash_backward_dq": flash_backward_dq,
            "int8_matmul": int8_matmul}


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
