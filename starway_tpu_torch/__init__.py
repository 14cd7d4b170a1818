"""starway_tpu_torch: the Llama serving stack on PyTorch and CUDA.

``models`` holds the model, KV-cache generation and the continuous-batching
``SlotServer``; ``ops`` the attention and quantization functions and the
hand-written CUDA kernels (``csrc/``) of the serving path, each beside its
plain PyTorch version.  Entry points run on ``cuda`` unless given
``device="cpu"``; kernels build with ``nvcc`` on first use.
"""
