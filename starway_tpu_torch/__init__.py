"""starway_tpu_torch: the Llama serving stack on PyTorch and CUDA.

``models`` holds the model, KV-cache generation, the continuous-batching
servers and the training step; ``ops`` the attention and quantization
functions and the hand-written CUDA kernels (``csrc/``), each beside its
plain PyTorch version; ``parallel`` the mesh and sequence-parallel ring
attention.  Entry points run on ``cuda`` unless given
``device="cpu"``; kernels build with ``nvcc`` on first use.
"""
