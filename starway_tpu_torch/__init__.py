"""starway_tpu_torch: starway-tpu on PyTorch and CUDA.

The transport: ``Server``/``Client`` with ``asend``/``arecv``/``aflush`` on
host buffers and on ``torch.Tensor`` device buffers (``api``, the host
runtime in ``core`` with the C++ engine through ``core/native.py``, and the
device plane in ``device``); ``mesh`` mints worker-address blobs with mesh
coordinates and bootstraps ``torch.distributed``.  ``models`` holds the
Llama model, KV-cache generation, the continuous-batching servers (also
served over the transport) and the training step (with a DP gradient
exchange over the transport); ``ops`` the attention and quantization
functions and the hand-written CUDA kernels (``csrc/``), each beside its
plain PyTorch version; ``parallel`` the mesh, sequence-parallel ring
attention and the pytree exchange at a DP boundary.  Entry points run on ``cuda`` unless
given ``device="cpu"``; kernels build with ``nvcc`` on first use.

>>> import starway_tpu_torch as sw
>>> server = sw.Server(); server.listen("127.0.0.1", 13337)
>>> client = sw.Client(); await client.aconnect("127.0.0.1", 13337)
>>> await client.asend(torch.arange(16, device="cuda"), tag=7)
"""

from __future__ import annotations

from .api import Client, Server
from .core.endpoint import ServerEndpoint
from .device import DeviceBuffer
from .mesh import (MeshAddress, bootstrap_distributed, export_mesh_address,
                   parse_mesh_address)


def check_sys_libs() -> str:
    """``"native"`` when the C++ engine would serve new workers, else
    ``"python"`` (the pure-Python engine)."""
    from .api import _use_native_engine

    return "native" if _use_native_engine() else "python"


__all__ = ["Server", "Client", "ServerEndpoint", "DeviceBuffer",
           "MeshAddress", "bootstrap_distributed", "check_sys_libs",
           "export_mesh_address", "parse_mesh_address"]
