"""Mesh addressing and multi-process bootstrap.

An endpoint's identity is a worker-address blob moved out of band.  This
module enriches it with *mesh coordinates*: which process, which devices,
where in the logical mesh -- peers resolve to mesh coordinates rather
than network addresses.

Two layers:

* :class:`MeshAddress` -- the serialized identity: host contact info plus
  ``process_index``, device kind/count and optional logical coords.  This
  is what ``listen_address()`` blobs become when minted through
  :func:`export_mesh_address`; plain blobs still parse (fields default).
  Its wire keys are the JAX package's, ``"fabric": "starway-tpu"``
  included, so either package parses the other's blobs.
* :func:`bootstrap_distributed` -- a thin gate over
  ``torch.distributed.init_process_group``: it joins this process to the
  job's process group (NCCL when every rank has a CUDA device, gloo
  otherwise) so cross-process collectives work; the P2P layer then uses
  host TCP for control and the device plane for data.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MeshAddress:
    worker_id: str
    host: str
    port: int
    process_index: int = 0
    device_kind: str = ""
    device_count: int = 0
    coords: Optional[tuple] = None  # logical mesh coords of this worker
    mesh_shape: Optional[dict] = None  # {"dp": 2, "tp": 4}

    def to_bytes(self) -> bytes:
        d = dataclasses.asdict(self)
        d["fabric"] = "starway-tpu"
        if d["coords"] is not None:
            d["coords"] = list(d["coords"])
        return json.dumps(d).encode()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "MeshAddress":
        info = json.loads(bytes(blob).decode())
        coords = info.get("coords")
        return cls(
            worker_id=info.get("worker_id", ""),
            host=info.get("host", "127.0.0.1"),
            port=int(info.get("port", 0)),
            process_index=int(info.get("process_index", 0)),
            device_kind=info.get("device_kind", ""),
            device_count=int(info.get("device_count", 0)),
            coords=tuple(coords) if coords is not None else None,
            mesh_shape=info.get("mesh_shape"),
        )


def export_mesh_address(server, *, coords: Optional[Sequence[int]] = None,
                        mesh_shape: Optional[dict] = None) -> bytes:
    """Augment a Server's worker-address blob with local device/mesh info.

    ``process_index`` is this process's rank when ``torch.distributed`` is
    initialised, else 0; ``device_kind`` and ``device_count`` describe the
    CUDA devices this process sees ("" and 0 without one).  The result
    still works with ``Client.aconnect_address`` (the extra keys are
    ignored by the bootstrap path) while letting mesh-aware peers route by
    coordinates."""
    import torch
    import torch.distributed as dist

    info = dict(json.loads(server.get_worker_address().decode()))
    info["process_index"] = (dist.get_rank() if dist.is_available()
                             and dist.is_initialized() else 0)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info["device_kind"] = torch.cuda.get_device_name(0) if count else ""
    info["device_count"] = count
    if coords is not None:
        info["coords"] = list(coords)
    if mesh_shape is not None:
        info["mesh_shape"] = dict(mesh_shape)
    return json.dumps(info).encode()


def parse_mesh_address(blob: bytes) -> MeshAddress:
    return MeshAddress.from_bytes(blob)


def bootstrap_distributed(coordinator_address: str, num_processes: int,
                          process_id: int) -> str:
    """Join this process to the job's ``torch.distributed`` process group.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    process 0, which hosts the rendezvous store.  The ranks first agree
    through that store whether every one of them has a CUDA device: NCCL
    then, each rank on device ``process_id % device_count``; gloo
    otherwise.  Returns the backend.  Call once per process; raises
    RuntimeError where ``torch.distributed`` is unavailable or already
    initialised."""
    import datetime

    import torch
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "torch build")
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialised")
    addr = coordinator_address.removeprefix("tcp://")
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be host:port, got "
                         f"{coordinator_address!r}")
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0,
                          timeout=datetime.timedelta(seconds=300))
    has_card = torch.cuda.is_available()
    store.set(f"starway/cuda/{process_id}", "1" if has_card else "0")
    every_card = all(store.get(f"starway/cuda/{i}") == b"1"
                     for i in range(num_processes))
    backend = "nccl" if every_card else "gloo"
    if every_card:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    return backend
