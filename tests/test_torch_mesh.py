"""Mesh addressing and multi-process bootstrap on the port
(starway_tpu_torch/mesh.py), the twin of tests/test_mesh.py:
``MeshAddress`` blobs round-trip (and cross between the packages with
the same wire keys), ``export_mesh_address`` fills the process index from
``torch.distributed`` and the device fields from ``torch.cuda``, and
``bootstrap_distributed`` assembles a real two-process group (gloo
without a card) whose all-reduce only comes out right if both processes
joined."""

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from starway_tpu_torch import (MeshAddress, Server, bootstrap_distributed,
                               export_mesh_address, parse_mesh_address)


def test_mesh_address_roundtrip():
    addr = MeshAddress(worker_id="w1", host="10.0.0.7", port=1234,
                       process_index=3, device_kind="NVIDIA H100 80GB HBM3",
                       device_count=4, coords=(1, 2),
                       mesh_shape={"dp": 2, "tp": 4})
    back = parse_mesh_address(addr.to_bytes())
    assert back == addr
    assert json.loads(addr.to_bytes())["fabric"] == "starway-tpu"
    plain = parse_mesh_address(b'{"worker_id": "x", "host": "h", "port": 9}')
    assert plain.process_index == 0 and plain.coords is None


def test_mesh_address_crosses_the_packages():
    """One blob format: each package parses the other's bytes to the same
    fields."""
    from starway_tpu.mesh import MeshAddress as JaxMeshAddress
    from starway_tpu.mesh import parse_mesh_address as jax_parse

    kw = dict(worker_id="w2", host="10.0.0.8", port=4321, process_index=1,
              device_kind="kind", device_count=8, coords=(0, 3),
              mesh_shape={"sp": 4})
    assert jax_parse(MeshAddress(**kw).to_bytes()) == JaxMeshAddress(**kw)
    assert parse_mesh_address(JaxMeshAddress(**kw).to_bytes()) == \
        MeshAddress(**kw)
    assert MeshAddress(**kw).to_bytes() == JaxMeshAddress(**kw).to_bytes()


async def test_export_mesh_address_from_a_server(port):
    server = Server()
    server.listen("127.0.0.1", port)
    try:
        blob = export_mesh_address(server, coords=(1, 0),
                                   mesh_shape={"dp": 2})
        addr = parse_mesh_address(blob)
        assert addr.port == port and addr.coords == (1, 0)
        assert addr.mesh_shape == {"dp": 2} and addr.process_index == 0
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        assert addr.device_count == count
        assert addr.device_kind == (torch.cuda.get_device_name(0)
                                    if count else "")
    finally:
        await server.aclose()


def test_bootstrap_refuses_a_bad_address():
    with pytest.raises(ValueError, match="host:port"):
        bootstrap_distributed("no-port-here", 2, 0)


CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    from starway_tpu_torch import (Server, bootstrap_distributed,
                                   export_mesh_address, parse_mesh_address)

    pid = int(sys.argv[1])
    backend = bootstrap_distributed("127.0.0.1:{port}", 2, pid)
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    # Each process holds its half of arange(8); the sum is only right if
    # the other process's half joined in.
    x = torch.arange(8, dtype=torch.float32)[4 * pid:4 * pid + 4].sum()
    dist.all_reduce(x)
    server = Server()
    server.listen("127.0.0.1", 0)
    addr = parse_mesh_address(export_mesh_address(server))
    print(f"RESULT pid={{pid}} backend={{backend}} sum={{float(x)}} "
          f"index={{addr.process_index}}", flush=True)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "starway_tpu"))
    assert not bad, bad
    dist.destroy_process_group()
""")


def test_bootstrap_distributed_two_processes(tmp_path, port):
    script = tmp_path / "child.py"
    repo = __file__.rsplit("/", 2)[0]
    script.write_text(CHILD.format(repo=repo, port=port))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # gloo: no card
    procs = [subprocess.Popen([sys.executable, str(script), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, out in enumerate(outs):
        m = re.search(r"RESULT pid=%d backend=(\w+) sum=([\d.]+) index=(\d+)"
                      % i, out)
        assert m, f"process {i} failed:\n{out[-2000:]}"
        assert m.group(1) == "gloo"
        assert float(m.group(2)) == float(np.arange(8).sum())
        assert int(m.group(3)) == i
