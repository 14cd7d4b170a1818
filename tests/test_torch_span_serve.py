"""Serving by data groups whose slots sit in several processes, and data
groups with no rows while a leaf is gathered across processes
(models/sharded.py ``DataGroups``), float32 debug widths.

``{"dp": 3, "tp": 2}`` over two processes puts group dp0 whole in the
first process, dp2 whole in the second and dp1 across both, so each
process runs one group of its own and one that spans; two slots over three
groups leave uneven blocks (one row, one row, none).  Its one-process run
is held against the JAX package's ``generate`` over the same mesh of its
8 virtual CPU devices, token for token, and the two gloo processes must
give the one-process tokens bit for bit (pages in use included).

A process with no rows in a round posts the gathers of one run of the
decode paths (``SlotTree.post_gathers``): its hops must be those of a
real run, in the same order and shapes, for every decode path, or the
processes would pair the wrong messages.  The layouts of the groups
(which slots a process holds, the rounds, the cover of admission) are
checked on meshes of four processes from the point of view of each rank.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from conftest import free_port
from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import generate as jax_generate
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models import param_specs as jax_param_specs
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu_torch.models import (LlamaConfig, SlotServer, generate,
                                      param_specs)
from starway_tpu_torch.models import sharded
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.generate import (decode_step, init_cache,
                                               prefill, prefill_rolling,
                                               rolling_plan)
from starway_tpu_torch.models.llama import cfg_rope_tables
from starway_tpu_torch.models.paged import init_paged_pool, paged_chunk_step
from starway_tpu_torch.models.speculative import chunk_decode_step
from starway_tpu_torch.ops import collectives as col
from starway_tpu_torch.ops.quantize import quantize_params
from starway_tpu_torch.parallel import fsdp_specs, make_mesh, shard_tree
from starway_tpu_torch.parallel.sharding import Mesh
from torch_port_util import (SERVE_PROMPT, SERVE_REQS, save_tree, span_runs,
                             tree_to_numpy)

TESTS = Path(__file__).resolve().parent
DP3TP2 = {"dp": 3, "tp": 2}


def _jax(tree, specs, shape):
    mesh = jax_mesh(shape)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)


def test_dp3_tp2_matches_jax():
    """One process over ``{"dp": 3, "tp": 2}``: the server with two slots
    (blocks of one row, one row and none) and ``generate()`` on two
    prompts give JAX's tokens over the same mesh."""
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(5), jcfg)
    cfg = LlamaConfig.preset("debug")
    tree = shard_tree(params_from_numpy(tree_to_numpy(jp), device="cpu"),
                      make_mesh(DP3TP2, device="cpu"), param_specs(cfg))
    jtree = _jax(jp, jax_param_specs(jcfg), DP3TP2)
    srv = SlotServer(tree, cfg, n_slots=2, max_len=32, chunk=4)
    assert srv.cache["k"].rows == [(0, 1)] * 2 + [(1, 2)] * 2 + [(2, 2)] * 2
    rids = [srv.submit(p, m) for p, m in SERVE_REQS]
    done = srv.run()
    for rid, (p, m) in zip(rids, SERVE_REQS):
        want = np.asarray(jax_generate(jtree, jcfg,
                                       jnp.asarray([p], jnp.int32),
                                       m)[0, len(p):])
        np.testing.assert_array_equal(done[rid], want)
    want = np.asarray(jax_generate(jtree, jcfg,
                                   jnp.asarray(SERVE_PROMPT, jnp.int32), 6))
    np.testing.assert_array_equal(
        generate(tree, cfg, torch.tensor(SERVE_PROMPT), 6).numpy(), want)


def test_dp3_tp2_across_two_processes(tmp_path):
    """Two gloo processes over ``{"dp": 3, "tp": 2}`` (a local group and a
    spanning one in each): the dense and paged servers and ``generate()``
    bit-equal to one process, pages in use after every step included."""
    jp = jax_init_params(jax.random.PRNGKey(2), JaxConfig.preset("debug"))
    save_tree(str(tmp_path / "params.npz"), tree_to_numpy(jp))
    world, port = 2, free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]\n"
            "from torch_port_util import serve_worker\n"
            "serve_worker(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6], 'dp=3,tp=2', 'span')\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent), str(r),
         str(world), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    one = span_runs(DP3TP2, str(tmp_path))
    assert len(one) == 2 * len(SERVE_REQS) + 2
    for r in range(world):
        got = dict(np.load(tmp_path / f"out{r}.npz"))
        assert sorted(got) == sorted(one)
        for key in one:
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)


class _RankMesh(Mesh):
    """A mesh as process ``rank`` of ``world`` sees it, without a process
    group (its collectives are never run)."""

    def __init__(self, shape: dict, rank: int, world: int):
        self._rank, self._world = rank, world
        super().__init__(shape, torch.device("cpu"))

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world(self) -> int:
        return self._world


def _groups(shape: dict, rank: int, world: int):
    cfg = LlamaConfig.preset("debug")
    params = params_from_numpy(tree_to_numpy(jax_init_params(
        jax.random.PRNGKey(0), JaxConfig.preset("debug"))), device="cpu")
    tree = shard_tree(params, _RankMesh(shape, rank, world),
                      param_specs(cfg))
    return sharded.data_groups(tree, cfg)


@pytest.mark.parametrize("shape,world,local,members,rounds,cover", [
    # Group dp1 spans the two processes; each holds a group of its own.
    (DP3TP2, 2, [[0, 1], [1, 2]],
     [{0: [(0, 0), (1, 1)], 1: [(2, 0)]},
      {1: [(0, 1)], 2: [(1, 0), (2, 1)]}],
     [[0, 2], [1]], [0, 2]),
    # Three slots a process: group dp0 is three slots of process 0 and
    # one of process 1.
    ({"dp": 3, "tp": 4}, 4, [[0], [0, 1], [1, 2], [2]],
     [{0: [(0, 0), (1, 1), (2, 2)]}, {0: [(0, 3)], 1: [(1, 0), (2, 1)]},
      {1: [(0, 2), (1, 3)], 2: [(2, 0)]}, {2: [(0, 1), (1, 2), (2, 3)]}],
     [[0, 2], [1]], [0, 1, 2]),
    # Every group spans both processes.
    ({"tp": 2, "dp": 2}, 2, [[0, 1], [0, 1]],
     [{0: [(0, 0)], 1: [(1, 0)]}, {0: [(0, 1)], 1: [(1, 1)]}],
     [[0], [1]], [0]),
])
def test_group_layouts(shape, world, local, members, rounds, cover):
    """Which groups and slots each rank holds, the view's local slots (a
    contiguous run of the group's), the rounds (no rank twice in one) and
    the cover of admission (every rank a part at each of its slots' view
    indices), the same on every rank."""
    for rank in range(world):
        groups = _groups(shape, rank, world)
        assert groups.local == local[rank]
        assert groups.members == members[rank]
        assert groups._rounds(range(groups.size)) == rounds
        assert groups.cover() == cover
        for g in groups.local:
            sub = sharded.tree_mesh(groups.views[g])
            assert list(sub.local_slots) == [k for _, k in
                                             groups.members[g]]
            assert [sub.parent_index(k) for k in sub.local_slots] == [
                groups.slots_of[g][k] for _, k in groups.members[g]]


def _fsdp_view(quant: bool, **over):
    """Group 0's view of an ``fsdp_specs`` tree over ``{"fsdp": 2}`` in
    one process, its config and its groups."""
    cfg = LlamaConfig.preset("debug", **over)
    params = params_from_numpy(tree_to_numpy(jax_init_params(
        jax.random.PRNGKey(3), JaxConfig.preset("debug", **over))),
        device="cpu")
    if quant:
        params = quantize_params(params)
    mesh = make_mesh({"fsdp": 2}, device="cpu")
    tree = shard_tree(params, mesh, fsdp_specs(params, mesh))
    groups = sharded.data_groups(tree, cfg)
    assert any(isinstance(x, sharded._GroupLeaf)
               for x in sharded._walk(groups.views[0]))
    return groups.views[0], cfg, groups


def _hops(monkeypatch, mesh, fn) -> list:
    """``(axis, dim, shapes, dtype)`` of every gather over ``mesh`` that
    ``fn()`` posts, in order."""
    log, real = [], col.all_gather

    def gather(shards, m, axis, dim=0, **kw):
        if m is mesh:
            log.append((axis, dim, tuple(tuple(x.shape) for x in shards),
                        shards[0].dtype))
        return real(shards, m, axis, dim, **kw)

    monkeypatch.setattr(col, "all_gather", gather)
    with torch.no_grad():
        fn()
    monkeypatch.setattr(col, "all_gather", real)
    return log


@pytest.mark.parametrize("path", ["prefill", "decode", "chunk", "paged",
                                  "rolling", "w8"])
def test_post_gathers_replays_a_run(monkeypatch, path):
    """The gathers that ``post_gathers`` posts are those of a real run of
    each decode path over a group's view, hop for hop: the embedding,
    every layer's leaves, ``lm_head`` (a W8A16 pair's codes, then its
    scales) and the final norm; rolling admission once a chunk."""
    over = dict(sliding_window=8) if path == "rolling" else {}
    view, cfg, groups = _fsdp_view(path == "w8", **over)
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]])
    bodies = 1
    if path in ("prefill", "w8"):
        def run():
            prefill(view, cfg, prompt, 16)
    elif path == "decode":
        def run():
            decode_step(view, init_cache(cfg, 1, 16, "cpu", view),
                        torch.tensor([7]), 3, cfg)
    elif path == "chunk":
        def run():
            chunk_decode_step(view, init_cache(cfg, 1, 16, "cpu", view),
                              prompt[:, :4], 2, cfg,
                              cfg_rope_tables(cfg, 16, "cpu"))
    elif path == "paged":
        def run():
            paged_chunk_step(view, init_paged_pool(cfg, 4, 8, "cpu", view),
                             torch.tensor([[1, 2]], dtype=torch.int32),
                             prompt[:, :4], 2, cfg,
                             cfg_rope_tables(cfg, 16, "cpu"))
    else:
        bodies = len(rolling_plan(prompt.shape[1], 8, widths=(4, 1)))
        assert bodies > 1

        def run():
            prefill_rolling(view, cfg, prompt, widths=(4, 1))
    real = _hops(monkeypatch, groups.mesh, run)
    ghost = _hops(monkeypatch, groups.mesh,
                  lambda: groups.post_gathers(view, bodies))
    assert len(real) > cfg.n_layers
    assert ghost == real
