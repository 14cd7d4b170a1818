"""Serving every sharded tree that the JAX package serves, against the JAX
package: the paged and rolling servers over a sharded tree, and serving
over the ep, sp and fsdp axes, float32 debug widths at 2 layers.

The JAX side runs on the 8-device CPU mesh of tests/conftest.py with its
trees placed by ``NamedSharding`` (``param_specs``, ``moe_specs`` inside
it, ``fsdp_specs``, ``quantized_param_specs``); the port's on a CPU
``SlotMesh`` holding every slot.  The MoE cases are Mixtral-style: 4
experts, top-2, SwiGLU, ``moe_capacity_factor=4.0`` (dropless).  Each
JAX run is made once for the module.

Tolerances: greedy tokens equal, token for token; the paged servers'
``pages_in_use`` equal to the JAX server's after every step; first-step
logits (the prefill's and the first decode step's) within 1e-5 (float32,
sums in another order).  Over ``"ep"`` no collective gathers along the
experts' axis: every slot runs its own experts.
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
from starway_tpu.models import PagedSlotServer as JaxPagedSlotServer
from starway_tpu.models import SlotServer as JaxSlotServer
from starway_tpu.models import generate as jax_generate
from starway_tpu.models import init_params as jax_init_params
from starway_tpu.models import param_specs as jax_param_specs
from starway_tpu.models.generate import decode_step as jax_decode_step
from starway_tpu.models.generate import prefill as jax_prefill
from starway_tpu.models.llama import (
    quantized_param_specs as jax_quantized_specs)
from starway_tpu.models.speculative import (
    draft_from_truncation as jax_truncate)
from starway_tpu.models.speculative import (
    generate_speculative as jax_speculative)
from starway_tpu.ops.quantize import quantize_params as jax_quantize
from starway_tpu.parallel import fsdp_specs as jax_fsdp_specs
from starway_tpu.parallel import make_mesh as jax_mesh
from starway_tpu_torch.models import (LlamaConfig, PagedSlotServer,
                                      SlotServer, generate,
                                      generate_speculative, param_specs,
                                      quantized_param_specs)
from starway_tpu_torch.models.convert import params_from_numpy
from starway_tpu_torch.models.generate import decode_step, prefill
from starway_tpu_torch.models.sharded import HeadSplit
from starway_tpu_torch.models.speculative import draft_from_truncation
from starway_tpu_torch.ops import collectives as col
from starway_tpu_torch.ops.quantize import quantize_params
from starway_tpu_torch.parallel import fsdp_specs, make_mesh, shard_tree
from torch_port_util import (SERVE_REQS, one_row_runs, save_tree,
                             serve_runs, span_runs, tree_to_numpy)

TESTS = Path(__file__).resolve().parent
MOE = dict(n_experts=4, moe_top_k=2, moe_swiglu=True, moe_capacity_factor=4.0)
# The same MoE at a capacity that drops tokens (aligned generate() only).
DROP = 1.25
WINDOW = 8
MAX_LEN, CHUNK, PAGE = 64, 4, 16
LOGIT_ATOL = 1e-5

_rng = np.random.default_rng(19)
PREFIX = [int(t) for t in _rng.integers(1, 512, 20)]  # a page and a tail
REQS = [([int(t) for t in _rng.integers(1, 512, n)], m, bool(i % 2))
        for i, (n, m) in enumerate([(3, 6), (7, 4), (12, 9), (5, 5), (2, 7),
                                    (9, 3)])]
# Rolling: no prefix; the third request's prompt runs past the window,
# and the first's decode wraps it.
ROLLING_REQS = [([int(t) for t in _rng.integers(1, 512, n)], m, False)
                for n, m in [(5, 9), (3, 4), (13, 5), (6, 6)]]
PROMPT = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2], [9, 9, 2, 6, 5]]

TP, DPTP = {"tp": 2}, {"dp": 2, "tp": 2}
EPTP, DPEPTP = {"ep": 2, "tp": 2}, {"dp": 2, "ep": 2, "tp": 2}
DPTPSP, FSDP4 = {"dp": 2, "tp": 2, "sp": 2}, {"fsdp": 4}

# case: (model, mesh, server, n_slots)
CASES = {
    "paged-tp": ("dense", TP, "paged", 4),
    "paged-dptp": ("dense", DPTP, "paged", 4),
    "paged-fsdp4": ("fsdp", FSDP4, "paged", 4),
    "paged-w8-tp": ("w8", TP, "paged", 4),
    "rolling-tp": ("rolling", TP, "dense", 2),
    "rolling-dptp": ("rolling", DPTP, "dense", 4),
    "moe-eptp": ("moe", EPTP, "dense", 4),
    "moe-dpeptp": ("moe", DPEPTP, "dense", 4),
    "moe-paged-eptp": ("moe", EPTP, "paged", 4),
    "moe-paged-dpeptp": ("moe", DPEPTP, "paged", 4),
    "dptpsp": ("dense", DPTPSP, "dense", 4),
    "3-slots-dptp": ("dense", DPTP, "dense", 3),
}

# The cases that register PREFIX and continue it (every other request).
PREFIXED = ("paged-tp", "paged-dptp", "paged-fsdp4")


def _torch(tree):
    return params_from_numpy(tree_to_numpy(tree), device="cpu")


def _cfgs(model):
    kw = dict(MOE) if model in ("moe", "moe-drop") else {}
    if model == "moe-drop":
        kw["moe_capacity_factor"] = DROP
    if model == "rolling":
        kw["sliding_window"] = WINDOW
    return JaxConfig.preset("debug", **kw), LlamaConfig.preset("debug", **kw)


@pytest.fixture(scope="module")
def trees():
    """``model -> (jax whole tree, port whole tree)``: one seed for the
    dense trees (the rolling model shares them), the W8A16 tree of it,
    and a Mixtral-style tree."""
    jd = jax_init_params(jax.random.PRNGKey(19), JaxConfig.preset("debug"))
    jm = jax_init_params(jax.random.PRNGKey(20), _cfgs("moe")[0])
    out = {"dense": (jd, _torch(jd)), "rolling": (jd, _torch(jd)),
           "fsdp": (jd, _torch(jd)), "moe": (jm, _torch(jm))}
    out["moe-drop"] = out["moe"]
    out["w8"] = (jax_quantize(jd), quantize_params(_torch(jd)))
    return out


def _sharded(trees, model, shape):
    """``(jax tree, port tree)`` on the mesh ``shape``, each by its own
    package's spec functions."""
    jp, tp = trees[model]
    jcfg, cfg = _cfgs(model)
    jmesh, mesh = jax_mesh(shape), make_mesh(shape, device="cpu")
    if model == "fsdp":
        jspecs, specs = jax_fsdp_specs(jp, jmesh), fsdp_specs(tp, mesh)
    elif model == "w8":
        jspecs, specs = jax_quantized_specs(jcfg), quantized_param_specs(cfg)
    else:
        jspecs, specs = jax_param_specs(jcfg), param_specs(cfg)
    jtree = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(jmesh, s)), jp, jspecs)
    return jtree, shard_tree(tp, mesh, specs)


def _drive(srv, reqs, prefix):
    """Every request through ``srv`` (either package's server), a prefix
    registered first when given: the tokens in submission order and the
    pages in use after every step (None on a dense server)."""
    pid = None if prefix is None else srv.register_prefix(prefix)
    rids = [srv.submit(p, m, prefix=pid if w else None) for p, m, w in reqs]
    done, pages = {}, []
    while srv.busy:
        done.update(srv.step())
        pages.append(getattr(srv, "pages_in_use", None))
    return [np.asarray(done[r]) for r in rids], pages


def _serve(server_cls, tree, cfg, case):
    model, _shape, server, n_slots = CASES[case]
    kw = dict(page=PAGE) if server == "paged" else {}
    srv = server_cls(tree, cfg, n_slots=n_slots, max_len=MAX_LEN,
                     chunk=CHUNK, **kw)
    if model == "rolling":
        return _drive(srv, ROLLING_REQS, None)
    if case in PREFIXED:
        return _drive(srv, REQS, PREFIX)
    return _drive(srv, [(p, m, False) for p, m, _w in REQS], None)


@pytest.fixture(scope="module")
def jax_served(trees):
    """``case -> (tokens, pages)`` of the JAX server over the JAX tree on
    the case's mesh, each run once."""
    memo = {}

    def get(case):
        if case not in memo:
            model, shape, server, _n = CASES[case]
            jtree = _sharded(trees, model, shape)[0]
            cls = JaxPagedSlotServer if server == "paged" else JaxSlotServer
            memo[case] = _serve(cls, jtree, _cfgs(model)[0], case)
        return memo[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_server_matches_jax(trees, jax_served, case):
    """The port's server over the sharded tree gives the JAX server's
    tokens over the same mesh, and a paged server holds the JAX server's
    count of pages after every step."""
    model, shape, server, n_slots = CASES[case]
    tree = _sharded(trees, model, shape)[1]
    cls = PagedSlotServer if server == "paged" else SlotServer
    got, pages = _serve(cls, tree, _cfgs(model)[1], case)
    want, jpages = jax_served(case)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{case} request {i}")
    if server == "paged":
        assert pages == jpages
        assert pages[-1] == (len(PREFIX) // PAGE if case in PREFIXED else 0)


def _first_logits(fns, tree, cfg, prompt):
    """The prefill's logits and those of the first decode step after it,
    through ``fns`` = (prefill, decode_step) of one package."""
    pre, dec = fns
    logits, cache = pre(tree, cfg, prompt, prompt.shape[1] + 4)
    step, _ = dec(tree, cache, logits.argmax(-1), prompt.shape[1], cfg)
    return np.asarray(logits), np.asarray(step)


@pytest.mark.parametrize("model,shape,rows", [
    ("dense", TP, 2), ("dense", DPTP, 3), ("dense", DPTP, 1),
    ("fsdp", FSDP4, 2), ("dense", DPTPSP, 2), ("moe", EPTP, 2),
    ("moe", DPEPTP, 3), ("moe-drop", DPEPTP, 3)],
    ids=["tp", "dptp-3-rows", "dptp-1-row", "fsdp4", "dptpsp", "eptp",
         "dpeptp-3-rows", "dpeptp-dropping-3-rows"])
def test_first_step_logits_match_jax(trees, model, shape, rows):
    """The first-step logits of the port's sharded tree within 1e-5 of the
    JAX package's over the same mesh; a batch the data axes do not divide
    is served in uneven blocks (one row over dp = 2 leaves the second
    data group's block empty)."""
    jtree, tree = _sharded(trees, model, shape)
    jcfg, cfg = _cfgs(model)
    prompt = np.asarray(PROMPT[:rows], np.int32)
    want = _first_logits((jax_prefill, jax_decode_step), jtree, jcfg,
                         jnp.asarray(prompt))
    with torch.no_grad():
        got = _first_logits((prefill, decode_step), tree, cfg,
                            torch.tensor(prompt, dtype=torch.long))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0)


def test_generate_and_speculative_over_ep_match_jax(trees):
    """``generate()`` and speculative decoding (a truncation draft) with
    the Mixtral-style tree over ep x tp: the JAX package's tokens over the
    same mesh."""
    jtree, tree = _sharded(trees, "moe", EPTP)
    jcfg, cfg = _cfgs("moe")
    prompt = PROMPT[:2]
    want = jax_generate(jtree, jcfg, jnp.asarray(prompt, jnp.int32), 7)
    got = generate(tree, cfg, torch.tensor(prompt), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jd, jdcfg = jax_truncate(jtree, jcfg, 1)
    want = jax_speculative(jtree, jcfg, jd, jdcfg,
                           jnp.asarray(prompt, jnp.int32), 9, gamma=3)
    draft, dcfg = draft_from_truncation(trees["moe"][1], cfg, 1)
    sdraft = shard_tree(draft, make_mesh(EPTP, device="cpu"),
                        param_specs(dcfg))
    got = generate_speculative(tree, cfg, sdraft, dcfg, torch.tensor(prompt),
                               9, gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_dropping_moe_over_dp_matches_jax(trees):
    """A MoE whose capacity drops tokens (``moe_capacity_factor`` 1.25)
    over dp x ep x tp: ``generate()`` gives the JAX package's tokens, whose
    GSPMD routes the whole batch (its capacity and its priority order),
    not each data group's rows alone."""
    jtree, tree = _sharded(trees, "moe-drop", DPEPTP)
    jcfg, cfg = _cfgs("moe-drop")
    want = jax_generate(jtree, jcfg, jnp.asarray(PROMPT, jnp.int32), 6)
    got = generate(tree, cfg, torch.tensor(PROMPT), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_experts_stay_split_over_ep(trees, monkeypatch):
    """Serving over ep x tp gathers nothing along "ep": each slot runs the
    experts it holds (E / ep of them) and the outputs are summed; the
    caches hold each slot's kv heads, the whole count reported."""
    tree = _sharded(trees, "moe", EPTP)[1]
    cfg = _cfgs("moe")[1]
    w_in = tree["layers"]["moe"]["w_in"]
    assert {tuple(t.shape) for t in w_in.shards.values()} == {
        (cfg.n_layers, cfg.n_experts // 2, cfg.d_model, cfg.d_ff)}
    axes = []
    real = col.all_gather

    def spy(shards, mesh, axis, *a, **kw):
        axes.append(axis)
        return real(shards, mesh, axis, *a, **kw)

    monkeypatch.setattr(col, "all_gather", spy)
    srv = PagedSlotServer(tree, cfg, n_slots=2, max_len=MAX_LEN,
                          chunk=CHUNK, page=PAGE)
    _drive(srv, REQS[:3], PREFIX)
    assert axes and "ep" not in axes and set(axes) == {"tp"}
    pool = srv.cache["k"]
    assert isinstance(pool, HeadSplit) and len(pool.parts) == 4
    assert pool.shape == (cfg.n_layers, srv.n_pages, cfg.n_kv_heads, PAGE,
                          cfg.head_dim)
    assert all(p.shape[2] == cfg.n_kv_heads // 2 and p.is_contiguous()
               for p in pool.parts)


def _two_processes(tmp_path, shape: str, kind: str) -> list:
    """Each process's outputs of a two-process gloo run of
    ``torch_port_util.serve_worker`` (weights from a seed in
    ``tmp_path``)."""
    jp = jax_init_params(jax.random.PRNGKey(2), JaxConfig.preset("debug"))
    save_tree(str(tmp_path / "params.npz"), tree_to_numpy(jp))
    world, port = 2, free_port()
    code = ("import sys; sys.path[:0] = sys.argv[1:3]\n"
            "from torch_port_util import serve_worker\n"
            "serve_worker(int(sys.argv[3]), int(sys.argv[4]), "
            "int(sys.argv[5]), sys.argv[6], sys.argv[7], sys.argv[8])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(TESTS), str(TESTS.parent), str(r),
         str(world), str(port), str(tmp_path), shape, kind],
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
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(world)]


def test_fsdp_across_two_processes(tmp_path):
    """Two gloo processes, one fsdp slot each, serve the ``fsdp_specs``
    tree (its leaves gathered across the processes): both servers and
    ``generate()`` bit-equal to one process.  One row over the two data
    groups (``generate()`` of one prompt, a one-slot ``SlotServer``) is
    bit-equal to one process too: the group with no rows posts the
    gathers that the other waits in, and neither process hangs."""
    runs = _two_processes(tmp_path, "fsdp=2", "fsdp")
    one = serve_runs({"fsdp": 2}, str(tmp_path), fsdp=True)
    one.update(one_row_runs({"fsdp": 2}, str(tmp_path)))
    assert len(one) == 2 * len(SERVE_REQS) + 1 + 3
    for got in runs:
        assert sorted(got) == sorted(one)
        for key in one:
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)


def test_paged_over_tp_across_two_processes(tmp_path):
    """Two gloo processes, one tp slot each, run the paged server (a
    prefix, its pages shared) on the same requests: their tokens and
    pages in use are bit-equal to each other's and to one process's.  So
    are the dense and paged servers and ``generate()`` over
    ``{"tp": 2, "dp": 2}``, whose data groups' slots each sit in both
    processes (pages in use included)."""
    runs = _two_processes(tmp_path, "tp=2", "paged")
    one = serve_runs(TP, str(tmp_path), paged=True)
    assert len(one) == len(SERVE_REQS) + 1
    one.update({f"span/{k}": v for k, v in
                span_runs({"tp": 2, "dp": 2}, str(tmp_path)).items()})
    assert len(one) == 3 * len(SERVE_REQS) + 3
    for got in runs:
        assert sorted(got) == sorted(one)
        for key in one:
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
