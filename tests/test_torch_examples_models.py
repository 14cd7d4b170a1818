"""The port's twins of the serving examples (examples/torch/
serve_continuous.py, speculative.py, serve_remote.py) against the JAX
package on the CPU.

Each twin's body takes the parameter tree, so here it gets the JAX
example's own weights (``init_params(PRNGKey(k), cfg)``, carried across by
``params_from_numpy``), and the JAX side makes the JAX example's calls at
its seeds: the same request stream from ``default_rng(0)``, the same
prompts.  Held exactly (greedy, float32): the tokens of the whole
continuous stream and of its prefix requests, of every speculative
drafter with its acceptance counts, and of every remote stream on three
transports (in process, tcp, the C++ engine over tcp).  The twins also
run at small sizes with ``--device cpu`` in a fresh process that must end
with nothing of JAX imported, and refuse to run without a card and
without ``--device cpu``."""

import asyncio
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from starway_tpu.models import LlamaConfig as JaxConfig
from starway_tpu.models import SlotServer as JaxSlotServer
from starway_tpu.models import init_params as jax_init_params
from starway_tpu_torch.models import LlamaConfig
from torch_port_util import (assert_refused, carried, run_twins, twin,
                             twin_output)

jgen = importlib.import_module("starway_tpu.models.generate")
jspec = importlib.import_module("starway_tpu.models.speculative")

REPO = Path(__file__).resolve().parent.parent
NAMES = ["serve_continuous", "speculative", "serve_remote"]


@pytest.fixture(scope="module")
def debug():
    """The debug preset's tree at the examples' seed, both packages."""
    jcfg = JaxConfig.preset("debug")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, LlamaConfig.preset("debug"), carried(jp)


# ------------------------------------------------------- serve_continuous


def jax_serve_continuous(jp, jcfg, requests: int, slots: int, chunk: int):
    """examples/serve_continuous.py's calls on the JAX package."""
    srv = JaxSlotServer(jp, jcfg, n_slots=slots, max_len=96, chunk=chunk,
                        temperature=0.0, seed=7)
    rng = np.random.default_rng(0)
    done = {}
    for _ in range(requests):
        prompt = list(rng.integers(1, jcfg.vocab_size,
                                   int(rng.integers(2, 16))))
        srv.submit(prompt, int(rng.integers(4, 12)))
        done.update(srv.step())
    done.update(srv.run())
    system = list(rng.integers(1, jcfg.vocab_size, 11))
    pid = srv.register_prefix(system)
    prids = [srv.submit(list(rng.integers(1, jcfg.vocab_size, n)), 6,
                        prefix=pid) for n in (3, 5, 2)]
    pdone = srv.run()
    return done, [pdone[p] for p in prids]


def test_serve_continuous_matches_jax(debug):
    jcfg, jp, cfg, tp = debug
    with torch.no_grad():
        got = twin("serve_continuous").serve(tp, cfg)
    done, pdone = jax_serve_continuous(jp, jcfg, 12, 3, 8)
    assert sorted(got["done"]) == sorted(done) and len(done) == 12
    for rid in done:
        np.testing.assert_array_equal(got["done"][rid], done[rid],
                                      err_msg=f"request {rid}")
    assert len(got["prefix_done"]) == 3
    for g, w in zip(got["prefix_done"], pdone):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ speculative


def test_speculative_matches_jax(debug):
    jcfg, jp, cfg, tp = debug
    gamma, max_new = 4, 12
    jdcfg = JaxConfig.preset("debug", n_layers=1)
    jdp = jax_init_params(jax.random.PRNGKey(1), jdcfg)
    with torch.no_grad():
        got = twin("speculative").decode(
            tp, cfg, carried(jdp), LlamaConfig.preset("debug", n_layers=1),
            gamma=gamma, max_new=max_new)
    prompt = jnp.asarray(np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (2, 8), dtype=np.int32))
    np.testing.assert_array_equal(
        got["generate"], np.asarray(jgen.generate(jp, jcfg, prompt,
                                                  max_new)))
    tparams, tcfg = jspec.draft_from_truncation(jp, jcfg, 1)
    runs = {
        "shallow draft (1L, random)": (jdp, jdcfg),
        "truncation draft (target[:1])": (tparams, tcfg),
        "self-draft (acceptance ~1)": (jp, jcfg)}
    for name, (dp, dc) in runs.items():
        out, stats = jspec.generate_speculative(
            jp, jcfg, dp, dc, prompt, max_new, gamma=gamma,
            return_stats=True)
        tokens, tstats = got[name]
        np.testing.assert_array_equal(tokens, np.asarray(out), err_msg=name)
        for key in ("macro_steps", "accepted"):
            np.testing.assert_array_equal(tstats[key],
                                          np.asarray(stats[key]),
                                          err_msg=f"{name} {key}")
    out, stats = jspec.generate_lookup(jp, jcfg, prompt, max_new,
                                       gamma=gamma, ngram=2,
                                       return_stats=True)
    tokens, tstats = got["prompt-lookup (ngram=2, draft-free)"]
    np.testing.assert_array_equal(tokens, np.asarray(out))
    for key in ("macro_steps", "accepted"):
        np.testing.assert_array_equal(tstats[key], np.asarray(stats[key]))


# ----------------------------------------------------------- serve_remote


@pytest.fixture(scope="module")
def remote_wants(debug):
    """JAX ``generate()``'s tokens for serve_remote's five requests."""
    jcfg, jp = debug[:2]
    mod = twin("serve_remote")
    rng = np.random.default_rng(0)
    wants = []
    for n, m in mod.REQUESTS:
        prompt = list(map(int, rng.integers(1, jcfg.vocab_size, n)))
        out = jgen.generate(jp, jcfg, jnp.asarray([prompt], jnp.int32), m)
        wants.append((prompt, np.asarray(out[0, n:])))
    return wants


@pytest.mark.parametrize("transport", ["inproc", "tcp", "native"])
def test_serve_remote_matches_jax(debug, remote_wants, transport,
                                  monkeypatch):
    if transport != "inproc":
        monkeypatch.setenv("STARWAY_TLS", "tcp")
    if transport == "native":
        from starway_tpu_torch.core import native

        if not native.available():
            pytest.skip("native engine unavailable (no toolchain)")
        monkeypatch.setenv("STARWAY_NATIVE", "1")
    cfg, tp = debug[2:]
    with torch.no_grad():
        got = asyncio.run(twin("serve_remote").serve_remote(tp, cfg))
    assert [p for p, _ in got["reqs"]] == [p for p, _ in remote_wants]
    for i, (out, (_, want)) in enumerate(zip(got["outs"], remote_wants)):
        np.testing.assert_array_equal(out, want, err_msg=f"request {i}")


# ------------------------------------------- the twins as their own process


@pytest.fixture(scope="module")
def runs():
    """The twins refusing without a card, then on the CPU at small sizes, in
    one fresh process."""
    return run_twins(REPO, [(f"refuse-{name}", name, []) for name in NAMES] + [
        ("serve_continuous", "serve_continuous", ["--device", "cpu",
                                                  "--requests", "4"]),
        ("speculative", "speculative", ["--device", "cpu", "--max-new", "8"]),
        ("serve_remote", "serve_remote", ["--device", "cpu"])])


@pytest.mark.parametrize("name,expect", [
    ("serve_continuous", "all match generate(prefix + suffix)"),
    ("speculative", "prompt-lookup (ngram=2, draft-free): bit-identical to "
                    "generate(): True"),
    ("serve_remote", "cross-checked against standalone generate(): OK")])
def test_twin_runs_without_jax(runs, name, expect):
    assert expect in twin_output(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_twin_refuses_without_a_card(runs, name):
    """Without a card and without --device cpu the twin stops with a
    message: it never carries on on the CPU."""
    assert_refused(runs, f"refuse-{name}")
