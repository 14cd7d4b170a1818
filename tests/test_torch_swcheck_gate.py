"""The port's analysis gate as a whole: HEAD is clean, the CLI, and the
swcost ledger -- twins of tests/test_swcheck.py.

``python -m starway_tpu_torch.analysis`` runs all twelve passes on the
port's tree (``starway_tpu_torch/`` and ``tests/test_torch_*.py``) and
nothing else: a tree that holds only those finds its root and is clean,
with wirefuzz's native leg run against the port's own build.  The cost
cases apply the JAX package's mutations of both engines' hot paths and of
the ledger to the port's tree and the JAX package's and assert that both
gates fire the same rule (tests/torch_swcheck_util.py); the ledger rows
they move are read from the port's ``cost_budgets.txt``.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

import pytest

from starway_tpu_torch import analysis as port_analysis
from starway_tpu_torch import native_build
from torch_swcheck_util import JAX, REPO, SWA, Twin, ledger_row


_GATHER_ANCHOR = "views, spans = self._gather_tx()"
_SENDMSG_ANCHOR = "ssize_t w = ::sendmsg(c->fd, &msg, MSG_NOSIGNAL);"


_LEDGER = "pkg/analysis/cost_budgets.txt"
#: The pinned row the ratchet cases move, as the port's ledger pads it.
_PY_TX_SYSCALLS = ledger_row("py", "eager_tx", "syscalls")
_PY_TX_RAISED = re.sub(r"\d+$", lambda m: str(int(m.group()) + 2),
                       _PY_TX_SYSCALLS)


def _shadow_ledger(root: Twin) -> None:
    """Give the seeded trees their own cost_budgets.txt (ledger_path
    prefers the tree copy over the package fallback, wirefuzz-corpus
    style): the port's ledger, which pins the JAX package's rows."""
    root.write(_LEDGER, (REPO / "starway_tpu_torch" / "analysis"
                         / "cost_budgets.txt").read_text())


def test_swcost_rules_registered():
    # The three new finding codes are waiver targets (--rules) and
    # render as problem-matcher rows like every pass.
    for rule in ("cost-budget", "cost-model", "cost-site"):
        assert rule in port_analysis.RULES, rule


def test_cost_py_syscall_regression_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "n = self.sock.sendmsg(views)",
              "n = self.sock.sendmsg(views) + self.sock.send(b\"\")")
    root.caught("cost-budget", "py eager_tx syscalls",
                "cost_budgets.txt")


def test_cost_py_copy_regression_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py", _GATHER_ANCHOR,
          _GATHER_ANCHOR + "\n                junk = b\"\".join(views)")
    root.caught("cost-budget", "py eager_tx copies",
                "cost_budgets.txt")


def test_cost_py_alloc_regression_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py", _GATHER_ANCHOR,
          _GATHER_ANCHOR + "\n                junk = bytearray(4096)")
    root.caught("cost-budget", "py eager_tx allocs",
                "cost_budgets.txt")


def test_cost_py_lock_regression_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py", _GATHER_ANCHOR,
          _GATHER_ANCHOR + "\n                self.worker._lock.acquire()")
    root.caught("cost-budget", "py eager_tx locks",
                "cost_budgets.txt")


def test_cost_cpp_syscall_regression_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", _SENDMSG_ANCHOR,
              "::send(c->fd, \"\", 0, 0);\n    " + _SENDMSG_ANCHOR)
    root.caught("cost-budget", "cpp eager_tx syscalls",
                "cost_budgets.txt")


def test_cost_cpp_copy_regression_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", _SENDMSG_ANCHOR,
              "memcpy(iov, iov, 0);\n    " + _SENDMSG_ANCHOR)
    root.caught("cost-budget", "cpp eager_tx copies",
                "cost_budgets.txt")


def test_cost_cpp_alloc_regression_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", _SENDMSG_ANCHOR,
              "void* zz = malloc(1);\n    " + _SENDMSG_ANCHOR)
    root.caught("cost-budget", "cpp eager_tx allocs",
                "cost_budgets.txt")


def test_cost_cpp_lock_regression_seeded(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp", _SENDMSG_ANCHOR,
              "std::lock_guard<std::mutex> zz(gather_mu);\n    "
          + _SENDMSG_ANCHOR)
    root.caught("cost-budget", "cpp eager_tx locks",
                "cost_budgets.txt")


def test_cost_ratchet_fires_on_improvement(tmp_path):
    # BEATING a pin is also red until the ledger is lowered: raise the
    # py eager_tx syscalls pin above the measured value and the gate
    # must demand the ratchet, not silently accept the slack.
    root = Twin(tmp_path)
    _shadow_ledger(root)
    root.edit(_LEDGER, _PY_TX_SYSCALLS, _PY_TX_RAISED)
    root.caught("cost-budget", "beats the pinned budget",
                "cost_budgets.txt")


def test_cost_ledger_malformed_and_unknown_rows(tmp_path):
    root = Twin(tmp_path)
    _shadow_ledger(root)
    root.modify(_LEDGER, lambda t: t + "py eager_tx syscalls noninteger\n"
                + "py warp_tx syscalls 1\n")
    root.caught("cost-model", "malformed ledger row",
                "cost_budgets.txt")
    root.caught("cost-model", "unknown surface",
                "cost_budgets.txt")


def test_cost_ledger_missing_row(tmp_path):
    root = Twin(tmp_path)
    _shadow_ledger(root)
    root.edit(_LEDGER, _PY_TX_SYSCALLS + "\n", "")
    root.caught("cost-model", "no ledger row for py eager_tx",
                "cost_budgets.txt")


def test_cost_refuses_vacuity_when_anchor_renamed(tmp_path):
    # A hot-path anchor disappearing must be loud (cost-model), never a
    # silently-zero vector ratified by the ledger.
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py",
              "def kick_tx(", "def kick_tx_v2(")
    root.caught("cost-model", "kick_tx", "conn.py")


def test_cost_refuses_vacuity_when_cpp_pump_arm_gone(tmp_path):
    root = Twin(tmp_path)
    root.edit("native/sw_engine.cpp",
              "if (c->rx_skip)", "if (c->rx_skip2)")
    root.caught("cost-model", "pump_frames rx arms",
              "sw_engine.cpp")


def test_cost_instrumentation_removed_seeded(tmp_path):
    # Deleting the §23 runtime twin turns the gate red even though no
    # static site count moved: the dynamic conformance test would be
    # vacuous without the counters.
    root = Twin(tmp_path)
    root.modify("native/sw_engine.cpp", lambda t: t.replace(
              "bump(counters.io_syscalls", "bump(counters.bytes_tx_shadow"))
    root.caught("cost-model", "runtime cost twin dark", "sw_engine.cpp")


def test_cost_site_waiver_excludes_site(tmp_path):
    # A justified cost-site waiver on the new site's own line excludes
    # it at extraction time: the ledger pin holds and the gate is green.
    root = Twin(tmp_path)
    root.edit("pkg/core/conn.py", _GATHER_ANCHOR,
              _GATHER_ANCHOR + "\n                junk = b\"\".join(views)"
              f"  {SWA}(cost-site): exercising the waiver path")
    assert root.findings("cost-budget") == []
    assert root.findings("bad-waiver") == []


def test_cost_budget_waiver_on_ledger_row(tmp_path):
    # cost-budget findings anchor to the ledger row, so the in-place
    # waiver discipline works there like any source line.
    root = Twin(tmp_path)
    _shadow_ledger(root)
    root.edit(_LEDGER, _PY_TX_SYSCALLS,
              _PY_TX_RAISED + "  "
              f"{SWA}(cost-budget): exercising the waiver path")
    assert root.findings("cost-budget") == []
    assert root.findings("bad-waiver") == []


def test_head_is_clean():
    findings = port_analysis.run_all(REPO)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_seeded_copy_is_clean(tmp_path):
    # The mutation fixtures below are only meaningful if the unmutated
    # copy passes: a dirty baseline would mask which rule fired.
    root = Twin(tmp_path)
    findings = root.run_all()
    assert findings == [], "\n".join(f.render() for f in findings)


def test_full_gate_under_budget():
    # All passes -- explore's exhaustive enumeration included -- must fit
    # the 60 s budget on one core (the parse
    # cache is what keeps repeated per-pass reads out of the bill).
    import time as _time

    t0 = _time.perf_counter()
    findings = port_analysis.run_all(REPO)
    elapsed = _time.perf_counter() - t0
    assert findings == [], "\n".join(f.render() for f in findings)
    assert elapsed < 60.0, f"gate took {elapsed:.1f}s (budget 60s)"


def test_cli_json_and_timings(tmp_path, capsys):
    import json as _json

    from starway_tpu_torch.analysis.__main__ import main

    assert main(["--root", str(REPO), "--json", "--timings"]) == 0
    out = capsys.readouterr()
    doc = _json.loads(out.out)
    assert doc["ok"] is True and doc["findings"] == []
    assert set(doc["timings_s"]) == set(port_analysis.PASSES)
    assert "pass" in out.err  # --timings table on stderr
    # Findings shape carries file/line/rule/message for the CI matcher.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_jax.py", "import jax\n")
    assert main(["--root", str(root.root), "--json"]) == 1
    doc = _json.loads(capsys.readouterr().out)
    assert doc["ok"] is False
    assert any(f["rule"] == "layering-jax" and f["line"] == 1
               for f in doc["findings"])


def test_cli_exit_codes(tmp_path):
    from starway_tpu.analysis.__main__ import main as jax_main
    from starway_tpu_torch.analysis.__main__ import main

    assert main(["--root", str(REPO)]) == 0
    assert main(["--root", str(REPO), "--rules"]) == 0
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_jax.py", "import jax\n")
    assert main(["--root", str(root.root)]) == 1
    assert main(["--root", str(root.root), "contract"]) == 0  # pass selection
    # The JAX package's CLI answers its own seeded tree the same way.
    assert jax_main(["--root", str(root.roots[JAX])]) == 1
    assert jax_main(["--root", str(root.roots[JAX]), "contract"]) == 0
    with pytest.raises(SystemExit):
        main(["--root", str(root.root), "nonsense-pass"])




_ALONE_CHECK = """
from pathlib import Path
from starway_tpu_torch import native_build
from starway_tpu_torch.analysis import find_root, refine, run_all, wirefuzz
root = find_root()
assert root == Path.cwd().resolve(), root
timings = {}
findings = run_all(root, timings=timings)
assert findings == [], [f.render() for f in findings]
assert len(timings) == 12, timings
so = native_build.artifact(root)
assert wirefuzz._NATIVE_CACHE.get(str(so)) is not None, wirefuzz._NATIVE_ERRORS
mon, problems = refine.compile_monitor(runtime=True)
assert mon is not None and not problems, problems
print("native leg:", so.relative_to(root))
"""


def test_gate_on_a_tree_of_the_port_alone(tmp_path):
    """The root is where starway_tpu_torch/ and its engine copy stand: a
    tree with no starway_tpu/ and no root-level native/ finds its root
    from the working directory, compiles the runtime monitor from its own
    engines, and passes the whole gate, wirefuzz's native leg included."""
    alone = tmp_path / "alone"
    shutil.copytree(REPO / "starway_tpu_torch", alone / "starway_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (alone / "tests").mkdir()
    for path in sorted((REPO / "tests").glob("test_torch_*.py")):
        shutil.copy2(path, alone / "tests" / path.name)
    built = native_build.ensure_built()
    dst = alone / "build" / "starway_tpu_torch" / "_sw_native.so"
    dst.parent.mkdir(parents=True)
    shutil.copy2(built, dst)
    dst.touch()  # newer than the copied sources, as a build would be
    assert not (alone / "starway_tpu").exists()
    assert not (alone / "native").exists()
    r = subprocess.run([sys.executable, "-c", _ALONE_CHECK], cwd=alone,
                       env={**os.environ,
                            "PYTHONPATH": str(alone)},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "native leg: build/starway_tpu_torch/_sw_native.so" in r.stdout


def test_rules_match_the_jax_gate():
    from starway_tpu.analysis import RULES as jax_rules
    from starway_tpu.analysis import PASSES as jax_passes

    assert list(port_analysis.RULES) == list(jax_rules)
    assert list(port_analysis.PASSES) == list(jax_passes)
