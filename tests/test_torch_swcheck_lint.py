"""The port's analysis gate, lint rules: twins of tests/test_swcheck.py.

The concurrency lint (callbacks under a lock, blocking calls, their
interprocedural reach, lock order, the TX-item duck type, lint-surface
coverage), the layering rules, the ``slow``-marker guard, the hot-path
copy lint and the waiver policy.  Each case seeds the port's tree and the
JAX package's, applies one mutation to both and asserts that the port's
gate fires the rule at a real ``file:line`` and the JAX package's gate
fires the same rule (tests/torch_swcheck_util.py).  Each case runs only
the pass that owns its rule, but the waiver and parse-error cases that
count every finding.  In the port the framework core/ and reshard/ must
not bind is torch, and jax stays banned there too.
"""

from __future__ import annotations

from torch_swcheck_util import JAX, PORT, SWA, Twin


def test_callback_under_lock(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_lock.py",
               "def _run_fires(fires):\n"
               "    pass\n"
               "\n"
               "class W:\n"
               "    def bad(self, fires, fail):\n"
               "        with self.lock:\n"
               "            _run_fires(fires)\n"
               "            fail('boom')\n"
               "    def good(self, fires, fail):\n"
               "        with self.lock:\n"
               "            fires.append(lambda: fail('deferred is fine'))\n"
               "        _run_fires(fires)\n"
    )
    hits = root.findings("callback-under-lock")
    assert {f.line for f in hits} == {7, 8}, hits
    root.caught("callback-under-lock", "_run_fires", "_seeded_lock.py")
    root.caught("callback-under-lock", "`fail(...)`", "_seeded_lock.py")


def test_import_jax_in_core(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_jax.py",
               "import jax\n"
               "from jax.experimental import transfer\n"
    )
    hits = root.findings("layering-jax")
    assert {f.line for f in hits} == {1, 2}, hits
    root.caught("layering-jax", "import jax", "_seeded_jax.py")


def test_reshard_imported_from_core(tmp_path):
    """layering-reshard row 1: reshard/ sits ABOVE core/ --
    any core/ module importing the schedule layer, absolutely or
    relatively, is a finding."""
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_reshard.py",
               "import starway_tpu_torch.reshard\n"
               "from starway_tpu_torch.reshard import plan\n"
               "from ..reshard import tags\n"
               "from starway_tpu_torch import reshard\n"
               "from .. import reshard\n"
    )
    hits = root.findings("layering-reshard")
    assert {f.line for f in hits} == {1, 2, 3, 4, 5}, hits
    root.caught("layering-reshard", "ABOVE core/",
                "_seeded_reshard.py")


def test_jax_bound_outside_reshard_adapter(tmp_path):
    """layering-reshard row 2: under reshard/ only api.py (the adapter)
    may import the framework -- torch in the port, jax in the JAX package
    -- and the planner/executor stay free of it."""
    root = Twin(tmp_path)
    root.write("pkg/reshard/__init__.py", "")
    root.write("pkg/reshard/plan.py",
               "import torch\n"
               "from torch.distributed import DeviceMesh\n",
               jax_text="import jax\n"
                        "from jax.sharding import NamedSharding\n")
    # The adapter itself is exempt: the framework is its whole job.
    root.write("pkg/reshard/api.py", "import torch\n", jax_text="import jax\n")
    hits = root.findings("layering-reshard")
    assert {(f.file.rsplit('/', 1)[-1], f.line) for f in hits} == \
        {("plan.py", 1), ("plan.py", 2)}, hits
    root.caught("layering-reshard", "api.py", "plan.py")


def test_blocking_call_on_engine_thread(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_sleep.py",
               "import time\n"
               "def spin():\n"
               "    time.sleep(0.5)\n"
    )
    root.caught("blocking-call", "time.sleep", "_seeded_sleep.py")


def test_unmarked_multi_gib_test(tmp_path):
    root = Twin(tmp_path)
    root.write("tests/test_torch_seeded_huge.py",
        "def test_moves_4gib():\n"
        "    buf = bytearray(4 << 30)\n"
        "    assert buf\n"
    )
    root.caught("marker-slow", "test_moves_4gib", "test_torch_seeded_huge.py")
    # The same payload behind the marker is allowed.
    root.write("tests/test_torch_seeded_huge.py",
        "import pytest\n"
        "@pytest.mark.slow\n"
        "def test_moves_4gib():\n"
        "    buf = bytearray(4 << 30)\n"
        "    assert buf\n"
    )
    assert root.findings("marker-slow") == []


def test_waiver_with_justification_suppresses(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_jax.py",
               f"import jax  {SWA}(layering-jax): exercising the waiver path\n"
    )
    assert root.findings("layering-jax") == []
    assert root.findings("bad-waiver") == []


def test_waiver_without_justification_is_a_finding(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_jax.py",
               f"import jax  {SWA}(layering-jax)\n"
    )
    assert root.findings("layering-jax") == []  # replaced, not doubled
    root.caught("bad-waiver", "no justification", "_seeded_jax.py")


def test_waiver_unknown_rule_is_a_finding(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_waiver.py",
               f"x = 1  {SWA}(no-such-rule): why\n"
    )
    root.caught("bad-waiver", "no-such-rule", "_seeded_waiver.py")


def test_waiver_above_line_without_justification_single_finding(tmp_path):
    # The above-the-line placement must behave like the same-line one:
    # exactly ONE bad-waiver finding, anchored at the waiver's own line.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_jax.py",
               f"{SWA}(layering-jax)\n"
               "import jax\n"
    )
    for layout in (PORT, JAX):
        findings = root.run_all(layout=layout)
        assert [(f.rule, f.line) for f in findings] == [("bad-waiver", 1)], \
            findings


def test_bad_waiver_in_native_sources_is_audited(tmp_path):
    # Waivers are honoured in every file findings anchor to, so a broken
    # waiver in the C++ sources must be reported too.
    root = Twin(tmp_path)
    root.modify("native/sw_engine.cpp", lambda t: t + "\n// swcheck" + ": allow(contract-reasons): typo'd rule\n")
    root.caught("bad-waiver", "contract-reasons", "sw_engine.cpp")


def test_unparseable_core_file_is_a_finding_in_every_pass(tmp_path):
    # No pass may skip an unparseable file vacuously -- even run standalone
    # -- and the cross-pass copies dedupe to one parse-error finding.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_syntax.py",
               "def broken(:\n")
    for passes in (["layering"], ["concurrency"], None):
        for layout in (PORT, JAX):
            hits = [f for f in root.run_all(passes, layout)
                    if f.rule == "parse-error"]
            assert len(hits) == 1 and \
                hits[0].file.endswith("_seeded_syntax.py"), (passes, hits)


def test_parametrized_multi_gib_payload_is_caught(tmp_path):
    root = Twin(tmp_path)
    root.write("tests/test_torch_seeded_param.py",
               "import pytest\n"
               "@pytest.mark.parametrize('size', [4 << 30])\n"
               "def test_param_big(size):\n"
               "    assert bytearray(size)\n"
    )
    root.caught("marker-slow", "test_param_big",
                "test_torch_seeded_param.py")


def test_hotpath_copy_seeded(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_copy.py",
               "def leak(view, arr):\n"
               "    a = bytes(view)\n"
               "    b = arr.tobytes()\n"
               "    c = bytes([1, 2])\n"
               "    d = bytes(16)\n"
               "    return a, b, c, d\n"
    )
    hits = root.findings("hotpath-copy")
    # Only the buffer copies fire; bytes([..]) / bytes(16) are allocation.
    assert {f.line for f in hits} == {2, 3}, hits
    root.caught("hotpath-copy", "bytes(...)", "_seeded_copy.py")
    root.caught("hotpath-copy", ".tobytes()", "_seeded_copy.py")


def test_hotpath_copy_waiver(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_copy.py",
               "def ok(view):\n"
               f"    return bytes(view)  {SWA}(hotpath-copy): control-sized blob\n"
    )
    assert root.findings("hotpath-copy") == []
    assert root.findings("bad-waiver") == []


def test_hotpath_skips_frames_codec(tmp_path):
    # frames.py is the control-frame codec: its small bounded JSON bodies
    # are exempt by design (documented in analysis/hotpath.py).
    root = Twin(tmp_path)
    root.modify("pkg/core/frames.py", lambda t: t + "\ndef _seeded(v):\n    return bytes(v)\n")
    assert root.findings("hotpath-copy") == []


def test_reachable_blocking_seeded(tmp_path):
    # The sampler bug class: lexically clean under the lock, but a
    # helper one call down blocks.  The direct lint cannot see it; the
    # interprocedural pass must, anchored at the under-lock call site.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_reach.py",
               "import time\n"
               "class Sampler:\n"
               "    def _grab_sample(self):\n"
               "        time.sleep(0.5)\n"
               "    def tick(self):\n"
               "        with self.sample_lock:\n"
               "            self._grab_sample()\n"
    )
    hits = root.findings("reachable-blocking")
    assert any(f.line == 7 for f in hits), hits
    root.caught("reachable-blocking", "time.sleep",
               "_seeded_reach.py")
    # The helper's own direct finding still fires under the v1 rule.
    root.caught("blocking-call", "time.sleep", "_seeded_reach.py")


def test_reachable_blocking_waiver(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_reach.py",
               "import time\n"
               "class Sampler:\n"
               "    def _grab_sample(self):\n"
               f"        time.sleep(0.5)  {SWA}(blocking-call): seeded fixture\n"
               "    def tick(self):\n"
               "        with self.sample_lock:\n"
               f"            self._grab_sample()  {SWA}(reachable-blocking): seeded fixture\n"
    )
    assert root.findings("reachable-blocking") == []
    assert root.findings("blocking-call") == []
    assert root.findings("bad-waiver") == []


def test_reachable_blocking_through_mutual_recursion(tmp_path):
    # Regression (review round): a cycle member probed first must not
    # cache a false 'unreachable' that suppresses a later query through
    # the same cycle -- the answer must not depend on query order.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_cycle.py",
               "import time\n"
               "class S:\n"
               "    def a(self, n):\n"
               "        self.b(n)\n"
               "        self.c(n)\n"
               "    def b(self, n):\n"
               "        self.a(n)\n"
               "    def c(self, n):\n"
               "        time.sleep(0.1)\n"
               "    def early(self):\n"
               "        with self.lock:\n"
               "            self.a(1)\n"
               "    def late(self):\n"
               "        with self.lock:\n"
               "            self.b(1)\n"
    )
    hits = [f for f in root.findings("reachable-blocking")
            if f.file.endswith("_seeded_cycle.py")]
    # BOTH under-lock call sites reach time.sleep (a -> c, b -> a -> c).
    assert {f.line for f in hits} == {12, 15}, hits


def test_duck_attr_while_narrowing(tmp_path):
    # Regression (review round): a while test narrows exactly like an if
    # test -- `while isinstance(item, TxData):` must not flag the body.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_while.py",
               "def pump(conn):\n"
               "    item = conn.tx[0]\n"
               "    while isinstance(item, TxData) and not item.local_done:\n"
               "        item._maybe_local_complete([])\n"
    )
    assert [f for f in root.findings("duck-attr")
            if f.file.endswith("_seeded_while.py")] == []


def test_reachable_callback_under_lock_seeded(tmp_path):
    # A callback invoked one call below the lock: v1's lexical lint is
    # blind to it, v2 follows the call graph (deferred lambdas stay the
    # allowed pattern and must NOT fire).
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_cbreach.py",
               "class W:\n"
               "    def _notify_user(self, done):\n"
               "        done()\n"
               "    def bad(self, done):\n"
               "        with self.lock:\n"
               "            self._notify_user(done)\n"
               "    def good(self, done, fires):\n"
               "        with self.lock:\n"
               "            fires.append(lambda: self._notify_user(done))\n"
    )
    hits = [f for f in root.findings("callback-under-lock")
            if f.file.endswith("_seeded_cbreach.py")]
    assert {f.line for f in hits} == {6}, hits
    assert any("reaches user callback" in f.message for f in hits), hits


def test_lock_order_cycle_seeded(tmp_path):
    # Two functions taking the same two locks in opposite orders: the
    # classic deadlock shape the lock-order graph must close on.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_order.py",
               "import threading\n"
               "a_lock = threading.Lock()\n"
               "b_lock = threading.Lock()\n"
               "def one():\n"
               "    with a_lock:\n"
               "        with b_lock:\n"
               "            pass\n"
               "def two():\n"
               "    with b_lock:\n"
               "        with a_lock:\n"
               "            pass\n"
    )
    root.caught("lock-order", "cycle", "_seeded_order.py")
    hits = root.findings("lock-order")
    assert any("a_lock" in f.message and "b_lock" in f.message
               for f in hits), hits


def test_lock_order_waiver(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_order.py",
               "import threading\n"
               "a_lock = threading.Lock()\n"
               "b_lock = threading.Lock()\n"
               "def one():\n"
               "    with a_lock:\n"
               "        with b_lock:\n"
               "            pass\n"
               "def two():\n"
               "    with b_lock:\n"
               f"        {SWA}(lock-order): seeded fixture, never runs\n"
               "        with a_lock:\n"
               "            pass\n"
    )
    # The anchor is the edge that closes the cycle; with both closing
    # edges waiver-covered the cycle report is suppressed.
    hits = root.findings("lock-order")
    if hits:  # cycle may anchor at the OTHER closing edge -- cover it too
        root.write("pkg/core/_seeded_order.py",
               "import threading\n"
               "a_lock = threading.Lock()\n"
               "b_lock = threading.Lock()\n"
               "def one():\n"
               "    with a_lock:\n"
               f"        {SWA}(lock-order): seeded fixture, never runs\n"
               "        with b_lock:\n"
               "            pass\n"
               "def two():\n"
               "    with b_lock:\n"
               f"        {SWA}(lock-order): seeded fixture, never runs\n"
               "        with a_lock:\n"
               "            pass\n"
        )
        hits = root.findings("lock-order")
    assert hits == [], hits
    assert root.findings("bad-waiver") == []


def test_duck_attr_pr6_regression(tmp_path):
    # THE seeded regression for the duck-type checker: the crash it caught was
    # an unguarded `item.counted` read reaching a TxCtl (whose __slots__
    # lack `counted`) on the engine thread.  Re-introduce exactly that
    # shape and assert swproof flags it at the right line.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_duck.py",
               "def pump(conn, fires):\n"
               "    for item in conn.tx:\n"
               "        if item.counted:\n"
               "            item.e2e_ord = 1\n"
    )
    hits = [f for f in root.findings("duck-attr")
            if f.file.endswith("_seeded_duck.py")]
    assert {f.line for f in hits} == {3, 4}, hits
    assert any("counted" in f.message and "TxCtl" in f.message
               for f in hits), hits


def test_duck_attr_guarded_reads_are_clean(tmp_path):
    # The two sanctioned shapes -- isinstance narrowing and getattr with
    # a default (the actual fix) -- must stay clean.
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_duck.py",
               "def pump(conn):\n"
               "    for item in conn.tx:\n"
               "        if not isinstance(item, TxCtl) and not item.counted:\n"
               "            item.counted = True\n"
               "        if getattr(item, 'switch_after', False):\n"
               "            pass\n"
               "        if isinstance(item, TxData):\n"
               "            item._maybe_local_complete([])\n"
               "        item.advance(1, [])\n"
    )
    assert [f for f in root.findings("duck-attr")
            if f.file.endswith("_seeded_duck.py")] == []


def test_duck_attr_waiver(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_duck.py",
               "def pump(conn):\n"
               "    for item in conn.tx:\n"
               f"        return item.counted  {SWA}(duck-attr): seeded fixture\n"
    )
    assert root.findings("duck-attr") == []
    assert root.findings("bad-waiver") == []


def test_coverage_new_module_outside_surface(tmp_path):
    # A new top-level runtime module that grows a policed primitive must
    # join the lint surface (the metrics.py gap class).
    root = Twin(tmp_path)
    root.write("pkg/_seeded_tail.py", 
               "import time\n"
               "def follow():\n"
               "    time.sleep(0.2)\n"
    )
    root.caught("lint-coverage", "outside the swcheck lint surface",
               "_seeded_tail.py")


def test_coverage_declared_surface_file_missing(tmp_path):
    # A surface file deleted/renamed without updating LINT_EXTRA_FILES is
    # exactly the "pass list post-dates the tree" drift.
    root = Twin(tmp_path)
    root.unlink("pkg/metrics.py")
    hits = root.findings("lint-coverage")
    assert any("does not exist" in f.message for f in hits), hits


def test_coverage_waiver(tmp_path):
    root = Twin(tmp_path)
    root.write("pkg/_seeded_tail.py", 
               "import time\n"
               "def follow():\n"
               f"    time.sleep(0.2)  {SWA}(lint-coverage): seeded fixture\n"
    )
    assert root.findings("lint-coverage") == []
    assert root.findings("bad-waiver") == []


def test_session_py_violation_is_caught(tmp_path):
    # core/session.py post-dated the v1 pass lists; prove the surface
    # audit holds by seeding a violation INTO it and watching it fire.
    root = Twin(tmp_path)
    root.modify("pkg/core/session.py", lambda t: t
                 + "\ndef _seeded_spin():\n    time.sleep(0.5)\n")
    root.caught("blocking-call", "time.sleep", "session.py")


def test_telemetry_py_violation_is_caught(tmp_path):
    root = Twin(tmp_path)
    root.modify("pkg/core/telemetry.py", lambda t: t
                 + "\ndef _seeded_copy(view):\n    return bytes(view)\n")
    root.caught("hotpath-copy", "bytes(...)", "telemetry.py")


def test_metrics_py_violation_is_caught(tmp_path):
    # metrics.py is the file the coverage audit pulled INTO the surface:
    # both the concurrency and hotpath passes must see it now.
    root = Twin(tmp_path)
    root.modify("pkg/metrics.py", lambda t: t
                 + "\ndef _seeded_copy(view):\n    return bytes(view)\n"
               "\ndef _seeded_spin():\n    time.sleep(0.5)\n")
    root.caught("hotpath-copy", "bytes(...)", "metrics.py")
    root.caught("blocking-call", "time.sleep", "metrics.py")




# ------------------------------------------------ the port's own layering


def test_import_torch_in_core(tmp_path):
    # The port's framework is torch: core/ binding it is the finding the
    # JAX package's gate has no reason to make (its core/ may not bind jax).
    root = Twin(tmp_path)
    root.write("pkg/core/_seeded_torch.py",
               "import torch\n"
               "from torch.cuda import Event\n")
    hits = root.findings("layering-jax", parity=False)
    assert {f.line for f in hits} == {1, 2}, hits
    assert root.findings("layering-jax", parity=False) and not [
        f for f in root.run_all(["layering"], JAX) if f.rule == "layering-jax"]


def test_jax_bound_in_the_ports_reshard_adapter(tmp_path):
    # The port's adapter binds torch only: jax stays banned there too.
    root = Twin(tmp_path)
    root.write("pkg/reshard/__init__.py", "")
    root.write("pkg/reshard/api.py", "import torch\nimport jax\n")
    hits = root.findings("layering-reshard", parity=False)
    assert [(f.file, f.line) for f in hits] == [
        ("starway_tpu_torch/reshard/api.py", 2)], hits
