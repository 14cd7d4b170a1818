"""CLI entry: ``python -m starway_tpu_torch.analysis [--root DIR] [pass ...]``.

Exit status 0 = contract holds; 1 = findings (printed one per line as
``file:line: [rule] message`` -- the shape .github/swcheck-matcher.json
turns into PR diff annotations); 2 = usage error.  ``--json`` emits one
machine-readable document instead (findings + per-pass timings);
``--timings`` prints per-pass wall time to stderr.  Stdlib-only.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import PASSES, RULES, find_root, run_all


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m starway_tpu_torch.analysis",
        description="swcheck/swproof: cross-engine contract checker, "
                    "concurrency lint, protocol state-machine diff, and "
                    "session model checking (DESIGN.md §11, §16)",
    )
    parser.add_argument("passes", nargs="*", metavar="pass",
                        help=f"subset of passes to run ({', '.join(PASSES)}); "
                             "default: all")
    parser.add_argument("--root", default=None,
                        help="repo root (default: autodetect from cwd or the "
                             "package location)")
    parser.add_argument("--rules", action="store_true",
                        help="list every rule name (waiver targets) and exit")
    parser.add_argument("--replay", metavar="DUMP", default=None,
                        help="swrefine: replay a swtrace ring dump "
                             "(swtrace.write_ring_dump) or flight-recorder "
                             "JSON through the protocol monitor and report "
                             "divergences (DESIGN.md §22); implies the "
                             "refine pass only")
    parser.add_argument("--write-budgets", action="store_true",
                        help="swcost: re-pin analysis/cost_budgets.txt from "
                             "the current extraction (the ratchet update "
                             "step; DESIGN.md §23) and exit")
    parser.add_argument("--minimize", action="store_true",
                        help="wirefuzz: dedup the regression corpus by "
                             "canonical-outcome signature (keeps every "
                             "pinned hex case and the corpus floor), "
                             "rewrite it in place, and exit")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings + timings as one JSON document "
                             "on stdout (exit status semantics unchanged)")
    parser.add_argument("--timings", action="store_true",
                        help="print per-pass wall time to stderr")
    args = parser.parse_args(argv)

    if args.rules:
        for name, desc in sorted(RULES.items()):
            print(f"{name:22s} {desc}")
        return 0

    if args.replay is not None:
        from . import refine

        viols = refine.replay_dump(args.replay,
                                   find_root(args.root) if args.root else None)
        if args.as_json:
            print(json.dumps({
                "dump": args.replay,
                "violations": [
                    {"label": v.label, "conn": v.conn, "index": v.index,
                     "class": v.cls, "message": v.message,
                     "context": v.context}
                    for v in viols
                ],
                "ok": not viols,
            }, indent=1))
        else:
            for v in viols:
                print(v.render())
        if viols:
            print(f"refine: {len(viols)} divergence(s) in {args.replay}",
                  file=sys.stderr)
            return 1
        print(f"refine: OK (replayed {args.replay})", file=sys.stderr)
        return 0

    unknown = [p for p in args.passes if p not in PASSES]
    if unknown:
        parser.error(f"unknown pass(es) {unknown}; choose from "
                     f"{', '.join(PASSES)}")

    if args.write_budgets:
        from . import cost

        root = find_root(args.root)
        vectors, vac = cost.extract(root)
        if vac:
            for f in vac:
                print(f.render())
            print("swcost: extraction is not clean; fix the anchors "
                  "before re-pinning", file=sys.stderr)
            return 1
        path = root / cost.LEDGER_REL
        path.write_text(cost.render_ledger(vectors))
        print(f"swcost: wrote {path} ({len(vectors)} rows)", file=sys.stderr)
        return 0

    if args.minimize:
        from . import wirefuzz

        root = find_root(args.root)
        report = wirefuzz.minimize_corpus(root)
        print("wirefuzz: corpus {path}: {before} -> {after} case(s) "
              "({hex_kept} pinned hex case(s) kept, floor {floor})"
              .format(**report), file=sys.stderr)
        return 0

    root = find_root(args.root)
    timings: dict = {}
    findings = run_all(root, args.passes or None, timings=timings)
    ran = ", ".join(args.passes or PASSES)
    if args.as_json:
        print(json.dumps({
            "root": str(root),
            "passes": list(args.passes or PASSES),
            "findings": [
                {"file": f.file, "line": f.line, "rule": f.rule,
                 "message": f.message}
                for f in findings
            ],
            "timings_s": {k: round(v, 4) for k, v in timings.items()},
            "ok": not findings,
        }, indent=1))
    else:
        for f in findings:
            print(f.render())
    if args.timings:
        total = sum(timings.values())
        for name, secs in timings.items():
            print(f"swcheck: pass {name:12s} {secs * 1000:8.1f} ms",
                  file=sys.stderr)
        print(f"swcheck: total {total * 1000:.1f} ms", file=sys.stderr)
    if findings:
        print(f"swcheck: {len(findings)} finding(s) [{ran}] in {root}",
              file=sys.stderr)
        return 1
    print(f"swcheck: OK [{ran}] in {root}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
