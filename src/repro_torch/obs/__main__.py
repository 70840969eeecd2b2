"""CLI for the observability layer.

Usage::

    python -m repro_torch.obs explain <suite/cell> [--no-cache] [--workers N]
    python -m repro_torch.obs explain --list
    python -m repro_torch.obs metrics [--json]
    python -m repro_torch.obs incident <dump.json> [--rid ID] [--json]

``explain`` re-resolves one benchmark cell (read-through the plan cache
by default, so warmed cells render without re-searching) and prints the
simulated timeline, mesh heatmap and winner-vs-runner-up diff — see
``repro_torch.obs.explain``.  ``metrics`` prints the unified registry snapshot
of this process (mostly useful after an in-process run; launchers and
benchmarks honor ``REPRO_METRICS=<path>`` to persist theirs).
``incident`` renders a flight-recorder dump (``REPRO_FLIGHTREC=<path>``
or ``serve.py --flightrec``) as per-request/incident timelines: which
rung answered, why, how long each step took, what it displaced.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("explain", help="render one benchmark cell")
    ex.add_argument("cell", nargs="?",
                    help="plan_speed cell name, e.g. "
                         "gemm/wormhole_8x8/M1024_N1024_K4096 or "
                         "pipeline/mlp2/M16384_d128_f512")
    ex.add_argument("--list", action="store_true",
                    help="print the resolvable cell names and exit")
    ex.add_argument("--no-cache", action="store_true",
                    help="plan cold instead of read-through the plan cache")
    ex.add_argument("--workers", type=int, default=1,
                    help="planner worker count for the resolve (default 1)")
    mt = sub.add_parser("metrics", help="print this process's registry")
    mt.add_argument("--json", action="store_true", dest="as_json",
                    help="raw JSON snapshot (default: same)")
    inc = sub.add_parser("incident",
                         help="render a flight-recorder dump as "
                              "per-request timelines")
    inc.add_argument("dump", help="dump path (REPRO_FLIGHTREC / "
                                  "serve.py --flightrec output)")
    inc.add_argument("--rid", default=None,
                     help="only the timeline of one request/incident ID")
    inc.add_argument("--json", action="store_true", dest="as_json",
                     help="print the raw dump JSON instead of rendering")
    args = ap.parse_args(argv)

    if args.cmd == "metrics":
        print(json.dumps(metrics.snapshot(), indent=1, sort_keys=True))
        return 0

    if args.cmd == "incident":
        from . import flightrec
        try:
            doc = flightrec.load_dump(args.dump)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.as_json:
            print(json.dumps(doc, indent=1, sort_keys=True))
        else:
            print(flightrec.render_incident(doc, rid=args.rid))
        return 0

    from . import explain as ex_mod
    if args.list:
        for name in ex_mod.known_cells():
            print(name)
        return 0
    if not args.cell:
        ap.error("explain needs a cell name (or --list)")
    cache = None
    if not args.no_cache:
        from repro_torch.plancache import PlanCache
        cache = PlanCache()
    try:
        print(ex_mod.explain(args.cell, cache=cache, workers=args.workers))
    except ex_mod.CellError as e:
        print(f"error: {e}", file=sys.stderr)
        print("use --list for resolvable cells", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
