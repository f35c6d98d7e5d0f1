"""Find a cell's knee: one sidecar, its traffic's mix driven at several fixed
open-loop rates (or closed-loop stream counts) in turn, one JSON line each.

    python3 portbench/sweep.py --workload crs-lite.browse.open80 --seed 7 \\
        --seconds 8 --rates 150,200,250,300 [--streams 2,4,8]

The knee is the highest rate whose replies keep up with the offer with
nothing refused; ``BENCHMARK.json``'s open-loop cells are set from it once.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.run import load_cell, set_environment  # noqa: E402
from portbench.stats import percentile, window_numbers  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--streams", default="")
    ap.add_argument("--warm", type=int, default=500)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    set_environment(cell.config)
    serving = harness.Serving(cell.config, None)
    try:
        loads = [{"loop": "open", "connections": 8, "rate": float(r)} for r in args.rates.split(",") if r]
        loads += [{"loop": "closed", "connections": 8, "streams": int(s)} for s in args.streams.split(",") if s]
        for k, load in enumerate(loads):
            traffic = dict(cell.traffic, load=load,
                           warm_requests=cell.traffic["warm_requests"] if k == 0 else args.warm)
            got = serving.drive(traffic, args.seed + k, args.seconds)
            w = window_numbers(got["load"], load["loop"] == "closed", args.seconds)
            c0, c1 = got["c0"], got["c1"]
            lat = w["latencies_ms"]
            print(json.dumps({
                "load": load, "attempted": w["attempted"], "failed": w["failed"],
                "replies_per_s": w["req_per_s"],
                "p50_ms": percentile(lat, 50) if lat else None,
                "p99_ms": percentile(lat, 99) if lat else None,
                "late_p50_ms": w["late_p50_ms"], "late_max_ms": w["late_max_ms"],
                "window_requests": (c1["requests"] - c0["requests"]) / max(1, c1["batches"] - c0["batches"]),
                "graph_misses": c1["graph_misses"] - c0["graph_misses"],
                "graph_hits": c1["graph_hits"] - c0["graph_hits"],
            }), flush=True)
    finally:
        serving.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
