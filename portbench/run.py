"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell; the cell
names its configuration (``configs``' ``file``) and its traffic
(``portbench/traffic/<traffic>.json``: the mix, the loop and the warm-up);
each per-layer metric is read by ``portbench/metrics/<name before the first
dot>.py``. With ``--trace 0`` the last line of standard output carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
device trace's busy and window seconds. Exits 3, printing no result, when no
card is there (it never falls back to the CPU), 4 when the process has
loaded JAX or the JAX package, and 5 when the run has not ended in 330 s.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check as check_mod  # noqa: E402
from portbench.generator import Mix  # noqa: E402
from portbench.stats import window_numbers  # noqa: E402

BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "coraza_kubernetes_operator_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclass
class RunData:
    """What a per-layer reader may read (``portbench/metrics/*.py``)."""

    seconds: float
    c0: dict
    c1: dict
    windows: list
    latencies_ms: list
    profile: dict | None = None


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{work['traffic']}.json").read_text())
    return Cell(name, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    family = metric.split(".", 1)[0]
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{family}",
                                                  BENCH / "metrics" / f"{family}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_environment(config: dict) -> None:
    """The configuration's knobs, and every build cache inside the checkout."""
    for k, v in config.get("env", {}).items():
        os.environ[k] = str(v)
    os.environ["CKO_COMPILE_CACHE_DIR"] = str(ROOT / "build")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str | None = None) -> dict:
    """One run; ``device`` None is the card. Returns the result object
    (without ``device``) and the compared numbers."""
    from portbench import harness

    set_environment(cell.config)
    got = harness.run_sidecar(cell.config, cell.traffic, seed, seconds, device, trace=trace)
    closed = cell.traffic["load"]["loop"] == "closed"
    load = got["load"]
    w = window_numbers(load, closed, seconds)
    t0, t1 = load["window"]
    probes = got["probes"]
    result = {"setup_s": got["t_warm"] - T_START, **w, "window": [t0, t1]}
    if got["profile"] is None:
        windows = [x for x in probes.windows if t0 <= x[0] < t1]
        run = RunData(seconds, got["c0"], got["c1"], windows, w["latencies_ms"])
    else:
        # Host-side readings from the window before the profiler started.
        from portbench.profile import summarize

        t_mid = got["c_mid"]["t"]
        before = [r for r in load["records"] if r[3] is not None and r[3] < t_mid]
        w_host = window_numbers(dict(load, window=[t0, t_mid], records=before), closed, t_mid - t0)
        windows = [x for x in probes.windows if t0 <= x[0] < t_mid]
        run = RunData(t_mid - t0, got["c0"], got["c_mid"], windows, w_host["latencies_ms"])
        prof = summarize(got["profile"])
        run.profile = prof
        result["profile"] = prof
        # How the slice went: guarded by the capture lock or not, cut short
        # by a capture or not, the longest a capture waited for the profiler
        # to stop, and the graph captures and first sights from its start to
        # the window's end.
        result["slice"] = {k: got["profile"][k]
                           for k in ("guarded", "cut_by_capture", "longest_capture_wait_s")}
        result["slice"].update(
            traced_s=prof["window_s"],
            graph_captures=got["c1"]["graph_captures"] - got["c_mid"]["graph_captures"],
            graph_misses=got["c1"]["graph_misses"] - got["c_mid"]["graph_misses"])
    result["run"] = run
    mix = Mix(cell.traffic["mix"], seed)
    from portbench.harness import ruleset_text
    fallback = got["c1"]["fallback_requests"] - got["c0"]["fallback_requests"]
    ok, numbers, details = check_mod.check(cell.config, ruleset_text(cell.config), mix, seed,
                                           w["answered"], probes.verdicts, w["failed"], fallback)
    result.update(correct=ok, checks=numbers, check_details=details)
    return result


def metrics_of(cell: Cell, res: dict, trace: bool) -> dict:
    out = {}
    if not trace:
        values = {"setup_s": res["setup_s"], "req_per_s": res["req_per_s"]}
        if res["latencies_ms"]:
            from portbench.stats import percentile
            values["p50_ms"] = percentile(res["latencies_ms"], 50)
        for m in cell.end_to_end:
            if m["name"] in values:
                out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = reader(m["name"])(res["run"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _hung() -> None:
    from portbench import harness

    print("portbench: the run did not end within 330 s", file=sys.stderr, flush=True)
    for proc in list(harness.CHILDREN):
        proc.kill()
        proc.wait()
    os._exit(5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device; this benchmark runs only on the card", file=sys.stderr)
        return 3
    # A run that has not ended well inside the driver's 360 s has hung:
    # end it, with no result, rather than hold the card.
    watchdog = threading.Timer(330.0, _hung)
    watchdog.daemon = True
    watchdog.start()
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": peak}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics_of(cell, res, bool(args.trace)), "device": device}
    if args.trace:
        prof = res["profile"]
        device["busy_s"], device["window_s"] = prof["busy_s"], prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    out["info"] = {"late_p50_ms": res["late_p50_ms"], "late_max_ms": res["late_max_ms"],
                   "compared": res["check_details"]["compared"],
                   "reference_s": res["check_details"]["reference_s"],
                   "first_differences": res["check_details"]["first_differences"],
                   "first_failed": res["first_failed"]}
    if args.trace:
        out["info"]["slice"] = res["slice"]
        print(f"traced slice: {json.dumps(res['slice'])}", file=sys.stderr)
    out["checks"] = res["checks"]
    for name, n in res["checks"].items():
        print(f"check {name}: {n['value']} (limit {n['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, default=str))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
