"""The check's control: the reference with one guarantee of the
configuration broken, put in the program's place, judged by the same
comparison as a run. It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--requests N]

For each seed it takes the requests a run of the cell would sample (the
check's own rule, over the first ``--requests`` requests after the
warm-up: about what a window answers) and prints the numbers compared, each
beside its limit. The configuration's ``control`` names the broken
guarantee: ``tx`` overrides (a lower paranoia level) or ``engine``
(``DetectionOnly``: nothing blocked). Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.check import compare, expected_reply, sample  # noqa: E402
from portbench.generator import Mix  # noqa: E402
from portbench.harness import ruleset_text  # noqa: E402
from portbench.reference.evaluate import Reference  # noqa: E402
from portbench.run import load_cell  # noqa: E402


def control_numbers(cell, seed: int, n_requests: int) -> dict:
    text = ruleset_text(cell.config)
    ctl = cell.config["control"]
    control = Reference(text, tx=ctl.get("tx"), engine=ctl.get("engine"))
    mix = Mix(cell.traffic["mix"], seed)
    warm = cell.traffic["warm_requests"]
    window = list(range(warm, warm + n_requests))
    picked = sample(window, seed, cell.config["check"]["requests"])
    replies, captured = {}, {}
    for i in picked:
        v = control.evaluate(mix.request(i))
        replies[i] = expected_reply(v)
        captured[i] = (mix.request(i), v)
    diff = compare(Reference(text), mix, picked, replies, captured)
    return {"seed": seed, "compared": len(picked),
            "replies": {"value": diff["replies"], "limit": 0},
            "verdicts": {"value": diff["verdicts"], "limit": 0},
            "correct": diff["replies"] == 0 and diff["verdicts"] == 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(control_numbers(cell, int(s), args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
