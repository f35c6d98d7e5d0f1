"""The plain reference gives the go-ftw corpus's expected statuses, and the
controls differ from it."""

import json
from pathlib import Path

import pytest

from portbench.generator import canonical
from portbench.harness import ruleset_text
from portbench.reference.evaluate import Reference
from portbench.run import load_cell

FTW = json.loads((Path(__file__).resolve().parents[1] / "traffic" / "ftw-requests.json").read_text())
PICKS = ["905100-1", "911100-1", "911100-2", "920170-1", "941100-1", "942100-1", "932100-1",
         "930100-1"]


@pytest.fixture(scope="module")
def crs():
    return Reference(ruleset_text(load_cell("crs-lite.ftw-replay.c64").config))


@pytest.mark.parametrize("test", PICKS)
def test_ftw_expected_status(crs, test):
    r = next(r for r in FTW["requests"] if r["test"] == test)
    body = r["body"] if isinstance(r["body"], str) else r["body"]["repeat"] * r["body"]["times"]
    req = canonical(r["method"], r["uri"], r["headers"], body.encode("latin-1"))
    assert crs.evaluate(req).status in r["status"]


def test_control_blocks_nothing(crs):
    cfg = load_cell("crs-lite.ftw-replay.c64").config
    control = Reference(ruleset_text(cfg), engine=cfg["control"]["engine"])
    r = next(r for r in FTW["requests"] if r["test"] == "911100-1")
    req = canonical(r["method"], r["uri"], r["headers"], b"")
    assert crs.evaluate(req).interrupted and not control.evaluate(req).interrupted
