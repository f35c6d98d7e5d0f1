"""The virtual-patch generator (``portbench/vpatch.py``): its committed
output is what its seed gives, and its mix holds what its name says, under
the benchmark's plain reference (``portbench/reference``)."""

import json
import re

import pytest

from portbench import vpatch
from portbench.generator import canonical
from portbench.reference.evaluate import Reference

MIX = json.loads(vpatch.MIX.read_text())
LINES = vpatch.RULES.read_text().splitlines()[3:]  # two lines per patch


def test_committed_files_are_the_seeds_output():
    rules, mix = vpatch.render()
    assert vpatch.RULES.read_text() == rules
    assert vpatch.MIX.read_text() == mix
    assert vpatch.main(["--check"]) == 0
    assert len(LINES) == 2 * vpatch.N_PATCHES
    assert LINES[0].startswith(f'SecRule REQUEST_FILENAME "@streq /svc0/ep0.php" "id:{vpatch.FIRST_ID},')
    ids = [int(m) for m in re.findall(r"id:(\d+),", vpatch.RULES.read_text())]
    assert ids == list(range(10000, 15000))
    assert sum("@beginsWith" in line for line in LINES) == vpatch.N_PATCHES // 10


def _patch_of(uri: str) -> int:
    m = re.match(r"/svc(\d+)/ep(\d+)[./]", uri)
    return int(m[1]) * vpatch.ENDPOINTS + int(m[2])


def _fires(uri: str) -> bool:
    """Whether the URI's own patch, alone under the reference, matches it."""
    i = _patch_of(uri)
    ref = Reference("SecRuleEngine On\n" + "\n".join(LINES[2 * i: 2 * i + 2]))
    verdict = ref.evaluate(canonical("GET", uri, [("Host", "bench.local")], b""))
    return vpatch.FIRST_ID + i in verdict.matched_ids


@pytest.mark.parametrize("part", ["paths", "attack_uris"])
def test_paths_pass_and_patched_attacks_fail_their_patch(part):
    n = MIX["patched_attacks"]
    uris = MIX[part] if part == "paths" else MIX[part][:n]
    assert len(uris) == (vpatch.N_PATHS if part == "paths" else vpatch.N_ATTACKS)
    assert len({_patch_of(u) for u in uris}) == len(uris)
    fired = [u for u in uris if _fires(u)]
    if part == "paths":
        assert not fired, fired[:3]
    else:
        assert fired == uris
        assert MIX[part][n:] == json.loads(
            (vpatch.BENCH / "traffic" / "mixes" / "browse.json").read_text())["attack_uris"]
