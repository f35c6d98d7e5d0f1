"""How ``correct`` is decided: the timed path's answers against the plain
reference (``portbench/reference``), after the window has closed.

A sample of the window's answered requests, drawn from the seed (every one
when the configuration asks for ``"all"``), is evaluated by the reference on
the request the generator made. Compared, each with the limit 0 (the
comparison is exact):

- ``replies``: the ext_proc reply the client got (status, ``x-waf-action``,
  ``x-waf-rule-id``) against the reply the reference's verdict gives;
- ``verdicts``: the engine's ``Verdict`` for that request (interrupted,
  status, interrupting rule, matched rule ids, anomaly scores), captured at
  ``record_verdict``, against the reference's;
- ``requests``: the request as the sidecar decoded it from ext_proc against
  the one the generator sent;
- ``failed``: the window's requests that got no verdict: refused, shed or
  timed out (408, 429, 5xx), or never answered;
- ``fallback``: the requests the sidecar's degraded mode answered from its
  host fallback on the CPU in the window (its breaker open or the device
  lost): a window answered off the card is not the system under test.
"""

from __future__ import annotations

import random
import time

from .generator import Mix
from .reference.evaluate import Reference, Verdict

SHED = {429, 500, 502, 503, 504}


def expected_reply(v: Verdict) -> tuple:
    if v.interrupted:
        return (v.status, "deny", str(v.rule_id or 0))
    return (200, "allow", None)


def verdict_key(v) -> tuple:
    return (bool(v.interrupted), int(v.status), v.rule_id, tuple(sorted(v.matched_ids)),
            tuple(sorted(v.scores.items())))


def sample(indices: list, seed: int, size) -> list:
    if size == "all" or len(indices) <= int(size):
        return sorted(indices)
    return sorted(random.Random(f"check:{seed}").sample(sorted(indices), int(size)))


def compare(reference: Reference, mix: Mix, picked: list, replies: dict, captured: dict) -> dict:
    """Counts of differences over ``picked`` request indices; ``replies``:
    index -> (status, action, rule id); ``captured``: index -> (request,
    verdict) as the program saw them (missing: counted as a difference)."""
    bad_replies = bad_verdicts = bad_requests = 0
    first = []
    for i in picked:
        req = mix.request(i)
        want = reference.evaluate(req)
        got_reply = replies[i]
        if got_reply != expected_reply(want):
            bad_replies += 1
            first.append(("reply", i, req.uri[:120], got_reply, expected_reply(want)))
        seen = captured.get(i)
        if seen is None or verdict_key(seen[1]) != want.key():
            bad_verdicts += 1
            first.append(("verdict", i, req.uri[:120], seen and verdict_key(seen[1]), want.key()))
        if seen is None or (seen[0].method, seen[0].uri, tuple(seen[0].headers), seen[0].body) != (
                req.method, req.uri, req.headers, req.body):
            bad_requests += 1
            first.append(("request", i, req.uri[:120], seen and (seen[0].method, seen[0].uri[:120],
                                                              tuple(seen[0].headers), len(seen[0].body)),
                          (req.method, req.uri[:120], req.headers, len(req.body))))
    return {"replies": bad_replies, "verdicts": bad_verdicts, "requests": bad_requests,
            "first_differences": first[:5]}


def check(cfg: dict, text: str, mix: Mix, seed: int, answered: dict,
          captured: dict, failed: int, fallback: int) -> tuple[bool, dict, dict]:
    """(correct, the numbers compared with their limits, details)."""
    t0 = time.monotonic()
    reference = Reference(text)
    picked = sample(list(answered), seed, cfg["check"]["requests"])
    diff = compare(reference, mix, picked, answered, captured)
    numbers = {
        "replies": {"value": diff["replies"], "limit": 0},
        "verdicts": {"value": diff["verdicts"], "limit": 0},
        "requests": {"value": diff["requests"], "limit": 0},
        "failed": {"value": failed, "limit": 0},
        "fallback": {"value": fallback, "limit": 0},
    }
    ok = bool(picked) and all(n["value"] <= n["limit"] for n in numbers.values())
    details = {"compared": len(picked), "reference_s": time.monotonic() - t0,
               "first_differences": diff["first_differences"]}
    return ok, numbers, details
