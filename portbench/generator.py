"""The one traffic generator: requests and arrival times from a mix's
parameters (``portbench/traffic/mixes/<mix>.json``) and a seed.

Request ``i`` depends only on (mix, seed, i), so the load generator and the
correctness check make the same request independently. Every mix is
stratified in blocks: each block holds the same set of kinds, lengths and
gaps for every seed, in another order, so seeds change the order of the work
and not its amount. Every request carries one benign salt argument,
``pbk=<index in hex>g<seed tag>``, which makes it unique (no verdict can be
reused) and names it.
"""

from __future__ import annotations

import json
import math
import random
import re
from pathlib import Path

from .reference.evaluate import Request

ROOT = Path(__file__).resolve().parent
SALT_RE = re.compile(r"[?&]pbk=([0-9a-f]+)g")


def canonical(method: str, uri: str, headers, body: bytes) -> Request:
    """A request as ext_proc carries it: a request line without raw spaces,
    lower-case header names, ``host`` first (Envoy's ``:authority``, which
    an HTTP/2 request always has: ``localhost`` where the request had no
    Host; an empty one carries no Host header) and ``content-length`` for a
    body."""
    hs = [(k.lower(), v) for k, v in headers]
    host = next((v for k, v in hs if k == "host"), "localhost")
    rest = tuple((k, v) for k, v in hs if k not in ("host", "content-length"))
    if body:
        rest += (("content-length", str(len(body))),)
    return Request(method, uri.replace(" ", "%20"), ((("host", host),) if host else ()) + rest, body)


def salted(uri: str, index: int, tag: str) -> str:
    return f"{uri}{'&' if '?' in uri else '?'}pbk={index:x}g{tag}"


def index_of(uri: str) -> int | None:
    m = SALT_RE.search(uri)
    return int(m.group(1), 16) if m else None


class Mix:
    """Requests of one mix under one seed, made on demand by index."""

    def __init__(self, name: str, seed: int):
        self.name = name
        self.params = json.loads((ROOT / "traffic" / "mixes" / f"{name}.json").read_text())
        self.seed = seed
        self.tag = f"{random.Random(f'tag:{seed}').randrange(1 << 24):06x}"
        kind = self.params["kind"]
        self.block = int(self.params["block"])
        self._blocks: dict[int, list] = {}
        if kind == "replay":
            doc = json.loads((ROOT / "traffic" / self.params["file"]).read_text())
            self.pool = [_replay_request(r) for r in doc["requests"]]
            self.block = len(self.pool)
        self.kind = kind

    def request(self, i: int) -> Request:
        b, k = divmod(i, self.block)
        items = self._blocks.get(b)
        if items is None:
            if len(self._blocks) > 64:
                self._blocks.clear()
            items = self._blocks[b] = self._make_block(b)
        method, uri, headers, body = items[k]
        return canonical(method, salted(uri, i, self.tag), headers, body)

    def _make_block(self, b: int) -> list:
        rng = random.Random(f"{self.name}:{self.seed}:{b}")
        if self.kind == "replay":
            order = list(range(len(self.pool)))
            rng.shuffle(order)
            return [self.pool[j] for j in order]
        return _synthetic_block(self.params, rng, b)


def _replay_request(r: dict):
    body = r["body"]
    if isinstance(body, dict):
        body = body["repeat"] * body["times"]
    return (r["method"], r["uri"], [tuple(h) for h in r["headers"]], body.encode("latin-1"))


def _quantiles(n: int, fn) -> list:
    return [fn((k + 0.5) / n) for k in range(n)]


def _lognormal(median: float, sigma: float, lo: int, hi: int):
    def q(p: float) -> int:
        # Inverse normal CDF by bisection on math.erf (no scipy needed here).
        a, z = -8.0, 8.0
        for _ in range(60):
            m = (a + z) / 2
            if 0.5 * (1 + math.erf(m / math.sqrt(2))) < p:
                a = m
            else:
                z = m
        return int(min(hi, max(lo, median * math.exp(sigma * a))))
    return q


def _synthetic_block(p: dict, rng: random.Random, b: int) -> list:
    n = int(p["block"])
    n_attack = round(n * p["attack_share"])
    n_post = round(n * p["post_share"])
    kinds = ["attack"] * n_attack + ["benign"] * (n - n_attack)
    posts = [True] * n_post + [False] * (n - n_post)
    rng.shuffle(kinds)
    rng.shuffle(posts)
    lengths = []
    if "body_bytes" in p:
        bb = p["body_bytes"]
        lengths = _quantiles(n_post, _lognormal(bb["median"], bb["sigma"], bb["min"], bb["max"]))
        rng.shuffle(lengths)
    out = []
    for k, (kind, post) in enumerate(zip(kinds, posts)):
        salt = f"{b:x}{k:x}{rng.randrange(1 << 24):06x}"
        headers = [("Host", rng.choice(p["hosts"])), ("User-Agent", rng.choice(p["user_agents"])),
                   ("Accept", "*/*"), ("Cookie", f"session={salt}{rng.randrange(1 << 28):07x}")]
        attack = kind == "attack"
        in_uri = attack and p["attack_in"] == "uri"
        base = rng.choice(p["attack_uris"] if in_uri else p["paths"])
        if not post:
            out.append(("GET", base, headers, b""))
            continue
        body_kind = rng.choice(p["post_bodies"])
        payload = rng.choice(p["attack_values"]) if attack and not in_uri else None
        if body_kind == "json":
            headers.append(("Content-Type", "application/json"))
            body = _json_body(rng, p["words"], lengths.pop() if lengths else 256, payload)
        else:
            headers.append(("Content-Type", "application/x-www-form-urlencoded"))
            body = _form_body(rng, p["words"], lengths.pop() if lengths else 0, payload, k, salt)
        out.append(("POST", base, headers, body))
    return out


def _text(rng: random.Random, words: list, size: int) -> str:
    out, n = [], 0
    while n < size:
        w = rng.choice(words)
        out.append(w)
        n += len(w) + 1
    return " ".join(out)[:max(1, size)]


def _json_body(rng, words, size: int, payload) -> bytes:
    fields, n, k = {}, 0, 0
    while n < size:
        chunk = min(240, size - n)
        fields[f"f{k}"] = _text(rng, words, max(8, chunk - 12))
        n += chunk
        k += 1
    if payload is not None:
        fields[f"f{rng.randrange(max(1, k))}"] = payload
    return json.dumps({"id": rng.randrange(1 << 20), "fields": fields}).encode()


def _form_body(rng, words, size: int, payload, k: int, salt: str) -> bytes:
    if not size:
        body = f"field1=value{k}&tok={salt}&field2={'benign+data+' * rng.randrange(1, 5)}"
        if payload is not None:
            body += "&q=" + _urlencode(payload)
        return body.encode()
    parts, n, j = [], 0, 0
    while n < size:
        v = _urlencode(_text(rng, words, min(240, size - n)))
        parts.append(f"f{j}={v}")
        n += len(parts[-1]) + 1
        j += 1
    if payload is not None:
        parts[rng.randrange(len(parts))] = "q=" + _urlencode(payload)
    return "&".join(parts).encode()


def _urlencode(s: str) -> str:
    safe = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.~")
    return "".join(c if c in safe else ("+" if c == " " else f"%{ord(c):02X}") for c in s)


def arrivals(rate: float, seed: int, start: int, count: int, block: int = 1000) -> list:
    """Due offsets (seconds from the first arrival) of arrivals ``start`` ..
    ``start + count - 1`` of a Poisson stream at ``rate``: each block of
    ``block`` gaps is the same set of exponential quantiles in a seeded order."""
    out, t = [], 0.0
    gaps_cache: dict[int, list] = {}
    for i in range(start + count):
        b, k = divmod(i, block)
        gaps = gaps_cache.get(b)
        if gaps is None:
            gaps = _quantiles(block, lambda q: -math.log(1.0 - q) / rate)
            random.Random(f"gaps:{seed}:{b}").shuffle(gaps)
            gaps_cache = {b: gaps}
        if i >= start:
            out.append(t)
        t += gaps[k]
    return out
