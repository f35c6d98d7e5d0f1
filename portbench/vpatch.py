"""Writes the virtual-patch ruleset of ``crs-lite-pl2-vp5k`` and its mix.

    python3 portbench/vpatch.py           # write both files
    python3 portbench/vpatch.py --check   # exit 1 unless both are as written

A shared ingress fronts 250 services of 20 endpoints each. Each endpoint has
one vulnerable parameter, and a scan gave it one virtual patch in the shape
of the OWASP Virtual Patching Cheat Sheet: a chained rule that gates on the
endpoint's path, then allows only the values the parameter may take. The
anomaly score rides the chain's first rule, which ModSecurity applies when
the whole chain matches: the engine and the plain reference apply a chain's
``setvar`` only from its first rule.

- ``configs/crs-lite-pl2-vp5k/VIRTUAL-PATCHES.conf``: 5,000 patches, ids
  10000-14999. Patch ``i`` guards ``/svc<i // 20>/ep<i % 20>.php`` with
  ``@streq``; one in ten guards the prefix ``/svc<a>/ep<e>/`` with
  ``@beginsWith`` instead.
- ``traffic/mixes/vpatch.json``: the ``vpatch`` mix. Its ``paths`` are 1,000
  URIs to patched endpoints, the patched parameter at a value its allow-list
  accepts, beside one parameter no patch names; its ``attack_uris`` are 200
  URIs to patched endpoints with the parameter at a value every allow-list
  rejects, then browse's eight attack URIs.

Every choice comes from ``SEED``, so the output is the same on every run.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
RULES = BENCH / "configs" / "crs-lite-pl2-vp5k" / "VIRTUAL-PATCHES.conf"
MIX = BENCH / "traffic" / "mixes" / "vpatch.json"
SEED = 16
FIRST_ID = 10000
SERVICES = 250
ENDPOINTS = 20
N_PATCHES = SERVICES * ENDPOINTS
N_PATHS = 1000
N_ATTACKS = 200

PARAMS = ("id", "page", "user", "email", "sort", "order", "lang", "date", "token", "item",
          "category", "ref", "sku", "uid", "cid", "pid", "q", "tag", "view", "step", "mode",
          "key", "slug", "code")
ALLOW = (
    r"^[0-9]{1,10}$",
    r"^[a-z0-9-]{1,64}$",
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$",
    r"^(asc|desc)$",
    r"^[0-9]{4}-[0-9]{2}-[0-9]{2}$",
    r"^[a-z0-9._-]{1,64}@[a-z0-9-]{1,63}(\.[a-z0-9-]{1,63}){1,3}$",
    r"^[A-Za-z0-9+/=]{0,512}$",
    r"^[a-z]{2}(-[A-Z]{2})?$",
)
# Values every allow-list rejects: SQLi-, XSS- and traversal-shaped.
ATTACKS = (
    "1' OR '1'='1",
    "1 UNION SELECT password FROM users--",
    "x'; DROP TABLE orders;--",
    "<script>alert(1)</script>",
    "\"><img src=x onerror=alert(document.cookie)>",
    "javascript:alert(1)",
    "../../../../etc/passwd",
    "..\\..\\windows\\win.ini",
)
WORDS = ("blue", "red", "summer", "sale", "widget", "gadget", "north", "home", "garden", "kids",
         "sport", "winter", "classic", "pro", "mini", "max")


def patches(rng: random.Random) -> list:
    """(path gate operator, gate argument, parameter, allow-list index) per patch."""
    prefix = set(rng.sample(range(N_PATCHES), N_PATCHES // 10))
    out = []
    for i in range(N_PATCHES):
        a, e = divmod(i, ENDPOINTS)
        gate = ("beginsWith", f"/svc{a}/ep{e}/") if i in prefix else ("streq", f"/svc{a}/ep{e}.php")
        out.append((*gate, rng.choice(PARAMS), rng.randrange(len(ALLOW))))
    return out


def rules_text(plist: list) -> str:
    head = ["# Virtual patches: one chained rule per vulnerable endpoint parameter, in the shape of",
            "# the OWASP Virtual Patching Cheat Sheet. Written by portbench/vpatch.py; do not edit.", ""]
    out = []
    for i, (op, arg, param, allow) in enumerate(plist):
        out.append(
            f'SecRule REQUEST_FILENAME "@{op} {arg}" "id:{FIRST_ID + i},phase:2,block,t:none,'
            f"msg:'virtual patch {i}',tag:'virtual-patch',severity:'CRITICAL',"
            f"setvar:'tx.inbound_anomaly_score=+%{{tx.critical_anomaly_score}}',chain\"\n"
            f'    SecRule ARGS:{param} "!@rx {ALLOW[allow]}" "t:none,t:urlDecodeUni"')
    return "\n".join(head + out) + "\n"


def allowed_value(rng: random.Random, allow: int) -> str:
    """A value allow-list ``allow`` accepts."""
    if allow == 0:
        return str(rng.randrange(1, 10 ** rng.randint(1, 10)))
    if allow == 1:
        return "-".join(rng.choice(WORDS) for _ in range(rng.randint(1, 3))) + f"-{rng.randrange(100)}"
    if allow == 2:
        h = f"{rng.getrandbits(128):032x}"
        return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"
    if allow == 3:
        return rng.choice(("asc", "desc"))
    if allow == 4:
        return f"{rng.randint(2015, 2026)}-{rng.randint(1, 12):02d}-{rng.randint(1, 28):02d}"
    if allow == 5:
        return f"{rng.choice(WORDS)}.{rng.choice(WORDS)}{rng.randrange(100)}@{rng.choice(WORDS)}-mail.example"
    if allow == 6:
        # No '+': urlDecodeUni turns it into a space, which the list rejects.
        abc = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789/"
        return "".join(rng.choice(abc) for _ in range(4 * rng.randint(4, 24))) + rng.choice(("", "=", "=="))
    return rng.choice(("en", "de", "fr", "es", "pt-BR", "en-US", "de-AT", "ja"))


def encode(value: str) -> str:
    safe = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.~")
    return "".join(c if c in safe else f"%{ord(c):02X}" for c in value)


def endpoint_path(rng: random.Random, op: str, arg: str) -> str:
    return arg + rng.choice(("view", "list", f"item{rng.randrange(1000)}")) if op == "beginsWith" else arg


def uri(rng: random.Random, patch: tuple, value: str) -> str:
    op, arg, param, _allow = patch
    other = rng.choice([p for p in PARAMS if p != param])
    return (f"{endpoint_path(rng, op, arg)}?{param}={encode(value)}"
            f"&{other}={rng.choice(WORDS)}{rng.randrange(100)}")


def mix(rng: random.Random, plist: list) -> dict:
    browse = json.loads((BENCH / "traffic" / "mixes" / "browse.json").read_text())
    paths = [uri(rng, plist[i], allowed_value(rng, plist[i][3]))
             for i in sorted(rng.sample(range(N_PATCHES), N_PATHS))]
    attacks = [uri(rng, plist[i], rng.choice(ATTACKS))
               for i in sorted(rng.sample(range(N_PATCHES), N_ATTACKS))]
    return {
        "kind": "synthetic",
        "what": ("requests to the endpoints of crs-lite-pl2-vp5k's virtual patches, the patched "
                 "parameter at an allowed value beside an unpatched one, with a few rejected values "
                 "and browse's CRS attack URIs: its shares are the cell's parameters, not a "
                 "measurement of any site's traffic. Written by portbench/vpatch.py"),
        "block": 100,
        "attack_share": 0.05,
        "post_share": 0.3,
        "attack_in": "uri",
        "post_bodies": ["form"],
        "paths": paths,
        "attack_uris": attacks + browse["attack_uris"],
        "patched_attacks": N_ATTACKS,
        "hosts": browse["hosts"],
        "user_agents": browse["user_agents"],
        "attack_values": [],
        "words": [],
    }


def render() -> tuple[str, str]:
    """(the rule file's text, the mix's JSON text)."""
    rng = random.Random(f"vpatch:{SEED}")
    plist = patches(rng)
    return rules_text(plist), json.dumps(mix(rng, plist), indent=1) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="compare with the files instead of writing")
    args = ap.parse_args(argv)
    rules, mix_text = render()
    if args.check:
        same = RULES.read_text() == rules and MIX.read_text() == mix_text
        print("vpatch: files are as written" if same else "vpatch: files differ", file=sys.stderr)
        return 0 if same else 1
    RULES.parent.mkdir(parents=True, exist_ok=True)
    RULES.write_text(rules)
    MIX.write_text(mix_text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
