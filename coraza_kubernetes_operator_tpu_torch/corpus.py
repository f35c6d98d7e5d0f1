"""Shared rule/request corpus for benchmarks, the graft entry and tests.

``sample_rules()`` mirrors the reference's sample RuleSet
(``config/samples/ruleset.yaml``: base config + SQLi + XSS + evil-monkey).
``synthetic_crs(n)`` generates a CRS-shaped ruleset (anomaly-scoring
paranoia-style rules across attack categories) scaling to the
``BASELINE.json`` configs (full CRS ≈ 800 rules; +5k synthetic @rx).
``synthetic_requests(n)`` generates a benign/attack request mix shaped like
the go-ftw corpus traffic.
"""

from __future__ import annotations

import random

from .engine.request import HttpRequest

BASE_RULES = """
SecRuleEngine On
SecRequestBodyAccess On
SecRequestBodyLimit 131072
SecRequestBodyInMemoryLimit 131072
SecRequestBodyLimitAction Reject
SecResponseBodyAccess Off
SecAuditEngine RelevantOnly
SecAuditLog /dev/stdout
SecAuditLogFormat JSON
SecDefaultAction "phase:1,log,auditlog,pass"
SecDefaultAction "phase:2,log,auditlog,deny,status:403"
"""

SQLI_RULE = r"""
SecRule ARGS "@rx (?i:(\b(select|union|insert|update|delete|drop|create|alter|exec|execute)\b.*\b(from|into|where|table|database|procedure)\b)|(\b(or|and)\b\s*['\"]?\d+['\"]?\s*=\s*['\"]?\d+)|('.*or.*'.*=.*'))" \
  "id:1001,phase:2,block,t:none,t:urlDecodeUni,msg:'SQL Injection Attack Detected',tag:'attack-sqli',severity:'CRITICAL'"
"""

XSS_RULE = r"""
SecRule ARGS "@rx (?i:<script[^>]*>.*?</script>|javascript:|onerror\s*=|onload\s*=|<iframe)" \
  "id:2001,phase:2,block,t:none,t:urlDecodeUni,t:htmlEntityDecode,msg:'XSS Attack Detected',tag:'attack-xss',severity:'CRITICAL'"
"""

EVIL_MONKEY_RULE = r"""
SecRule ARGS|REQUEST_URI|REQUEST_HEADERS "@contains evilmonkey" \
  "id:3001,phase:2,deny,status:403,t:none,t:urlDecodeUni,msg:'Evil Monkey Detected',tag:'monkey-attack',severity:'CRITICAL'"
"""


def sample_rules() -> str:
    return BASE_RULES + SQLI_RULE + XSS_RULE + EVIL_MONKEY_RULE


_CATEGORIES = [
    # (id base, variable, patterns)
    (920, "REQUEST_URI", [r"\.\./", r"%00", r"\x00", r"/etc/+passwd", r"\.git/"]),
    (941, "ARGS", [
        r"(?i:<script[^>]*>)", r"(?i:javascript:)", r"(?i:on(error|load|click)\s*=)",
        r"(?i:<iframe)", r"(?i:<svg[^>]*onload)", r"(?i:alert\s*\()",
    ]),
    (942, "ARGS", [
        r"(?i:\bunion\s+(all\s+)?select\b)", r"(?i:\bselect\b.+\bfrom\b)",
        r"(?i:\binsert\s+into\b)", r"(?i:\bdrop\s+table\b)",
        r"(?i:\b(or|and)\b\s+\d+\s*=\s*\d+)", r"(?i:sleep\s*\(\s*\d+\s*\))",
        r"(?i:benchmark\s*\()", r"(?i:information_schema)",
    ]),
    (930, "ARGS|REQUEST_URI", [r"(?i:etc/passwd)", r"(?i:boot\.ini)", r"(?i:proc/self/environ)"]),
    (932, "ARGS", [r"(?i:;\s*(cat|ls|id|whoami)\b)", r"(?i:\|\s*(cat|nc|bash)\b)", r"(?i:\$\(.*\))"]),
    (933, "ARGS", [r"(?i:php://)", r"(?i:base64_decode\s*\()", r"(?i:eval\s*\()"]),
]

_SETUP = """
SecAction "id:900110,phase:1,pass,nolog,\
setvar:tx.inbound_anomaly_score_threshold=5,\
setvar:tx.critical_anomaly_score=5,\
setvar:tx.error_anomaly_score=4"
"""

_BLOCKING_RULE = """
SecRule TX:INBOUND_ANOMALY_SCORE "@ge %{tx.inbound_anomaly_score_threshold}" \
  "id:949110,phase:2,deny,status:403,t:none,msg:'Inbound Anomaly Score Exceeded'"
"""


def synthetic_crs(n_rules: int = 200, seed: int = 0) -> str:
    """CRS-shaped anomaly-scoring ruleset with ~n_rules detection rules."""
    rng = random.Random(seed)
    out = [BASE_RULES, _SETUP]
    made = 0
    i = 0
    while made < n_rules:
        base_id, var, patterns = _CATEGORIES[i % len(_CATEGORIES)]
        pattern = patterns[i % len(patterns)]
        rule_id = base_id * 1000 + 100 + i
        if made >= len(_CATEGORIES) * 8:
            # Synthetic uniques beyond the hand-written set (config #4 shape).
            token = f"attack{rng.randrange(10**6)}x{i}"
            pattern = rf"(?i:\b{token}\b\s*=\s*\d+)"
        out.append(
            f'SecRule {var} "@rx {pattern}" '
            f"\"id:{rule_id},phase:2,pass,t:none,t:urlDecodeUni,"
            f"msg:'synthetic rule {rule_id}',"
            f"setvar:tx.inbound_anomaly_score=+%{{tx.critical_anomaly_score}}\""
        )
        made += 1
        i += 1
    out.append(_BLOCKING_RULE)
    return "\n".join(out)


_BENIGN_PATHS = [
    "/", "/index.html", "/api/v1/items", "/static/app.js", "/login",
    "/products?id=123&sort=asc", "/search?q=blue+widgets", "/health",
    "/api/users/42/profile", "/images/logo.png?v=2",
]
_ATTACK_QUERIES = [
    "/search?q=1%27%20UNION%20SELECT%20password%20FROM%20users--",
    "/item?id=1 or 1=1",
    "/page?x=<script>alert(1)</script>",
    "/view?f=../../../../etc/passwd",
    "/api?cmd=;cat /etc/passwd",
    "/q?a=sleep(10)",
    "/x?y=%3Cscript%20src=evil.js%3E",
    "/dl?f=php://filter/convert.base64-encode",
]


# Realistic per-request uniqueness (VERDICT r3 item 5): real traffic
# repeats *some* values (a browser population shares a UA pool; one host
# serves many paths) but every request differs somewhere (session ids,
# cache busters, varied paths). Cycling a handful of identical requests
# lets the serving path's value dedup collapse a 4k batch to ~40 matcher
# rows and inflates req/s — these pools + salts keep the dedup factor at
# real-traffic levels instead.
_UA_POOL = [
    f"Mozilla/5.0 ({os_}) {eng} {br}/{maj}.0.{b}"
    for os_ in (
        "X11; Linux x86_64",
        "Windows NT 10.0; Win64; x64",
        "Macintosh; Intel Mac OS X 10_15_7",
        "iPhone; CPU iPhone OS 17_4 like Mac OS X",
        "Android 14; Mobile",
    )
    for eng, br in (("AppleWebKit/537.36", "Chrome"), ("Gecko/20100101", "Firefox"))
    for maj, b in ((120, 6099), (121, 6167), (122, 6261), (123, 6312), (124, 6367))
]
_HOST_POOL = [
    "bench.local", "shop.bench.local", "api.bench.local", "cdn.bench.local",
    "admin.bench.local", "m.bench.local", "www.bench.local", "app.bench.local",
]


def synthetic_requests(n: int, attack_ratio: float = 0.1, seed: int = 0) -> list[HttpRequest]:
    rng = random.Random(seed)
    out: list[HttpRequest] = []
    for i in range(n):
        attack = rng.random() < attack_ratio
        salt = f"{i:x}{rng.randrange(1 << 24):x}"
        base = rng.choice(_ATTACK_QUERIES if attack else _BENIGN_PATHS)
        uri = f"{base}{'&' if '?' in base else '?'}_r={salt}"
        headers = [
            ("Host", rng.choice(_HOST_POOL)),
            ("User-Agent", rng.choice(_UA_POOL)),
            ("Accept", "*/*"),
            ("Cookie", f"session={salt}{rng.randrange(1 << 28):07x}"),
        ]
        if rng.random() < 0.3:
            body = (
                f"field1=value{i}&tok={salt}"
                f"&field2={'benign+data+' * rng.randrange(1, 5)}"
            ).encode()
            headers.append(("Content-Type", "application/x-www-form-urlencoded"))
            out.append(HttpRequest(method="POST", uri=uri, headers=headers, body=body))
        else:
            out.append(HttpRequest(method="GET", uri=uri, headers=headers))
    return out

def zipfian_requests(
    n: int,
    pool_size: int = 256,
    s: float = 1.1,
    attack_ratio: float = 0.1,
    seed: int = 0,
) -> list[HttpRequest]:
    """Repeat-mix traffic: a finite pool of ``pool_size`` DISTINCT
    requests (salted like ``synthetic_requests``, so rows differ beyond
    their path) sampled with a Zipf-skewed rank distribution
    (P(rank k) ∝ 1/k^s) — the fleet-scale shape where a few hot probes,
    health checks, and API calls dominate and the tail stays unique-ish.
    Where ``synthetic_requests`` deliberately suppresses repeats (honest
    uncached numbers), this generator produces them ON PURPOSE: it is
    the workload the verdict cache and in-window dedup are built for
    (BENCH_E2E_ZIPF / hack/verdict_cache_smoke.py)."""
    rng = random.Random(seed)
    pool = synthetic_requests(pool_size, attack_ratio=attack_ratio, seed=seed)
    weights = [1.0 / (k + 1) ** s for k in range(len(pool))]
    return rng.choices(pool, weights=weights, k=n)


# ---------------------------------------------------------------------------
# CRS-grade synthetic padding (VERDICT r2 item 3): real CRS regexes are
# long alternations of realistic tokens, bounded repeats, wide char
# classes — stressing DFA state counts and the conv-segment decomposer
# in ways short templates do not. These generators emit that complexity
# grade; patterns the decomposer rejects land on the DFA tier, exactly
# like real CRS traffic.
# ---------------------------------------------------------------------------

_SQL_FUNCS = [
    "concat", "group_concat", "load_file", "benchmark", "sleep", "updatexml",
    "extractvalue", "substring", "substr", "mid", "chr", "ascii", "hex",
    "unhex", "version", "database", "schema", "current_user", "system_user",
    "session_user", "coalesce", "ifnull", "greatest", "least", "strcmp",
]
_XSS_EVENTS = [
    "onerror", "onload", "onclick", "onmouseover", "onfocus", "onblur",
    "onkeydown", "onsubmit", "ontoggle", "onanimationstart", "onpointerover",
    "onwheel", "ondrag", "oncut", "onpaste",
]
_XSS_TAGS = [
    "script", "img", "svg", "iframe", "object", "embed", "video", "audio",
    "details", "marquee", "body", "input", "form", "math", "style",
]
_RCE_CMDS = [
    "cat", "ls", "id", "whoami", "uname", "curl", "wget", "nc", "bash",
    "sh", "python", "perl", "ruby", "php", "nmap", "ping", "chmod", "touch",
]
_PHP_FUNCS = [
    "base64_decode", "eval", "assert", "system", "exec", "shell_exec",
    "passthru", "popen", "proc_open", "file_get_contents", "include",
    "require", "preg_replace", "create_function", "call_user_func",
    "gzinflate", "str_rot13",
]
_LFI_PATHS = [
    "etc/passwd", "etc/shadow", "proc/self/environ", "boot\\.ini",
    "win\\.ini", "windows/system32", "\\.git/config", "\\.env",
    "wp-config\\.php", "id_rsa",
]


def _crs_grade_pattern(i: int, rng: random.Random) -> str:
    kind = i % 6
    if kind == 0:
        funcs = rng.sample(_SQL_FUNCS, k=rng.randrange(8, 16))
        return rf"(?i:\b(?:{'|'.join(funcs)})\s*\()"
    if kind == 1:
        gap = rng.randrange(20, 60)
        return (
            rf"(?i:\b(?:select|update|delete|insert)\b"
            rf".{{0,{gap}}}\b(?:from|into|where|set)\b)"
        )
    if kind == 2:
        tags = rng.sample(_XSS_TAGS, k=rng.randrange(5, 10))
        evs = rng.sample(_XSS_EVENTS, k=rng.randrange(5, 10))
        return rf"(?i:<(?:{'|'.join(tags)})[^>]{{0,60}}(?:{'|'.join(evs)})\s*=)"
    if kind == 3:
        cmds = rng.sample(_RCE_CMDS, k=rng.randrange(6, 12))
        return rf"(?i:[;|`]\s*(?:{'|'.join(cmds)})\b)"
    if kind == 4:
        funcs = rng.sample(_PHP_FUNCS, k=rng.randrange(6, 12))
        return rf"(?i:\b(?:{'|'.join(funcs)})\s*\()"
    paths = rng.sample(_LFI_PATHS, k=rng.randrange(4, 8))
    return rf"(?i:(?:\.\./|%2e%2e%2f){{1,4}}(?:{'|'.join(paths)}))"


def crs_grade_rules(n_rules: int, seed: int = 0, id_base: int = 9500000) -> str:
    """``n_rules`` anomaly-scoring @rx rules at CRS pattern complexity.
    Use to pad a real (crs-lite) ruleset to full-CRS scale — the
    BASELINE configs 3/4 workloads."""
    rng = random.Random(seed)
    out = []
    for i in range(n_rules):
        rule_id = id_base + i
        pattern = _crs_grade_pattern(i, rng).replace('"', '\\"')
        out.append(
            f'SecRule ARGS|REQUEST_URI "@rx {pattern}" '
            f"\"id:{rule_id},phase:2,pass,t:none,t:urlDecodeUni,"
            f"msg:'crs-grade synthetic {rule_id}',"
            f"setvar:tx.inbound_anomaly_score=+%{{tx.critical_anomaly_score}}\""
        )
    return "\n".join(out)
