"""Shared inputs of the PyTorch port's tests (no JAX import, so the
card-only tests can use them on a machine without JAX)."""

_LONG = "0123456789klmnopqrstuvwxyz" * 3
# One rule per matcher kind, plus anomaly counters, a chain, a numeric
# link, a negated operator, a host-only transform and a rule removal.
SMALL_RULES = rf'''
SecRuleEngine On
SecRequestBodyAccess On
SecDefaultAction "phase:2,log,auditlog,deny,status:403"
SecAction "id:900110,phase:1,pass,nolog,setvar:tx.inbound_anomaly_score_threshold=5,setvar:tx.critical_anomaly_score=5"
SecRule ARGS "@rx (?i:\bunion\s+(all\s+)?select\b)" "id:1001,phase:2,pass,t:none,t:urlDecodeUni,setvar:tx.inbound_anomaly_score=+%{{tx.critical_anomaly_score}}"
SecRule ARGS|REQUEST_URI "@rx (?i:<script[^>]*>)" "id:1002,phase:2,pass,t:none,t:urlDecodeUni,t:htmlEntityDecode,setvar:tx.inbound_anomaly_score=+%{{tx.critical_anomaly_score}}"
SecRule ARGS "@rx (ab)+c" "id:1003,phase:2,deny,status:403,t:none,t:lowercase"
SecRule ARGS "@rx (xy)+{_LONG}" "id:1004,phase:2,deny,status:406,t:none"
SecRule ARGS "@rx (qq)+{_LONG * 2}" "id:1005,phase:2,deny,status:403,t:none,t:urlDecode"
SecRule REQUEST_HEADERS:User-Agent "@contains evilmonkey" "id:1006,phase:1,deny,status:403,t:none,t:lowercase"
SecRule &ARGS "@gt 6" "id:1007,phase:2,deny,status:413"
SecRule REQUEST_METHOD "@streq POST" "id:1008,phase:2,chain,deny,status:405"
  SecRule ARGS:cmd "@rx \b(cat|ls)\s*/etc/" "t:none,t:cmdLine"
SecRule ARGS:safe "@streq 1" "id:1009,phase:1,pass,nolog,ctl:ruleRemoveById=1003"
SecRule ARGS "!@rx ^[a-z0-9 =&;%+./_-]*$" "id:1010,phase:2,pass,t:none,setvar:tx.inbound_anomaly_score=+2"
SecRule TX:INBOUND_ANOMALY_SCORE "@ge %{{tx.inbound_anomaly_score_threshold}}" "id:949110,phase:2,deny,status:403,t:none"
'''

_QQ = "qq" + _LONG * 2
_XY = "xyxy" + _LONG
REQUESTS = [
    ("GET", "/index.html?q=hello", [], b""),
    ("GET", "/?a=ababc", [], b""),
    ("GET", "/?a=ababc&safe=1", [], b""),
    ("GET", f"/?v={_XY}", [], b""),
    ("GET", f"/?v={_QQ}", [], b""),
    ("GET", f"/?v={_QQ[:-1]}", [], b""),
    ("GET", "/", [("User-Agent", "EvilMonkey/1.0")], b""),
    ("GET", "/?a=1&b=2&c=3&d=4&e=5&f=6&g=7", [], b""),
    ("POST", "/run", [("Content-Type", "application/x-www-form-urlencoded")], b"cmd=x;%20cat%20/etc/passwd"),
    ("GET", "/?q=1%27%20UNION%20ALL%20SELECT%20x", [], b""),
    ("GET", "/?q=%3Cscript%3Ealert(1)", [], b""),
    ("GET", "/?q=Hello%20World", [], b""),
    ("GET", "/?q=%26lt;script%26gt;", [], b""),
]
