"""ABI-contract linter over the port's two Python↔C++ ctypes boundaries.

Port of ``coraza_kubernetes_operator_tpu/analysis/nativelint.py`` (same
codes, same checks), run on two boundaries:

- the native host runtime: the ``extern "C"`` exports of
  ``native/src/cko_native.cpp`` against ``native/__init__.py::_ABI``
  (``lint_native``);
- the CUDA kernel launchers: the ``extern "C"`` definitions of every
  ``csrc/*.cu`` against ``ops/kernels.py::_ABI`` (``lint_kernels``). A
  symbol defined in several sources (``cko_error_string``) is checked in
  each; the launchers take the ``ScanPipes`` struct by value, so a C
  parameter whose type is a struct the source defines classifies as that
  struct and matches only its token (``pipes``).

A ctypes ``ArgumentError`` at a boundary can demote work silently (the
reference's ``blob_over_limit`` sent every body-limit-Reject window to
the host fallback, verdicts identical, nothing noticed), so the linter
machine-checks each boundary instead of trusting parity runs:

- the ``extern "C"`` declarators are parsed straight out of the C++/CUDA
  source with a lightweight regex/declarator parser (no libclang, no
  compiler invocation);
- the ctypes side is the declarative ``_ABI`` spec —
  ``ast.literal_eval``'d from source, never imported, so the linter
  runs in milliseconds and can lint a broken tree. The bindings are
  made from the SAME table (``native.load_library``, ``kernels.bind``),
  so a binding cannot drift from what is checked here.

======== ==================================================================
code     contract violation
======== ==================================================================
CKO-N000 boundary source unparseable (missing file, no ``_ABI`` literal)
CKO-N001 arity skew: parameter-count disagreement between the C
         declarator and the spec entry
CKO-N002 type-width/class skew on a parameter (pointer vs scalar, 32 vs
         64 bit; signedness skew is a warn)
CKO-N003 return-type skew — above all a pointer-returning export whose
         binding does not declare a pointer restype: ctypes defaults to
         C ``int`` and silently truncates 64-bit handles
CKO-N004 ``c_char_p`` bound to a ``(byte-pointer, size_t)`` buffer
         parameter: rejects bytearray/buffer-protocol callers with an
         ``ArgumentError`` (the exact ``blob_over_limit`` bug class) and
         assumes NUL-termination the blob format does not provide
CKO-N005 exported ``cko_*`` symbol with no spec entry (warn: unchecked
         surface)
CKO-N006 spec entry with no exported symbol (load_library would raise,
         or an optional feature silently never loads)
CKO-N007 rc-convention skew: the export returns negative error codes
         (``return -N`` in its body) but the spec does not mark
         ``"rc"``, or marks it on an unsigned/non-int return — the
         negative-rc overflow contract of ``cko_plan_export``
CKO-N008 ``cko_*`` definition outside every ``extern "C"`` block — the
         symbol would be C++-mangled and invisible to ctypes
======== ==================================================================

Run by ``python -m coraza_kubernetes_operator_tpu_torch.cmd.analyze
--native`` (both boundaries).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

from .findings import SEV_ERROR, SEV_WARN, AnalysisReport, Finding

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_ROOT.parent
CPP_PATH = REPO_ROOT / "native" / "src" / "cko_native.cpp"
BINDINGS_PATH = PACKAGE_ROOT / "native" / "__init__.py"

CPP_REL = "native/src/cko_native.cpp"
BINDINGS_REL = "native/__init__.py"
CSRC_DIR = PACKAGE_ROOT / "csrc"
KERNELS_PATH = PACKAGE_ROOT / "ops" / "kernels.py"
KERNELS_REL = "ops/kernels.py"

# ---------------------------------------------------------------------------
# C++ side: lightweight declarator parser
# ---------------------------------------------------------------------------

_C_TYPE_WORDS = {
    "void", "char", "short", "int", "long", "signed", "unsigned", "bool",
    "float", "double", "size_t", "ssize_t", "int8_t", "int16_t", "int32_t",
    "int64_t", "uint8_t", "uint16_t", "uint32_t", "uint64_t", "intptr_t",
    "uintptr_t",
}

_C_QUALIFIERS = {"const", "volatile", "restrict", "struct", "enum"}

# (class, width-bytes, signed) per scalar spelling; pointers are handled
# by star-count before this table is consulted. LP64 widths — the only
# platform the native tier targets.
_C_SCALARS: dict[str, tuple[str, int, bool | None]] = {
    "void": ("void", 0, None),
    "bool": ("int", 1, False),
    "char": ("int", 1, True),
    "unsigned char": ("int", 1, False),
    "short": ("int", 2, True),
    "unsigned short": ("int", 2, False),
    "int": ("int", 4, True),
    "signed": ("int", 4, True),
    "signed int": ("int", 4, True),
    "unsigned": ("int", 4, False),
    "unsigned int": ("int", 4, False),
    "long": ("int", 8, True),
    "unsigned long": ("int", 8, False),
    "long long": ("int", 8, True),
    "unsigned long long": ("int", 8, False),
    "size_t": ("int", 8, False),
    "ssize_t": ("int", 8, True),
    "int8_t": ("int", 1, True),
    "uint8_t": ("int", 1, False),
    "int16_t": ("int", 2, True),
    "uint16_t": ("int", 2, False),
    "int32_t": ("int", 4, True),
    "uint32_t": ("int", 4, False),
    "int64_t": ("int", 8, True),
    "uint64_t": ("int", 8, False),
    "intptr_t": ("int", 8, True),
    "uintptr_t": ("int", 8, False),
    "float": ("float", 4, None),
    "double": ("float", 8, None),
}

_BYTE_POINTEE = {"char", "uint8_t", "unsigned char", "int8_t"}


@dataclass
class CParam:
    """One parsed C parameter: normalized type text + classification."""

    text: str  # normalized type, e.g. "const uint8_t*"
    cls: str  # "ptr" | "int" | "float" | "void" | "unknown"
    width: int
    signed: bool | None
    byte_pointer: bool  # points at char/uint8_t — a raw byte buffer


@dataclass
class CExport:
    """One parsed ``cko_*`` function definition."""

    name: str
    ret: CParam
    params: list[CParam]
    line: int
    in_extern_c: bool
    returns_negative: bool = False
    param_names: list[str] = field(default_factory=list)


def _strip_comments(src: str) -> str:
    """Blank // and /* */ comments, preserving length and newlines so
    offsets and line numbers survive."""
    out = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            j = n - 2 if j < 0 else j
            seg = src[i : j + 2]
            out.append("".join(ch if ch == "\n" else " " for ch in seg))
            i = j + 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _blank_literals(src: str) -> str:
    """Blank string/char literal CONTENTS (length-preserving) so brace
    matching and regexes never trip on quoted braces. ``extern "C"`` is
    pinned to a sentinel first so region detection survives."""
    src = src.replace('extern "C"', "extern_C___")
    out = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c in "\"'":
            quote = c
            out.append(c)
            i += 1
            while i < n and src[i] != quote:
                if src[i] == "\\" and i + 1 < n:
                    out.append("  ")
                    i += 2
                else:
                    out.append("\n" if src[i] == "\n" else " ")
                    i += 1
            if i < n:
                out.append(quote)
                i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _extern_c_spans(clean: str) -> list[tuple[int, int]]:
    """(start, end) offset spans of every ``extern "C" { ... }`` block in
    the comment-stripped, literal-blanked source. Blocks nest (the plan
    ABI block sits inside the outer one); each span is reported
    independently — membership in ANY span counts."""
    spans: list[tuple[int, int]] = []
    for m in re.finditer(r"extern_C___\s*\{", clean):
        depth = 1
        i = m.end()
        while i < len(clean) and depth:
            if clean[i] == "{":
                depth += 1
            elif clean[i] == "}":
                depth -= 1
            i += 1
        spans.append((m.start(), i))
    return spans


def _parse_c_type(decl: str, structs: frozenset = frozenset()) -> tuple[CParam, str]:
    """Parse one declarator fragment (type + optional name); returns the
    classified type and the parameter name ('' when absent). A struct
    the source defines, taken by value, classifies as ``struct NAME``."""
    stars = decl.count("*")
    tokens = re.findall(r"[A-Za-z_]\w*", decl)
    words = [t for t in tokens if t not in _C_QUALIFIERS]
    name = ""
    if len(words) > 1 and words[-1] not in _C_TYPE_WORDS:
        name = words.pop()
    base = " ".join(words)
    pointee_byte = base in _BYTE_POINTEE
    norm = base + "*" * stars
    if stars:
        return CParam(norm, "ptr", 8, None, pointee_byte), name
    if base in structs:
        return CParam(norm, f"struct {base}", 0, None, False), name
    info = _C_SCALARS.get(base)
    if info is None:
        return CParam(norm or decl.strip(), "unknown", 0, None, False), name
    cls, width, signed = info
    return CParam(norm, cls, width, signed, False), name


def parse_exports(cpp_source: str) -> dict[str, CExport]:
    """All ``cko_*`` function DEFINITIONS in the C++ source, classified.
    Declarations (`;`-terminated) are ignored — the .so exports
    definitions."""
    clean = _blank_literals(_strip_comments(cpp_source))
    spans = _extern_c_spans(clean)
    structs = frozenset(re.findall(r"\bstruct\s+([A-Za-z_]\w*)\s*\{", clean))
    exports: dict[str, CExport] = {}
    pat = re.compile(
        r"(?:^|[;}{\n])\s*"  # statement boundary
        r"((?:[A-Za-z_]\w*[ \t\n*]+)+?)"  # return type tokens
        r"(cko_\w+)\s*\(([^()]*)\)\s*\{",  # name(params) {
    )
    for m in pat.finditer(clean):
        ret_txt, name, params_txt = m.group(1), m.group(2), m.group(3)
        ret, _ = _parse_c_type(ret_txt, structs)
        params: list[CParam] = []
        names: list[str] = []
        ptxt = params_txt.strip()
        if ptxt and ptxt != "void":
            for frag in ptxt.split(","):
                p, pname = _parse_c_type(frag, structs)
                params.append(p)
                names.append(pname)
        # Body span for the rc scan: brace-match from the definition's
        # opening brace.
        body_start = m.end()
        depth = 1
        i = body_start
        while i < len(clean) and depth:
            if clean[i] == "{":
                depth += 1
            elif clean[i] == "}":
                depth -= 1
            i += 1
        body = clean[body_start:i]
        fn_off = m.start(2)
        exports[name] = CExport(
            name=name,
            ret=ret,
            params=params,
            param_names=names,
            line=clean.count("\n", 0, fn_off) + 1,
            in_extern_c=any(a <= fn_off < b for a, b in spans),
            returns_negative=bool(re.search(r"\breturn\s+-\s*\d", body)),
        )
    return exports


# ---------------------------------------------------------------------------
# Python side: the _ABI literal
# ---------------------------------------------------------------------------

# Token -> (class, width, signed). Must agree with _CTYPES in
# native/__init__.py and ops/kernels.py; an unknown token is itself a
# finding.
_TOKEN_INFO: dict[str, tuple[str, int, bool | None]] = {
    "ptr": ("ptr", 8, None),
    "buf": ("ptr", 8, None),
    "arr": ("ptr", 8, None),
    "i32p": ("ptr", 8, None),
    "charp": ("ptr", 8, None),
    "size": ("int", 8, False),
    "int": ("int", 4, True),
    "u32": ("int", 4, False),
    "i64": ("int", 8, True),
    "pipes": ("struct ScanPipes", 0, None),
}


def load_abi(bindings_source: str) -> dict | None:
    """Extract the ``_ABI`` table from the bindings module SOURCE — a
    literal parse, never an import, so the linter has no dependency on
    numpy/jax and can lint a tree whose bindings module is broken.
    Returns None when no literal ``_ABI`` assignment exists."""
    try:
        tree = ast.parse(bindings_source)
    except SyntaxError:
        return None
    for node in ast.walk(tree):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name) and tgt.id == "_ABI":
                try:
                    value = ast.literal_eval(node.value)
                except ValueError:
                    return None
                return value if isinstance(value, dict) else None
    return None


# ---------------------------------------------------------------------------
# Cross-checks
# ---------------------------------------------------------------------------


def _finding(code: str, severity: str, message: str, location: str,
             detail: str = "") -> Finding:
    return Finding(
        code=code, severity=severity, message=message,
        location=location, detail=detail,
    )


def lint_boundary(
    exports: dict[str, CExport],
    abi: dict,
    cpp_rel: str = CPP_REL,
    abi_rel: str = BINDINGS_REL,
) -> list[Finding]:
    """Cross-check parsed C exports against the _ABI spec."""
    out: list[Finding] = []

    for name in sorted(set(abi) - set(exports)):
        spec = abi[name]
        optional = bool(spec.get("optional") or spec.get("group"))
        out.append(_finding(
            "CKO-N006", SEV_ERROR,
            f"binding {name} has no exported symbol in the C++ source",
            f"{abi_rel}::_ABI[{name}]",
            "optional binding that can never load" if optional
            else "load_library() would raise AttributeError",
        ))
    for name in sorted(set(exports) - set(abi)):
        exp = exports[name]
        out.append(_finding(
            "CKO-N005", SEV_WARN,
            f"exported symbol {name} has no _ABI binding",
            f"{cpp_rel}:{exp.line}",
            "unchecked boundary surface — add a spec entry even if "
            "Python never calls it",
        ))

    for name in sorted(set(abi) & set(exports)):
        spec, exp = abi[name], exports[name]
        loc_c = f"{cpp_rel}:{exp.line}"
        loc_py = f"{abi_rel}::_ABI[{name}]"

        if not exp.in_extern_c:
            out.append(_finding(
                "CKO-N008", SEV_ERROR,
                f"{name} is defined outside every extern \"C\" block",
                loc_c,
                "the symbol would be C++-mangled and invisible to ctypes",
            ))

        args = spec.get("args")
        if not isinstance(args, list):
            out.append(_finding(
                "CKO-N000", SEV_ERROR,
                f"spec entry {name} has no args list", loc_py,
            ))
            continue

        if len(args) != len(exp.params):
            out.append(_finding(
                "CKO-N001", SEV_ERROR,
                f"{name}: arity skew — C declares {len(exp.params)} "
                f"parameter(s), spec binds {len(args)}",
                loc_py,
                "every call marshals garbage past the shorter list",
            ))

        for i, (token, cp) in enumerate(zip(args, exp.params)):
            pname = (
                exp.param_names[i]
                if i < len(exp.param_names) and exp.param_names[i]
                else f"arg{i}"
            )
            info = _TOKEN_INFO.get(token)
            if info is None:
                out.append(_finding(
                    "CKO-N002", SEV_ERROR,
                    f"{name}: parameter {i} ({pname}) uses unknown ABI "
                    f"token {token!r}",
                    loc_py,
                ))
                continue
            tcls, twidth, tsigned = info
            if cp.cls == "unknown":
                out.append(_finding(
                    "CKO-N002", SEV_WARN,
                    f"{name}: parameter {i} ({pname}) has unclassifiable "
                    f"C type {cp.text!r}",
                    loc_c,
                ))
                continue
            if tcls != cp.cls or twidth != cp.width:
                out.append(_finding(
                    "CKO-N002", SEV_ERROR,
                    f"{name}: parameter {i} ({pname}) width/class skew — "
                    f"C {cp.text} ({cp.cls}{cp.width * 8 if cp.width else ''}) "
                    f"vs spec {token!r} ({tcls}{twidth * 8 if twidth else ''})",
                    loc_py,
                    "mismarshalled argument: truncation or stack skew "
                    "on every call",
                ))
            elif (
                cp.signed is not None
                and tsigned is not None
                and cp.signed != tsigned
            ):
                out.append(_finding(
                    "CKO-N002", SEV_WARN,
                    f"{name}: parameter {i} ({pname}) signedness skew — "
                    f"C {cp.text} vs spec {token!r}",
                    loc_py,
                ))
            if (
                token == "charp"
                and cp.cls == "ptr"
                and cp.byte_pointer
                and i + 1 < len(exp.params)
                and exp.params[i + 1].cls == "int"
                and exp.params[i + 1].width == 8
            ):
                out.append(_finding(
                    "CKO-N004", SEV_ERROR,
                    f"{name}: parameter {i} ({pname}) is a "
                    f"(byte-pointer, size_t) buffer bound as c_char_p",
                    loc_py,
                    "c_char_p rejects bytearray/buffer-protocol callers "
                    "with ArgumentError (the blob_over_limit silent-"
                    "fallback class) and assumes NUL termination; "
                    "bind as 'buf' (c_void_p) and route through _buf_arg",
                ))

        ret_token = spec.get("ret")
        rinfo = _TOKEN_INFO.get(ret_token) if ret_token else None
        if exp.ret.cls == "ptr":
            if rinfo is None or rinfo[0] != "ptr":
                out.append(_finding(
                    "CKO-N003", SEV_ERROR,
                    f"{name}: pointer-returning export bound with "
                    f"restype {ret_token!r}",
                    loc_py,
                    "ctypes defaults to C int — 64-bit handles truncate "
                    "to 32 bits and corrupt on the next call",
                ))
        elif exp.ret.cls == "void":
            if ret_token is not None:
                out.append(_finding(
                    "CKO-N003", SEV_ERROR,
                    f"{name}: void export declares restype {ret_token!r}",
                    loc_py,
                ))
        elif exp.ret.cls == "int":
            if rinfo is None or rinfo[0] != "int" or rinfo[1] != exp.ret.width:
                out.append(_finding(
                    "CKO-N003", SEV_ERROR,
                    f"{name}: return width skew — C {exp.ret.text} vs "
                    f"spec {ret_token!r}",
                    loc_py,
                    "a size_t return read through a 32-bit restype "
                    "truncates above 4 GiB",
                ))
            elif (
                exp.ret.signed is not None
                and rinfo[2] is not None
                and exp.ret.signed != rinfo[2]
            ):
                out.append(_finding(
                    "CKO-N003", SEV_WARN,
                    f"{name}: return signedness skew — C {exp.ret.text} "
                    f"vs spec {ret_token!r}",
                    loc_py,
                ))

        has_rc = bool(spec.get("rc"))
        if exp.returns_negative and exp.ret.cls == "int":
            if not has_rc:
                out.append(_finding(
                    "CKO-N007", SEV_ERROR,
                    f"{name}: export returns negative error codes but the "
                    f"spec does not mark \"rc\"",
                    loc_py,
                    "callers have no machine-readable signal that rc != 0 "
                    "must abort the window (the cko_plan_export overflow "
                    "contract)",
                ))
            elif rinfo is not None and (rinfo[0] != "int" or rinfo[2] is False):
                out.append(_finding(
                    "CKO-N007", SEV_ERROR,
                    f"{name}: negative-rc export bound with unsigned/"
                    f"non-int restype {ret_token!r}",
                    loc_py,
                    "-1 reads back as 4294967295 and the sentinel inverts",
                ))
        elif has_rc and not exp.returns_negative:
            out.append(_finding(
                "CKO-N007", SEV_WARN,
                f"{name}: spec marks \"rc\" but the export never returns "
                f"a negative code",
                loc_py,
                "stale contract — drop the flag or restore the sentinel",
            ))
    return out


def lint_sources(cpp_source: str, bindings_source: str,
                 cpp_rel: str = CPP_REL,
                 abi_rel: str = BINDINGS_REL) -> list[Finding]:
    """Fixture-friendly entry: lint raw source strings."""
    abi = load_abi(bindings_source)
    if abi is None:
        return [_finding(
            "CKO-N000", SEV_ERROR,
            "no literal _ABI table found in the bindings source",
            abi_rel,
            "the spec must stay a pure literal (ast.literal_eval) — "
            "computed entries cannot be cross-checked",
        )]
    return lint_boundary(parse_exports(cpp_source), abi, cpp_rel, abi_rel)


def lint_native(cpp_path: Path | None = None,
                bindings_path: Path | None = None) -> AnalysisReport:
    """Lint the repo's real native boundary (the CI gate's target)."""
    cpp_path = Path(cpp_path or CPP_PATH)
    bindings_path = Path(bindings_path or BINDINGS_PATH)
    report = AnalysisReport()
    missing = [p for p in (cpp_path, bindings_path) if not p.exists()]
    if missing:
        for p in missing:
            report.add(_finding(
                "CKO-N000", SEV_ERROR,
                f"native boundary source missing: {p.name}",
                str(p),
            ))
        return report.finalize()
    for f in lint_sources(cpp_path.read_text(), bindings_path.read_text()):
        report.add(f)
    # Coverage-style summary for the JSON artifact: how much surface the
    # check actually saw (a linter that parses nothing is trivially clean).
    exports = parse_exports(cpp_path.read_text())
    abi = load_abi(bindings_path.read_text()) or {}
    report.coverage = {
        "exports": len(exports),
        "bindings": len(abi),
        "checked": len(set(exports) & set(abi)),
    }
    return report.finalize()


def lint_kernel_sources(cu_sources: dict[str, str], bindings_source: str,
                        abi_rel: str = KERNELS_REL) -> list[Finding]:
    """Fixture-friendly entry for the kernel boundary: ``cu_sources`` maps
    each CUDA source's label to its text. Every source's ``cko_*``
    definitions are checked against the spec; a spec entry no source
    defines is CKO-N006."""
    abi = load_abi(bindings_source)
    if abi is None:
        return lint_sources("", bindings_source, abi_rel=abi_rel)
    out: list[Finding] = []
    defined: set[str] = set()
    for rel, text in cu_sources.items():
        exports = parse_exports(text)
        defined |= set(exports)
        mine = {name: spec for name, spec in abi.items() if name in exports}
        out.extend(lint_boundary(exports, mine, rel, abi_rel))
    out.extend(lint_boundary({}, {n: s for n, s in abi.items() if n not in defined},
                             "", abi_rel))
    return out


def lint_kernels(csrc_dir: Path | None = None,
                 bindings_path: Path | None = None) -> AnalysisReport:
    """Lint the CUDA launchers (``csrc/*.cu``) against ``ops/kernels.py``'s
    ``_ABI``."""
    csrc_dir = Path(csrc_dir or CSRC_DIR)
    bindings_path = Path(bindings_path or KERNELS_PATH)
    report = AnalysisReport()
    sources = sorted(csrc_dir.glob("*.cu"))
    missing = ([] if sources else [csrc_dir / "*.cu"]) + (
        [] if bindings_path.exists() else [bindings_path])
    if missing:
        for p in missing:
            report.add(_finding(
                "CKO-N000", SEV_ERROR, f"kernel boundary source missing: {p.name}", str(p),
            ))
        return report.finalize()
    texts = {f"csrc/{p.name}": p.read_text() for p in sources}
    bindings = bindings_path.read_text()
    for f in lint_kernel_sources(texts, bindings):
        report.add(f)
    abi = load_abi(bindings) or {}
    exports = {name for text in texts.values() for name in parse_exports(text)}
    report.coverage = {
        "exports": len(exports),
        "bindings": len(abi),
        "checked": len(exports & set(abi)),
        "sources": len(texts),
    }
    return report.finalize()
