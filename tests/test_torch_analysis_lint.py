"""PyTorch port parity: the source linters and ``cko-analyze``.

- ``analysis/torchlint.py``: CKO-J004 with torch's syncs (fixtures of
  ``tests/test_jaxlint.py`` rewritten for torch, plus the walk from a hot
  path into the functions it calls); CKO-J005…J007 and the suppressions
  on the JAX linter's own fixtures, with the same (code, location)
  findings from both linters; the port's package lints clean.
- ``analysis/nativelint.py``: every case of ``tests/test_nativelint.py``
  through both packages' linters, with equal findings; the port's native
  boundary and its CUDA launcher boundary (``csrc/*.cu`` against
  ``ops/kernels.py::_ABI``) lint clean, and skewed copies of a launcher
  are caught; the table types every launch.
- ``cmd/analyze.py``: exit 0 on crs-lite with ``--torchlint --native``,
  and the rulelint report the JAX CLI gives for the same document.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import textwrap
import types

import pytest

from coraza_kubernetes_operator_tpu.analysis import jaxlint
from coraza_kubernetes_operator_tpu.analysis import nativelint as jnative
from coraza_kubernetes_operator_tpu_torch.analysis import nativelint as tnative
from coraza_kubernetes_operator_tpu_torch.analysis import torchlint
from coraza_kubernetes_operator_tpu_torch.analysis.findings import SEV_ERROR
from coraza_kubernetes_operator_tpu_torch.ops import kernels


def _codes(src: str, rel: str = "ops/fixture.py") -> list[str]:
    return [f.code for f in torchlint.lint_source(rel, textwrap.dedent(src))]


# ---------------------------------------------------------------------------
# CKO-J004: host syncs on the no-sync hot path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["prepare", "prepare_blob", "_dispatch_tiers"])
def test_no_sync_hot_path_flagged_by_rel_path(name):
    src = f"""
    def {name}(self, requests):
        return self._tensors.cpu()
    """
    assert _codes(src, rel="engine/waf.py") == ["CKO-J004"]


def test_same_function_name_elsewhere_not_hot():
    src = """
    def prepare(self, requests):
        return self._tensors.cpu()
    """
    assert _codes(src, rel="engine/other.py") == []


@pytest.mark.parametrize("sync", [
    "x.numpy()",
    "torch.cuda.synchronize()",
    "torch.abs(x).item()",
    "torch.abs(x).tolist()",
    "np.asarray(torch.abs(x))",
    "np.array(y)",
    "int(t)",
    "float(t.sum())",
])
def test_torch_syncs_flagged(sync):
    src = f"""
    import numpy as np
    import torch

    def _dispatch_tiers(self, x, t: torch.Tensor):
        y = torch.zeros(3)
        return {sync}
    """
    assert _codes(src, rel="engine/waf.py") == ["CKO-J004"]


@pytest.mark.parametrize("host", ["np.zeros(3).tolist()", "x.item()", "np.asarray(x)", "int(len(x))"])
def test_host_values_not_flagged(host):
    # numpy shares .item()/.tolist() with torch: only a tensor syncs.
    src = f"""
    import numpy as np

    def prepare(self, x):
        return {host}
    """
    assert _codes(src, rel="engine/waf.py") == []


def test_sync_reached_through_calls_flagged_with_its_chain():
    src = """
    def _numpy(t):
        return t.cpu().numpy()

    class WafEngine:
        def prepare(self, requests):
            return self._dispatch(requests)

        def _dispatch(self, requests):
            return _numpy(requests)

        def collect(self, inflight):
            return inflight.cpu()  # not reached from a hot path
    """
    findings = torchlint.lint_source("engine/waf.py", textwrap.dedent(src))
    assert [(f.code, f.location) for f in findings] == [
        ("CKO-J004", "engine/waf.py:3"), ("CKO-J004", "engine/waf.py:3")]
    assert findings[0].detail == "in _numpy(), reached from prepare() -> _dispatch()"


def test_suppressed_call_line_is_not_entered():
    src = """
    def _numpy(t):
        return t.cpu().numpy()

    def prepare(self, requests):
        return _numpy(requests)  # torchlint: ignore[CKO-J004] the one read
    """
    assert _codes(src, rel="engine/waf.py") == []


# ---------------------------------------------------------------------------
# CKO-J005…J007 and suppressions: the JAX linter's fixtures, both linters
# ---------------------------------------------------------------------------

SHARED_FIXTURES = {
    "lock_order_inversion": ("sidecar/fixture.py", "CKO-J005", """
        class Batcher:
            def dispatch(self):
                with self._queue_lock:
                    with self._window_lock:
                        pass

            def collect(self):
                with self._window_lock:
                    with self._queue_lock:
                        pass
        """),
    "consistent_lock_order": ("sidecar/fixture.py", None, """
        class Batcher:
            def dispatch(self):
                with self._queue_lock:
                    with self._window_lock:
                        pass

            def collect(self):
                with self._queue_lock:
                    with self._window_lock:
                        pass
        """),
    "interprocedural_inversion": ("sidecar/fixture.py", "CKO-J005", """
        class Batcher:
            def dispatch(self):
                with self._queue_lock:
                    self._grow()

            def _grow(self):
                with self._window_lock:
                    pass

            def collect(self):
                with self._window_lock:
                    with self._queue_lock:
                        pass
        """),
    "global_bytearray_to_native_call": ("ops/fixture.py", "CKO-J006", """
        SCRATCH = bytearray(1 << 20)

        def tensorize(lib, n):
            return lib.cko_tensorize(SCRATCH, len(SCRATCH), n)
        """),
    "attr_bytearray_to_from_buffer": ("ops/fixture.py", "CKO-J006", """
        import ctypes

        class Host:
            def __init__(self):
                self._scratch = bytearray(64)

            def pin(self):
                return (ctypes.c_ubyte * 64).from_buffer(self._scratch)
        """),
    "frame_local_bytearray": ("ops/fixture.py", None, """
        def tensorize(lib, n):
            buf = bytearray(1 << 20)
            return lib.cko_tensorize(buf, len(buf), n)
        """),
    "shared_bytearray_to_python_call": ("ops/fixture.py", None, """
        SCRATCH = bytearray(64)

        def digest():
            return hash_all(SCRATCH)
        """),
    "j006_suppression": ("ops/fixture.py", None, """
        SCRATCH = bytearray(64)

        def tensorize(lib, n):
            return lib.cko_tensorize(SCRATCH, 64, n)  # LINT: ignore[CKO-J006]
        """),
    "leaked_lease": ("ops/fixture.py", "CKO-J007", """
        def dispatch(self, blob, n):
            lease = self._arena.checkout()
            return self._tensorize(blob, n)
        """),
    "release_in_finally": ("ops/fixture.py", None, """
        def dispatch(self, blob, n):
            lease = self._arena.checkout()
            try:
                return self._tensorize(blob, n)
            finally:
                lease.release()
        """),
    "lease_escaping_by_return": ("ops/fixture.py", None, """
        def dispatch(self, blob, n):
            lease = self._arena.checkout()
            tensors = self._tensorize(blob, n)
            return tensors, lease
        """),
    "lease_handed_to_batch": ("ops/fixture.py", None, """
        def dispatch(self, blob, n):
            lease = self._arena.checkout()
            self._inflight.append(lease)
        """),
    "tuple_unpacked_lease_leak": ("ops/fixture.py", "CKO-J007", """
        def tier(self, blob, n):
            tiers, numvals, lease = self._native.tier_blob(blob, n)
            return tiers
        """),
    "double_release": ("ops/fixture.py", "CKO-J007", """
        def done(self):
            lease = self._arena.checkout()
            lease.release()
            lease.release()
        """),
    "use_after_release": ("ops/fixture.py", "CKO-J007", """
        def done(self):
            lease = self._arena.checkout()
            lease.release()
            self._read(lease.view())
        """),
    "kubernetes_lease_dict": ("ops/fixture.py", None, """
        def renew(self):
            lease = self.client.get("Lease", "cko-operator")
            lease["spec"]["renewTime"] = now()
            self.client.put(lease)
        """),
    "j007_suppression_on_checkout_line": ("ops/fixture.py", None, """
        def dispatch(self, blob, n):
            lease = self._arena.checkout()  # LINT: ignore[CKO-J007]
            return self._tensorize(blob, n)
        """),
    "blanket_suppression": ("ops/fixture.py", None, """
        def dispatch(self, blob, n):
            lease = self._arena.checkout()  # LINT: ignore
            return self._tensorize(blob, n)
        """),
    "suppression_wrong_code_still_flags": ("ops/fixture.py", "CKO-J007", """
        def dispatch(self, blob, n):
            lease = self._arena.checkout()  # LINT: ignore[CKO-J999]
            return self._tensorize(blob, n)
        """),
    "syntax_error": ("ops/broken.py", "CKO-J000", "def f(:\n"),
}


@pytest.mark.parametrize("name", sorted(SHARED_FIXTURES))
def test_shared_fixture_equal_findings(name):
    rel, code, src = SHARED_FIXTURES[name]
    src = textwrap.dedent(src)

    def run(lint, tag):
        return [(f.code, f.location) for f in lint.lint_source(rel, src.replace("LINT:", tag))]

    got = run(torchlint, "torchlint:")
    assert got == run(jaxlint, "jaxlint:")
    assert {c for c, _ in got} == ({code} if code else set())


def test_cross_module_lock_inversion_equal_findings(tmp_path):
    """J005 is whole-package: the cycle spans two modules through typed
    self-attribute calls."""
    (tmp_path / "a.py").write_text(textwrap.dedent(
        """
        from threading import Lock
        from b import Quarantine

        class Sched:
            def __init__(self):
                self._sched_lock = Lock()
                self._quarantine = Quarantine(self)

            def tick(self):
                with self._sched_lock:
                    self._quarantine.push()
        """
    ))
    (tmp_path / "b.py").write_text(textwrap.dedent(
        """
        from threading import Lock
        from a import Sched

        class Quarantine:
            def __init__(self, sched):
                self._q_lock = Lock()
                self._sched = Sched()

            def push(self):
                with self._q_lock:
                    pass

            def drain(self):
                with self._q_lock:
                    self._sched.tick()
        """
    ))

    def run(lint):
        return [(f.code, f.location) for f in lint.lint_paths([tmp_path], root=tmp_path).findings]

    assert run(torchlint) == run(jaxlint)
    assert "CKO-J005" in [c for c, _ in run(torchlint)]


# ---------------------------------------------------------------------------
# The port's package: clean, and the linter looks at something
# ---------------------------------------------------------------------------


def test_package_is_clean():
    report = torchlint.lint_package()
    assert [f for f in report.findings if f.severity == SEV_ERROR] == [], "\n" + report.render()
    assert report.findings == []


def test_package_hot_paths_resolve_and_are_walked(monkeypatch):
    """The declared hot paths exist in the port's engine, and the walk
    reaches the prefilter confirm's read: without its suppression the
    package is not clean."""
    import ast

    waf = torchlint.PACKAGE_ROOT / "engine" / "waf.py"
    source = waf.read_text()
    names = {n.name for n in ast.walk(ast.parse(source))
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for _rel, fn in torchlint.NO_SYNC_HOT_PATHS:
        assert fn in names, fn
    bare = source.replace("# torchlint: ignore[CKO-J004]", "")
    details = {f.detail for f in torchlint.lint_source("engine/waf.py", bare)}
    assert "in _numpy(), reached from _dispatch_tiers() -> _confirm_prefilter()" in details
    assert "in _stage(), reached from _dispatch_tiers()" in details


# ---------------------------------------------------------------------------
# nativelint: the cases of tests/test_nativelint.py through both packages
# ---------------------------------------------------------------------------

CPP_OK = textwrap.dedent(
    """
    #include <stdint.h>
    #include <stddef.h>

    extern "C" {

    void* cko_ctx_new(const uint8_t* blob, size_t len) {
      return (void*)(blob + len);
    }

    int cko_tensorize(void* h, const uint8_t* blob, size_t len, int n_req) {
      if (!h || !blob || !len) return -1;
      return n_req;
    }

    size_t cko_result_maxlen(void* h) { return h ? 8 : 0; }

    void cko_ctx_free(void* h) { (void)h; }

    }  // extern "C"
    """
)

ABI_OK = textwrap.dedent(
    """
    _ABI = {
        "cko_ctx_new": {"args": ["buf", "size"], "ret": "ptr"},
        "cko_tensorize": {
            "args": ["ptr", "buf", "size", "int"], "ret": "int", "rc": True,
        },
        "cko_result_maxlen": {"args": ["ptr"], "ret": "size"},
        "cko_ctx_free": {"args": ["ptr"]},
    }
    """
)


def _abi_plus(entry: str) -> str:
    return ABI_OK.rstrip().rstrip("}").rstrip() + f"\n    {entry},\n}}\n"


# name -> (C++ source, bindings source, the code that must fire or None)
NATIVE_CASES = {
    "baseline_clean": (CPP_OK, ABI_OK, None),
    "missing_abi_literal": (CPP_OK, "BINDINGS = None\n", "CKO-N000"),
    "computed_abi": (CPP_OK, "_ABI = build_abi()\n", "CKO-N000"),
    "entry_without_args": (CPP_OK, ABI_OK.replace('"args": ["ptr"]},', '"argv": ["ptr"]},'), "CKO-N000"),
    "arity_skew": (CPP_OK, ABI_OK.replace('["ptr", "buf", "size", "int"]', '["ptr", "buf", "size"]'),
                   "CKO-N001"),
    "pointer_bound_as_int": (CPP_OK, ABI_OK.replace('["buf", "size"]', '["int", "size"]'), "CKO-N002"),
    "size_t_bound_as_int32": (CPP_OK, ABI_OK.replace('["buf", "size"]', '["buf", "int"]'), "CKO-N002"),
    "signedness_skew": (CPP_OK, ABI_OK.replace('"size", "int"], "ret"', '"size", "u32"], "ret"'),
                        "CKO-N002"),
    "unknown_token": (CPP_OK, ABI_OK.replace('"cko_ctx_free": {"args": ["ptr"]}',
                                             '"cko_ctx_free": {"args": ["wat"]}'), "CKO-N002"),
    "pointer_return_without_restype": (
        CPP_OK, ABI_OK.replace('"args": ["buf", "size"], "ret": "ptr"', '"args": ["buf", "size"]'),
        "CKO-N003"),
    "size_t_return_as_int32": (CPP_OK, ABI_OK.replace('"ret": "size"', '"ret": "int"'), "CKO-N003"),
    "void_return_with_restype": (
        CPP_OK, ABI_OK.replace('"cko_ctx_free": {"args": ["ptr"]}',
                               '"cko_ctx_free": {"args": ["ptr"], "ret": "int"}'), "CKO-N003"),
    "charp_buffer_binding": (CPP_OK, ABI_OK.replace('["buf", "size"], "ret": "ptr"',
                                                    '["charp", "size"], "ret": "ptr"'), "CKO-N004"),
    "charp_without_length": (
        CPP_OK + '\nextern "C" { int cko_by_name(const char* name) { return 0; } }\n',
        _abi_plus('"cko_by_name": {"args": ["charp"], "ret": "int"}'), None),
    "export_without_binding": (CPP_OK + '\nextern "C" { int cko_orphan(int x) { return x; } }\n',
                               ABI_OK, "CKO-N005"),
    "binding_without_export": (CPP_OK, _abi_plus('"cko_ghost": {"args": ["ptr"], "ret": "int"}'),
                               "CKO-N006"),
    "negative_rc_without_flag": (CPP_OK, ABI_OK.replace(', "rc": True', ""), "CKO-N007"),
    "stale_rc_flag": (CPP_OK, ABI_OK.replace('"ret": "size"', '"ret": "size", "rc": True'), "CKO-N007"),
    "definition_outside_extern_c": (
        CPP_OK + "\nint cko_mangled(int x) { return x ? x : -1; }\n",
        _abi_plus('"cko_mangled": {"args": ["int"], "ret": "int", "rc": True}'), "CKO-N008"),
}


def _native_findings(mod, cpp, abi):
    return [dataclasses.astuple(f) for f in mod.lint_sources(cpp, abi)]


@pytest.mark.parametrize("name", sorted(NATIVE_CASES))
def test_native_case_equal_findings(name):
    cpp, abi, code = NATIVE_CASES[name]
    got = _native_findings(tnative, cpp, abi)
    assert got == _native_findings(jnative, cpp, abi)
    codes = {f[0] for f in got}
    assert (code in codes) if code else not codes, got


PARSER_CASES = {
    "nested_extern_c": 'extern "C" {\nextern "C" {\nvoid cko_ctx_free(void* h) { (void)h; }\n}\n}\n',
    "declarations_are_not_exports": 'extern "C" {\nint cko_proto(int x);\n}\n',
    "braces_in_strings_and_comments": textwrap.dedent(
        """
        extern "C" {
        // a } brace in a comment { and another
        int cko_tricky(const char* s) {
          const char* t = "}{";  /* "{" */
          if (s == t) return -1;
          return 0;
        }
        }
        """),
    "returns_negative_scan": CPP_OK,
}


@pytest.mark.parametrize("name", sorted(PARSER_CASES))
def test_declarator_parser_equal(name):
    src = PARSER_CASES[name]
    got = {k: dataclasses.asdict(v) for k, v in tnative.parse_exports(src).items()}
    assert got == {k: dataclasses.asdict(v) for k, v in jnative.parse_exports(src).items()}
    if name == "declarations_are_not_exports":
        assert got == {}
    else:
        assert all(v["in_extern_c"] for v in got.values()) and got


def test_load_abi_never_imports():
    src = "import does_not_exist_anywhere\n" + ABI_OK
    assert tnative.load_abi(src) == jnative.load_abi(src) != None  # noqa: E711


def test_port_native_boundary_is_clean_nontrivial_deterministic():
    report = tnative.lint_native()
    assert report.findings == [], "\n" + report.render()
    cov = report.coverage
    assert cov["exports"] >= 15 and cov["exports"] == cov["bindings"] == cov["checked"], cov
    assert json.dumps(report.to_json(), sort_keys=True) == json.dumps(
        tnative.lint_native().to_json(), sort_keys=True)


def test_missing_native_files_are_n000(tmp_path):
    report = tnative.lint_native(cpp_path=tmp_path / "nope.cpp", bindings_path=tmp_path / "nope.py")
    assert [f.code for f in report.findings] == ["CKO-N000", "CKO-N000"]
    report = tnative.lint_kernels(csrc_dir=tmp_path, bindings_path=tmp_path / "nope.py")
    assert [f.code for f in report.findings] == ["CKO-N000", "CKO-N000"]


# ---------------------------------------------------------------------------
# The CUDA launcher boundary: csrc/*.cu against ops/kernels.py::_ABI
# ---------------------------------------------------------------------------


def _kernel_sources() -> dict[str, str]:
    return {f"csrc/{p.name}": p.read_text() for p in sorted(tnative.CSRC_DIR.glob("*.cu"))}


def test_kernel_boundary_is_clean():
    report = tnative.lint_kernels()
    assert report.findings == [], "\n" + report.render()
    assert report.coverage == {"exports": 5, "bindings": 5, "checked": 5, "sources": 2}
    exports = tnative.parse_exports(_kernel_sources()["csrc/dfa_scan.cu"])
    assert exports["cko_scan_dense"].params[0].cls == "struct ScanPipes"
    assert exports["cko_error_string"].ret.cls == "ptr"


def _kernel_codes(sources, abi_text) -> list[tuple[str, str]]:
    return [(f.code, f.severity) for f in tnative.lint_kernel_sources(sources, abi_text)]


def test_skewed_launcher_arity_is_n001():
    sources = _kernel_sources()
    cu = sources["csrc/dfa_scan.cu"]
    decl = "int smem_tab_bytes, int smem, int n_recs, void* out, int G, void* stream) {"
    assert cu.count(decl) == 1  # cko_scan_flat's tail
    sources["csrc/dfa_scan.cu"] = cu.replace(decl, decl.replace(" int n_recs,", ""))
    codes = _kernel_codes(sources, tnative.KERNELS_PATH.read_text())
    # The parameters after the gap are skewed too.
    assert codes[0] == ("CKO-N001", SEV_ERROR) and {c for c, _ in codes} == {"CKO-N001", "CKO-N002"}


def test_c_int_for_a_pointer_is_n002():
    table = tnative.KERNELS_PATH.read_text()
    skewed = table.replace('"pipes", "int", "int", "int", "int", "ptr"',
                           '"pipes", "int", "int", "int", "int", "int"')
    assert skewed != table
    assert _kernel_codes(_kernel_sources(), skewed) == [("CKO-N002", SEV_ERROR)]


def test_struct_by_value_bound_as_pointer_is_n002():
    table = tnative.KERNELS_PATH.read_text()
    skewed = table.replace('"args": [\n            "pipes", "int", "int", "int", "int"',
                           '"args": [\n            "ptr", "int", "int", "int", "int"')
    assert skewed != table
    assert _kernel_codes(_kernel_sources(), skewed) == [("CKO-N002", SEV_ERROR)]


def test_missing_restype_on_error_string_is_n003():
    table = tnative.KERNELS_PATH.read_text()
    skewed = table.replace('"cko_error_string": {"args": ["int"], "ret": "charp"}',
                           '"cko_error_string": {"args": ["int"]}')
    assert skewed != table
    # Checked in each source that defines it.
    assert _kernel_codes(_kernel_sources(), skewed) == [("CKO-N003", SEV_ERROR)] * 2


def test_launch_values_that_do_not_fit_the_table_raise():
    """``kernels.bind`` types a real foreign function from the table; a
    value of the wrong type is refused by ctypes before any call."""
    libc = ctypes.CDLL(None)
    fake = types.SimpleNamespace(cko_scan_flat=libc.abs, cko_error_string=libc.labs)
    fn = kernels.bind(fake, "cko_scan_flat")
    assert fn.argtypes == [kernels._CTYPES[t] for t in kernels._ABI["cko_scan_flat"]["args"]]
    assert fn.restype is ctypes.c_int
    good = [kernels.ScanPipes()] + [ctypes.c_int(1)] * 4 + [ctypes.c_void_p(0)] * 5 + [
        ctypes.c_int(1)] * 3 + [ctypes.c_void_p(0), ctypes.c_int(1), ctypes.c_void_p(0)]
    for at, bad in ((1, ctypes.c_void_p(7)), (5, ctypes.c_int(7)), (0, ctypes.c_void_p(0)), (2, 1.5)):
        args = list(good)
        args[at] = bad
        with pytest.raises(ctypes.ArgumentError):
            fn(*args)
    assert kernels.bind(fake, "cko_error_string").restype is ctypes.c_char_p


# ---------------------------------------------------------------------------
# cmd/analyze.py
# ---------------------------------------------------------------------------


def _cli(main, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue())


def test_analyze_cli_on_crs_lite_equals_the_jax_cli():
    from coraza_kubernetes_operator_tpu.cmd.analyze import main as jmain
    from coraza_kubernetes_operator_tpu_torch.cmd.analyze import main as tmain
    from coraza_kubernetes_operator_tpu_torch.ftw.corpus import CRS_LITE_DIR

    doc = str(CRS_LITE_DIR)
    rc, out = _cli(tmain, [doc, "--torchlint", "--native", "--json"])
    assert rc == 0
    assert sorted(out) == sorted([doc, "<torchlint>", "<nativelint>", "<kernellint>"])
    for key in ("<torchlint>", "<nativelint>", "<kernellint>"):
        assert out[key]["findings"] == [], out[key]
    jrc, jout = _cli(jmain, [doc, "--json"])
    assert jrc == rc and out[doc] == jout[doc]


def test_analyze_cli_needs_something_to_do():
    from coraza_kubernetes_operator_tpu_torch.cmd.analyze import main

    with pytest.raises(SystemExit):
        main([])
    assert _cli(main, ["--torchlint", "--json"]) == (0, {"<torchlint>": torchlint.lint_package().to_json()})
