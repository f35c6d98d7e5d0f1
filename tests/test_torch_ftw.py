"""PyTorch port parity: the go-ftw conformance tier (``ftw/loader.py``,
``ftw/runner.py`` and the JSON mirror of the repo's YAML inputs).

- The port's loader gives the JAX loader's ``FtwTest``/``FtwStage`` values,
  every field, over both corpora and the ledger; the mirror it reads
  equals ``yaml.safe_load`` of every mirrored file, and a stale mirror, a
  missing parser and a value JSON cannot hold all raise.
- The cases of ``tests/test_ftw.py`` run through both packages with
  equal results; the mini corpus replays green in-process (results equal
  to the JAX runner's) and over HTTP against the port's CPU sidecar; the
  crs-lite smoke subset (the reference's first 48 title-sorted tests)
  gives the JAX smoke's breakdown on the port's CPU engine.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest
import yaml

from coraza_kubernetes_operator_tpu import ftw as jftw
from coraza_kubernetes_operator_tpu.ftw import loader as jloader
from coraza_kubernetes_operator_tpu.ftw import runner as jrunner
from coraza_kubernetes_operator_tpu_torch import ftw as tftw
from coraza_kubernetes_operator_tpu_torch.ftw import loader as tloader
from coraza_kubernetes_operator_tpu_torch.ftw import mirror
from coraza_kubernetes_operator_tpu_torch.ftw import runner as trunner

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "ftw" / "tests"
CRS_CORPUS = REPO / "ftw" / "tests-crs-lite"
LEDGER = REPO / "ftw" / "ftw.yml"
PKGS = {"jax": (jftw, jloader, jrunner), "torch": (tftw, tloader, trunner)}
# The reference's crs-lite smoke gate (tests/test_ftw_crs_lite.py).
SMOKE_COUNT = 48


def _rules() -> str:
    return (REPO / "ftw" / "rules" / "base.conf").read_text() + (
        REPO / "ftw" / "rules" / "crs-mini.conf"
    ).read_text()


@pytest.fixture(scope="module")
def engines():
    """The mini corpus's ruleset on both packages' engines (the port's on
    the CPU)."""
    from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
    from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine

    return {"jax": JEngine(_rules()), "torch": TEngine(_rules(), device="cpu")}


def _fields(tests) -> list[dict]:
    return [dataclasses.asdict(t) for t in tests]


# -- loader ---------------------------------------------------------------------


@pytest.mark.parametrize("corpus", [CORPUS, CRS_CORPUS], ids=["tests", "tests-crs-lite"])
def test_loader_equals_jax(corpus):
    jt, js = jloader.load_tests_report(corpus)
    tt, ts = tloader.load_tests_report(corpus)
    assert js == ts == []
    assert len(tt) == len(jt) > 0
    for a, b in zip(jt, tt):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), a.title


def test_ledger_equals_jax():
    assert tloader.load_overrides(LEDGER) == jloader.load_overrides(LEDGER) != {}


@pytest.mark.parametrize("source", ["tests", "tests-crs-lite", "ftw.yml"])
def test_mirror_equals_yaml(source):
    """Every mirrored file, not a sample: its document equals
    ``yaml.safe_load`` and its hash the file's."""
    src = REPO / "ftw" / source
    entries = json.loads(mirror.mirror_path(src).read_text())
    files = mirror.yaml_files(src) if src.is_dir() else [src]
    keys = [str(p.relative_to(src)) if src.is_dir() else p.name for p in files]
    assert sorted(entries) == sorted(keys)
    assert len(files) == {"tests": 5, "tests-crs-lite": 248, "ftw.yml": 1}[source]
    for path, key in zip(files, keys):
        assert entries[key]["sha256"] == mirror.sha256(path), key
        assert entries[key]["doc"] == yaml.safe_load(path.read_text()), key


def test_loading_without_mirror_or_yaml_raises(tmp_path, monkeypatch):
    shutil.copy(CORPUS / "942100.yaml", tmp_path / "942100.yaml")
    (tmp_path / "ledger.yml").write_text(LEDGER.read_text())
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml -> ImportError
    with pytest.raises(RuntimeError, match="ftw.mirror"):
        tloader.load_tests_report(tmp_path)
    with pytest.raises(RuntimeError, match="ftw.mirror"):
        tloader.load_overrides(tmp_path / "ledger.yml")
    # The mirrored corpora still load, with no YAML parser at all.
    assert len(tloader.load_tests(CRS_CORPUS)) == 326


@pytest.fixture
def scratch_mirror(tmp_path, monkeypatch):
    """The mini corpus and the ledger copied under a scratch ``ftw/``,
    mirrored into a scratch data directory the loader reads."""
    ftw_dir, data = tmp_path / "ftw", tmp_path / "data"
    shutil.copytree(CORPUS, ftw_dir / "tests")
    shutil.copy(LEDGER, ftw_dir / "ftw.yml")
    for mod in (tloader, mirror):
        monkeypatch.setattr(mod, "FTW_DIR", ftw_dir)
        monkeypatch.setattr(mod, "DATA_DIR", data)
    monkeypatch.setattr(tloader, "_MIRRORS", {})
    data.mkdir()
    for name in ("tests", "ftw.yml"):
        src = ftw_dir / name
        mirror.mirror_path(src).write_text(json.dumps(mirror.build_mirror(src)))
    return ftw_dir


def test_scratch_mirror_is_read_and_stale_mirror_raises(scratch_mirror, monkeypatch):
    corpus = scratch_mirror / "tests"
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert _fields(tloader.load_tests(corpus)) == _fields(
        [dataclasses.replace(t, source=t.source.replace(str(CORPUS), str(corpus)))
         for t in jloader.load_tests(CORPUS)])
    assert tloader.load_overrides(scratch_mirror / "ftw.yml") == jloader.load_overrides(LEDGER)
    # An edited file, an added file: the mirror no longer matches.
    path = corpus / "942100.yaml"
    path.write_text(path.read_text() + "\n# edited\n")
    with pytest.raises(tloader.MirrorStaleError, match="942100.yaml changed"):
        tloader.load_tests(corpus)
    path.unlink()
    with pytest.raises(tloader.MirrorStaleError, match="942100.yaml"):
        tloader.load_tests(corpus)


def test_mirror_refuses_values_json_cannot_hold(tmp_path):
    for text in ("tests: !!binary aGVsbG8=\n", "tests: [{when: 2024-01-01}]\n", "tests: {1: a}\n"):
        path = tmp_path / "x.yaml"
        path.write_text(text)
        with pytest.raises(mirror.MirrorError):
            mirror.build_mirror(path)


def test_unparsable_file_is_skipped_like_the_reference(scratch_mirror):
    corpus = scratch_mirror / "tests"
    (corpus / "broken.yaml").write_text("tests: [unclosed\n")
    (corpus / "notftw.yaml").write_text("foo: bar\n")
    mirror.mirror_path(corpus).write_text(json.dumps(mirror.build_mirror(corpus)))
    tloader._MIRRORS.clear()
    tt, ts = tloader.load_tests_report(corpus)
    jt, js = jloader.load_tests_report(corpus)
    assert ts == js == [str(corpus / "broken.yaml"), str(corpus / "notftw.yaml")]
    assert _fields(tt) == _fields(jt)


# -- the cases of tests/test_ftw.py, through both packages ----------------------


def _both(case):
    """``case(pkg)`` for both packages; their results must be equal."""
    got = {name: case(*mods) for name, mods in PKGS.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def test_load_new_format():
    def case(_ftw, loader, _runner):
        tests = loader.load_test_file(CORPUS / "942100.yaml")
        st, body = tests[0].stages[0], tests[3].stages[0]
        return ([t.title for t in tests], tests[0].rule_id, st.method, st.status, st.expect_ids,
                body.method, b"union select" in body.data)

    assert _both(case) == (["942100-1", "942100-2", "942100-3", "942100-4"], 942100, "GET",
                           [403], [942100], "POST", True)


def test_load_legacy_format():
    def case(_ftw, loader, _runner):
        tests = loader.load_test_file(CORPUS / "941100.yaml")
        return (tests[0].title, tests[0].rule_id, bool(tests[0].stages[0].log_contains),
                tests[3].stages[0].no_log_contains)

    assert _both(case) == ("941100-1", 941100, True, "941100")


def test_load_rejects_non_ftw_yaml(tmp_path):
    bad = tmp_path / "x.yaml"
    bad.write_text("foo: bar\n")

    def case(_ftw, loader, _runner):
        with pytest.raises(loader.FtwFormatError) as err:
            loader.load_test_file(bad)
        return str(err.value)

    assert "not a go-ftw test file" in _both(case)


def test_load_overrides_ledger():
    def case(ftw, _loader, _runner):
        overrides = ftw.load_overrides(LEDGER)
        return "920160-1" in overrides, "Content-Length" in overrides["920160-1"]

    assert _both(case) == (True, True)


def _line(rid: int) -> str:
    return '{"transaction":{"messages":[{"details":{"ruleId":"%d"}}]}}' % rid


def test_check_stage_status_and_ids():
    def case(_ftw, loader, runner):
        st = loader.FtwStage(status=[403], expect_ids=[101], no_expect_ids=[102])
        return [dataclasses.astuple(runner.check_stage(st, status, lines)) for status, lines in (
            (403, [_line(101)]), (200, [_line(101)]), (403, []), (403, [_line(101), _line(102)]))]

    assert [ok for ok, _ in _both(case)] == [True, False, False, False]


def test_check_stage_log_regex():
    def case(_ftw, loader, runner):
        st = loader.FtwStage(log_contains=r"7", no_log_contains="999")
        return [dataclasses.astuple(runner.check_stage(st, 200, [_line(r)])) for r in (7, 999)]

    assert [ok for ok, _ in _both(case)] == [True, False]


def _result(result) -> tuple:
    return sorted(result.passed), result.failed, result.ignored, result.skipped_files, result.ok


def test_corpus_inproc_all_green(engines):
    """The mini corpus in-process: the port's CPU engine gives the JAX
    runner's result sets."""
    def case(name):
        ftw = PKGS[name][0]
        runner = ftw.FtwRunner(engine=engines[name], overrides=ftw.load_overrides(LEDGER))
        return _result(runner.run(ftw.load_tests(CORPUS)))

    got = {name: case(name) for name in PKGS}
    assert got["torch"] == got["jax"]
    passed, _failed, ignored, _skipped, ok = got["torch"]
    assert ok and len(passed) >= 13 and "920160-1" in ignored


def test_corpus_detects_regressions():
    """A broken ruleset must make the corpus fail on both packages."""
    from coraza_kubernetes_operator_tpu.engine import WafEngine as JEngine
    from coraza_kubernetes_operator_tpu_torch.engine import WafEngine as TEngine

    weak = {"jax": JEngine("SecRuleEngine On\n"),
            "torch": TEngine("SecRuleEngine On\n", device="cpu")}
    got = {}
    for name, (ftw, _loader, _runner) in PKGS.items():
        runner = ftw.FtwRunner(engine=weak[name], overrides=ftw.load_overrides(LEDGER))
        got[name] = _result(runner.run(ftw.load_tests(CORPUS)))
    assert got["torch"] == got["jax"]
    assert not got["torch"][4] and any("942100" in t for t in got["torch"][1])


def test_http_mode_ignores_response_injection_stages():
    def case(_ftw, loader, runner):
        r = runner.FtwRunner(base_url="http://127.0.0.1:1")  # never contacted
        test = loader.FtwTest(
            title="950100-1", rule_id=950100,
            stages=[loader.FtwStage(uri="/x", response_status=500, status=[403])],
        )
        return _result(r.run([test]))

    passed, failed, ignored, _skipped, _ok = _both(case)
    assert passed == [] and not failed and "in-process" in ignored["950100-1"]


def test_corpus_http_against_port_sidecar(tmp_path, engines):
    """The mini corpus over HTTP against the port's CPU sidecar, with an
    audit log: green, and the same passed and ignored sets as in-process
    (the mini corpus has no response-injection stage)."""
    from coraza_kubernetes_operator_tpu_torch.sidecar import SidecarConfig, TpuEngineSidecar

    audit = tmp_path / "audit.log"
    side = TpuEngineSidecar(
        SidecarConfig(host="127.0.0.1", port=0, max_batch_delay_ms=0.5, audit_log=str(audit),
                      audit_relevant_only=False, device="cpu"),
        engine=engines["torch"],
    )
    side.start()
    try:
        overrides = tftw.load_overrides(LEDGER)
        tests = tftw.load_tests(CORPUS)
        result = tftw.FtwRunner(base_url=f"http://127.0.0.1:{side.port}",
                                audit_log_path=str(audit), overrides=overrides).run(tests)
    finally:
        side.stop()
    assert result.ok, result.summary()
    inproc = tftw.FtwRunner(engine=engines["torch"], overrides=overrides).run(tests)
    assert sorted(result.passed) == sorted(inproc.passed)
    assert result.ignored == inproc.ignored


def test_run_corpus_and_cli_on_the_cpu(capsys):
    result = tftw.run_corpus(CORPUS, _rules(), LEDGER, device="cpu")
    assert result.ok and result.skipped_files == []
    from coraza_kubernetes_operator_tpu_torch.ftw.__main__ import main

    assert main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mode"] == "inproc" and line["tests"] == 18 and line["failed"] == 0
    assert line["passed"] == len(result.passed) and line["ignored"] == 1


@pytest.fixture(scope="module")
def crs_engine():
    from coraza_kubernetes_operator_tpu_torch.engine import WafEngine

    return WafEngine(tftw.load_ruleset_text(), device="cpu")


def test_crs_lite_smoke_subset_on_the_port(crs_engine):
    """The reference's default-tier gate on the port's CPU engine: the
    first 48 title-sorted crs-lite tests (920160-1 among them), 47
    passed, the ledger's one ignored, none failed. The full 326 run on
    the card (chip_smoke.py phase 7)."""
    tests, skipped = tftw.load_tests_report(CRS_CORPUS)
    assert len(tests) == 326 and skipped == []
    smoke = sorted(tests, key=lambda t: t.title)[:SMOKE_COUNT]
    assert "920160-1" in {t.title for t in smoke}
    result = tftw.FtwRunner(engine=crs_engine, overrides=tftw.load_overrides(LEDGER)).run(smoke)
    assert result.failed == {}, result.summary()
    assert sorted(result.ignored) == ["920160-1"]
    assert len(result.passed) == SMOKE_COUNT - 1

