"""RuleSet reconciler.

Control-flow parity with reference ``internal/controller/
ruleset_controller.go:84-194``: fetch RuleSet → Progressing → fetch each
referenced ConfigMap in order (missing ⇒ Warning/ConfigMapNotFound +
Degraded + requeue; missing 'rules' key ⇒ Warning/InvalidConfigMap +
Degraded + error) → validate each ConfigMap's rules unless its
``coraza.io/validation: "false"`` annotation opts out (invalid ⇒
Warning/InvalidConfigMap + Degraded + error) → newline-join → cache Put
under "namespace/name" → Normal/RulesCached + Ready.

Validation runs our own Seclang front end instead of ``coraza.NewWAF`` —
plus, beyond the reference, the aggregated document is compiled to device
tables so a RuleSet marked Ready is guaranteed lowerable to the GPU engine.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..cache import RuleSetCache
from ..compiler.ruleset import CompileError, compile_rules
from ..seclang import SeclangParseError, parse
from ..utils import get_logger
from .api_types import RuleSet, VALIDATION_ANNOTATION
from .conditions import (
    set_status_analyzed,
    set_status_degraded,
    set_status_progressing,
    set_status_ready,
    set_status_rollout,
)
from .events import EventRecorder
from .store import ObjectStore

log = get_logger("controller.ruleset")


@dataclass
class ReconcileResult:
    requeue: bool = False
    requeue_after_s: float | None = None


class ReconcileError(Exception):
    """Returned-error analog: the manager requeues with exponential backoff."""


class RuleSetReconciler:
    kind = "RuleSet"

    def __init__(self, store: ObjectStore, cache: RuleSetCache, recorder: EventRecorder):
        self.store = store
        self.cache = cache
        self.recorder = recorder

    def reconcile(self, namespace: str, name: str) -> ReconcileResult:
        ruleset: RuleSet | None = self.store.try_get("RuleSet", namespace, name)
        if ruleset is None or ruleset.metadata.deleted:
            log.debug("RuleSet gone, nothing to do", namespace=namespace, name=name)
            return ReconcileResult()

        generation = ruleset.metadata.generation
        set_status_progressing(
            ruleset.status.conditions, generation, "Reconciling", "Reconciling rules"
        )
        self.store.update_status(ruleset)

        def degraded(reason: str, msg: str) -> None:
            self.recorder.event(ruleset, "Warning", reason, msg)
            set_status_degraded(ruleset.status.conditions, generation, reason, msg)
            self.store.update_status(ruleset)

        chunks: list[str] = []
        for ref in ruleset.spec.rules:
            cm = self.store.try_get("ConfigMap", namespace, ref.name)
            if cm is None:
                degraded(
                    "ConfigMapNotFound",
                    f"Referenced ConfigMap {ref.name} does not exist",
                )
                return ReconcileResult(requeue=True)

            data = cm.data.get("rules")
            if data is None:
                degraded(
                    "InvalidConfigMap",
                    f"ConfigMap {ref.name} is missing required 'rules' key",
                )
                raise ReconcileError(f"ConfigMap {ref.name} missing 'rules' key")

            if cm.metadata.annotations.get(VALIDATION_ANNOTATION) != "false":
                try:
                    parse(data)
                except SeclangParseError as err:
                    degraded(
                        "InvalidConfigMap",
                        f"ConfigMap {ref.name} doesn't contain valid rules:\n{err}",
                    )
                    raise ReconcileError(str(err)) from err
            chunks.append(data)

        aggregated = "\n".join(chunks)

        # Beyond the reference: prove the merged document lowers to device
        # tables, so Ready ⇒ servable by the GPU engine.
        try:
            compiled = compile_rules(aggregated)
        except (SeclangParseError, CompileError, ValueError) as err:
            degraded(
                "InvalidRuleSet",
                f"Aggregated rules do not compile for the GPU engine:\n{err}",
            )
            raise ReconcileError(str(err)) from err

        # Admission-time static analysis (docs/ANALYSIS.md): reuse the
        # compiled IR, surface finding counts on the Analyzed condition.
        # Advisory here — error findings do not block caching (the sidecar
        # reload gate enforces), but the operator sees them *before* the
        # data plane refuses the swap at 3am.
        self._analyze(ruleset, generation, aggregated, compiled)

        cache_key = f"{namespace}/{name}"
        self.cache.put(cache_key, aggregated)
        log.info("Stored rules in cache", cacheKey=cache_key)

        msg = f"Successfully cached rules for {cache_key}"
        self.recorder.event(ruleset, "Normal", "RulesCached", msg)
        set_status_ready(ruleset.status.conditions, generation, "RulesCached", msg)
        self.store.update_status(ruleset)
        return ReconcileResult()

    def observe_rollout(self, cache_key: str, state: str, message: str = "") -> None:
        """Mirror the data plane's staged-rollout state machine
        (``sidecar/rollout.py``) onto the RuleSet's ``RolloutState``
        condition. ``cache_key`` is the sidecar's instance key —
        ``namespace/name``, the same key the reconciler caches under.
        Wired as the sidecar RolloutManager's ``on_state`` callback;
        unknown keys are ignored (a sidecar may serve static rules no
        RuleSet owns). A rollback or failure additionally records a
        Warning event so ``kubectl describe`` tells the 3am story."""
        namespace, _, name = cache_key.strip("/").partition("/")
        ruleset: RuleSet | None = self.store.try_get("RuleSet", namespace, name)
        if ruleset is None or ruleset.metadata.deleted:
            return
        generation = ruleset.metadata.generation
        set_status_rollout(ruleset.status.conditions, generation, state, message)
        if state in ("rolled_back", "failed"):
            self.recorder.event(
                ruleset,
                "Warning",
                "RolloutRolledBack" if state == "rolled_back" else "RolloutFailed",
                message or f"data-plane rollout {state}",
            )
        elif state == "promoted":
            self.recorder.event(
                ruleset, "Normal", "RolloutPromoted", message or "candidate promoted"
            )
        self.store.update_status(ruleset)

    def _analyze(self, ruleset: RuleSet, generation: int, text: str, compiled) -> None:
        """Run rulelint over the aggregated document and record the result
        as the ``Analyzed`` condition + an event. Analyzer crashes degrade
        to Analyzed=False/AnalysisError — never a reconcile failure."""
        try:
            from ..analysis.rulelint import analyze_document

            report = analyze_document(text, compiled)
        except Exception as err:
            set_status_analyzed(
                ruleset.status.conditions,
                generation,
                "AnalysisError",
                f"Static analysis crashed: {err}",
                ok=False,
            )
            return
        counts = report.counts()
        cov = report.coverage.get("coverage_pct", 0.0)
        msg = (
            f"{counts['error']} error(s), {counts['warn']} warning(s), "
            f"{counts['info']} info; {cov:.1f}% of rules on-device"
        )
        if counts["error"]:
            self.recorder.event(ruleset, "Warning", "AnalysisFindings", msg)
            set_status_analyzed(
                ruleset.status.conditions, generation, "ErrorFindings", msg, ok=False
            )
        else:
            set_status_analyzed(
                ruleset.status.conditions, generation, "RulesAnalyzed", msg, ok=True
            )


def find_rulesets_for_configmap(store: ObjectStore, cm) -> list[tuple[str, str]]:
    """ConfigMap → referencing RuleSets mapping (reference
    ``ruleset_controller_watch_predicates.go:36-64``): any RuleSet in the
    ConfigMap's namespace whose spec.rules references it gets enqueued."""
    out: list[tuple[str, str]] = []
    for ruleset in store.list("RuleSet", namespace=cm.metadata.namespace):
        if any(ref.name == cm.metadata.name for ref in ruleset.spec.rules):
            out.append((ruleset.metadata.namespace, ruleset.metadata.name))
    return out
