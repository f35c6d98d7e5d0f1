"""Ready/Progressing/Degraded condition state machine.

Transition semantics copied from the reference (``internal/controller/
utils.go:87-107``): Degraded ⇒ Ready=False + Degraded=True, remove
Progressing; Progressing ⇒ Ready=False + Progressing=True; Ready ⇒
Ready=True, remove Degraded and Progressing. SetStatusCondition only
updates LastTransitionTime when status actually flips (apimeta parity).
"""

from __future__ import annotations

from datetime import datetime, timezone

from .api_types import Condition


def _set(conditions: list[Condition], cond: Condition) -> None:
    for i, existing in enumerate(conditions):
        if existing.type == cond.type:
            if existing.status == cond.status:
                cond.last_transition_time = existing.last_transition_time
            conditions[i] = cond
            return
    conditions.append(cond)


def _remove(conditions: list[Condition], cond_type: str) -> None:
    conditions[:] = [c for c in conditions if c.type != cond_type]


def _cond(cond_type: str, status: bool, generation: int, reason: str, message: str) -> Condition:
    return Condition(
        type=cond_type,
        status="True" if status else "False",
        reason=reason,
        message=message,
        observed_generation=generation,
        last_transition_time=datetime.now(timezone.utc),
    )


def set_status_ready(conditions: list[Condition], generation: int, reason: str, message: str) -> None:
    _set(conditions, _cond("Ready", True, generation, reason, message))
    _remove(conditions, "Degraded")
    _remove(conditions, "Progressing")


def set_status_progressing(conditions: list[Condition], generation: int, reason: str, message: str) -> None:
    _set(conditions, _cond("Ready", False, generation, reason, message))
    _set(conditions, _cond("Progressing", True, generation, reason, message))


def set_status_degraded(conditions: list[Condition], generation: int, reason: str, message: str) -> None:
    _set(conditions, _cond("Ready", False, generation, reason, message))
    _set(conditions, _cond("Degraded", True, generation, reason, message))
    _remove(conditions, "Progressing")


def set_status_analyzed(
    conditions: list[Condition], generation: int, reason: str, message: str, ok: bool
) -> None:
    """``Analyzed`` rides alongside Ready/Progressing/Degraded rather than
    through the tri-state machine: analysis findings are advisory at
    admission (the sidecar reload gate is the enforcement point), so a
    ruleset with error findings can still be Ready while Analyzed=False
    tells the operator why the data plane may refuse the next reload."""
    _set(conditions, _cond("Analyzed", ok, generation, reason, message))


# Data-plane rollout states worth surfacing on the RuleSet (the sidecar's
# staged-rollout machine, sidecar/rollout.py / docs/ROLLOUT.md).
_ROLLOUT_REASONS = {
    "staged": "RolloutStaged",
    "shadowing": "RolloutShadowing",
    "promoted": "RolloutPromoted",
    "rolled_back": "RolloutRolledBack",
    "failed": "RolloutFailed",
}


def set_status_rollout(
    conditions: list[Condition], generation: int, state: str, message: str
) -> None:
    """``RolloutState`` mirrors the data plane's staged-rollout state
    machine onto the RuleSet. Like ``Analyzed``, it rides alongside the
    Ready tri-state: a cached RuleSet stays Ready even while a sidecar
    is still shadow-verifying it (or has rolled it back) — the condition
    tells the operator which version of the truth the data plane is
    actually serving. True only once the version was promoted."""
    _set(
        conditions,
        _cond(
            "RolloutState",
            state == "promoted",
            generation,
            _ROLLOUT_REASONS.get(state, "RolloutUnknown"),
            message,
        ),
    )


def get_condition(conditions: list[Condition], cond_type: str) -> Condition | None:
    for c in conditions:
        if c.type == cond_type:
            return c
    return None


def is_ready(conditions: list[Condition]) -> bool:
    c = get_condition(conditions, "Ready")
    return c is not None and c.status == "True"
