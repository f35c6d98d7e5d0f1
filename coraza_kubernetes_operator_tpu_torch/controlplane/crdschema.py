"""CRD schema validator: the shipped CRD YAML, executed.

Loads the package's CRDs (``controlplane/crds/*.yaml``: the repo's
``config/crd/bases`` with the ``gpu`` driver in place of ``tpu``) and
validates object documents against their ``openAPIV3Schema`` — structural constraints (type, required, enum,
pattern, min/max, maxItems, maxLength) **and** the
``x-kubernetes-validations`` CEL rules via the mini-CEL evaluator
(``cel.py``). This is what a real kube-apiserver does at admission; the
fake API server (``kubeapi_fake.py``) and the cluster-backed store both
call it, so the YAML can no longer silently diverge from the enforced
validation.

Error strings follow the apiserver shape
(``spec.driver: Invalid value: ...: exactly one driver must be
configured``) so tier-2 tests can assert exact substrings like the
reference's envtest suite (``engine_controller_test.go:191-279``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

import yaml

from .cel import CelError, compile_rule

CRD_DIR = Path(__file__).resolve().parent / "crds"


class ValidationError(ValueError):
    """Aggregate of field errors, apiserver-style."""

    def __init__(self, kind: str, name: str, errors: list[str]):
        self.kind = kind
        self.name = name
        self.errors = errors
        detail = ", ".join(errors)
        super().__init__(f'{kind} "{name}" is invalid: {detail}')


@dataclass
class CrdSchema:
    kind: str
    group: str
    plural: str
    version: str
    schema: dict
    printer_columns: list = field(default_factory=list)

    def validate(self, doc: dict) -> None:
        errors: list[str] = []
        _validate_node(self.schema, doc, "", errors)
        if errors:
            name = ((doc.get("metadata") or {}).get("name")) or "<unknown>"
            raise ValidationError(self.kind, name, errors)


def _type_ok(expected: str, value) -> bool:
    if expected == "object":
        return isinstance(value, dict)
    if expected == "array":
        return isinstance(value, list)
    if expected == "string":
        return isinstance(value, str)
    if expected == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if expected == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if expected == "boolean":
        return isinstance(value, bool)
    return True


def _validate_node(schema: dict, value, path: str, errors: list[str]) -> None:
    where = path or "<root>"
    typ = schema.get("type")
    if typ and not _type_ok(typ, value):
        errors.append(f"{where}: Invalid value: expected {typ}")
        return
    enum = schema.get("enum")
    if enum is not None and value not in enum:
        allowed = ", ".join(f'"{e}"' for e in enum)
        errors.append(
            f'{where}: Unsupported value: "{value}": supported values: {allowed}'
        )
    if isinstance(value, str):
        pattern = schema.get("pattern")
        if pattern and not re.search(pattern, value):
            errors.append(
                f'{where}: Invalid value: "{value}": must match pattern {pattern}'
            )
        max_len = schema.get("maxLength")
        if max_len is not None and len(value) > max_len:
            errors.append(f"{where}: Too long: may not be more than {max_len} bytes")
        min_len = schema.get("minLength")
        if min_len is not None and len(value) < min_len:
            errors.append(f"{where}: Invalid value: must be at least {min_len} bytes")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        mn = schema.get("minimum")
        if mn is not None and value < mn:
            errors.append(
                f"{where}: Invalid value: {value}: must be greater than or equal to {mn}"
            )
        mx = schema.get("maximum")
        if mx is not None and value > mx:
            errors.append(
                f"{where}: Invalid value: {value}: must be less than or equal to {mx}"
            )
    if isinstance(value, list):
        max_items = schema.get("maxItems")
        if max_items is not None and len(value) > max_items:
            errors.append(
                f"{where}: Too many: {len(value)}: must have at most {max_items} items"
            )
        min_items = schema.get("minItems")
        if min_items is not None and len(value) < min_items:
            errors.append(
                f"{where}: Invalid value: must have at least {min_items} items"
            )
        item_schema = schema.get("items")
        if item_schema:
            for i, item in enumerate(value):
                _validate_node(item_schema, item, f"{path}[{i}]", errors)
    if isinstance(value, dict):
        for req in schema.get("required", []) or []:
            if value.get(req) is None:
                errors.append(f"{where}.{req}: Required value")
        props = schema.get("properties") or {}
        for key, sub in props.items():
            if key in value and value[key] is not None:
                sub_path = f"{path}.{key}" if path else key
                _validate_node(sub, value[key], sub_path, errors)
    # CEL rules evaluate with `self` bound to this node — only when the
    # structural checks for this node passed (apiserver ordering).
    for rule_doc in schema.get("x-kubernetes-validations", []) or []:
        rule = rule_doc.get("rule", "")
        message = rule_doc.get("message", f"failed rule: {rule}")
        try:
            ok = compile_rule(rule).evaluate(value)
        except CelError as err:
            errors.append(f"{where}: rule evaluation error: {err}")
            continue
        if not ok:
            errors.append(f"{where}: Invalid value: {message}")


def load_crds(directory: str | Path = CRD_DIR) -> dict[str, CrdSchema]:
    """kind → CrdSchema for every CRD YAML under ``directory``."""
    out: dict[str, CrdSchema] = {}
    for path in sorted(Path(directory).glob("*.yaml")):
        doc = yaml.safe_load(path.read_text())
        if not doc or doc.get("kind") != "CustomResourceDefinition":
            continue
        spec = doc["spec"]
        kind = spec["names"]["kind"]
        for version in spec["versions"]:
            if not version.get("served", True):
                continue
            out[kind] = CrdSchema(
                kind=kind,
                group=spec["group"],
                plural=spec["names"]["plural"],
                version=version["name"],
                schema=version["schema"]["openAPIV3Schema"],
                printer_columns=version.get("additionalPrinterColumns", []),
            )
    return out
