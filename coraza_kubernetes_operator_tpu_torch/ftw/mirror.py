"""JSON mirror of the repo's go-ftw YAML inputs.

The card's machine has no ``pyyaml``, so the loader reads the corpora it
replays from a JSON copy committed inside this package
(``ftw/data/<name>.json``): the two test corpora under the repo's
``ftw/`` directory and the override ledger ``ftw/ftw.yml``. Each mirror
maps every YAML file's path (relative to the mirrored directory, or the
ledger's own name) to the SHA-256 of its bytes and either its
``yaml.safe_load`` document or, for a file that does not parse, the
parser's error text. The loader refuses a mirror whose hashes or file
set no longer match the YAML beside it.

Regenerate after editing any of those YAML files (needs ``pyyaml``)::

    python -m coraza_kubernetes_operator_tpu_torch.ftw.mirror

A value JSON cannot hold exactly (``!!binary`` bytes, dates, non-string
keys, non-finite floats) makes the generator raise: the mirror is never
a lossy copy. Only this generator imports ``yaml``.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

from .loader import CORPORA, DATA_DIR, FTW_DIR, LEDGER, mirror_path, sha256, yaml_files


class MirrorError(ValueError):
    """A YAML value JSON cannot hold exactly."""


def _check_json(value, where: str) -> None:
    if value is None or isinstance(value, (bool, int, str)):
        return
    if isinstance(value, float):
        if not math.isfinite(value):
            raise MirrorError(f"{where}: non-finite float {value!r}")
        return
    if isinstance(value, list):
        for i, item in enumerate(value):
            _check_json(item, f"{where}[{i}]")
        return
    if isinstance(value, dict):
        for k, item in value.items():
            if not isinstance(k, str):
                raise MirrorError(f"{where}: non-string key {k!r}")
            _check_json(item, f"{where}.{k}")
        return
    raise MirrorError(f"{where}: {type(value).__name__} value {value!r:.60} has no JSON form")


def _entry(path: Path, label: str) -> dict:
    import yaml

    entry: dict = {"sha256": sha256(path)}
    try:
        doc = yaml.safe_load(path.read_text())
    except yaml.YAMLError as err:
        entry["error"] = str(err)
        return entry
    _check_json(doc, label)
    entry["doc"] = doc
    return entry


def build_mirror(source: Path) -> dict:
    """{relative path: entry} for a corpus directory, {name: entry} for the
    ledger."""
    source = Path(source)
    if source.is_dir():
        return {str(p.relative_to(source)): _entry(p, str(p)) for p in yaml_files(source)}
    return {source.name: _entry(source, str(source))}


def write_mirrors() -> list[Path]:
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    written = []
    for name in (*CORPORA, LEDGER):
        source = FTW_DIR / name
        target = mirror_path(source)
        target.write_text(json.dumps(build_mirror(source), separators=(",", ":")) + "\n")
        written.append(target)
    return written


def main() -> int:
    for path in write_mirrors():
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
