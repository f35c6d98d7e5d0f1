"""Versioned in-memory ruleset cache + HTTP server.

Wire-compatible with the reference cache protocol
(``internal/rulesets/cache/server.go``): ``GET /rules/{key}`` returns the
full latest entry, ``GET /rules/{key}/latest`` its UUID/timestamp — the
contract both the reference's WASM data plane and our tpu-engine sidecar
poll for hot reload.
"""

from .cache import RuleSetCache, RuleSetEntries, RuleSetEntry  # noqa: F401
from .server import (  # noqa: F401
    DEFAULT_CACHE_SERVER_PORT,
    GarbageCollectionConfig,
    RuleSetCacheServer,
)
