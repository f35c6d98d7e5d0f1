"""go-ftw corpus helpers: the crs-lite ruleset loader (no YAML needed)."""

from .corpus import CRS_LITE_DIR, load_ruleset_text  # noqa: F401
