"""Engine sidecar (port of the JAX package's ``sidecar/``): the data
plane on the card.

An HTTP sidecar that micro-batches in-flight requests, evaluates each
window on the device (``WafEngine.prepare_blob``/``collect``), enforces
the Engine's ``failurePolicy``, and hot-reloads rules through the cache-
poll contract the reference's WASM plugin uses (uuid change => recompile
=> swap tables). ``SidecarConfig.device`` is None for the card; the CPU
serves only when asked (``"cpu"``). The gRPC ``ext_proc`` frontend
(``sidecar/extproc.py``) opens when ``SidecarConfig.extproc_port`` (or
``CKO_EXTPROC_PORT``) is set; ``server.py`` imports it only then.
"""

from .batcher import MicroBatcher
from .degraded import CircuitBreaker, DegradedModeManager
from .governor import IngressGovernor
from .reloader import RuleReloader
from .rollout import RolloutConfig, RolloutManager
from .server import SidecarConfig, TpuEngineSidecar

__all__ = [
    "CircuitBreaker",
    "DegradedModeManager",
    "IngressGovernor",
    "MicroBatcher",
    "RolloutConfig",
    "RolloutManager",
    "RuleReloader",
    "SidecarConfig",
    "TpuEngineSidecar",
]
