"""Control plane: declarative WAF management.

The Python rebuild of the reference operator's API + controllers
(``api/v1alpha1/``, ``internal/controller/``): Engine/RuleSet resources with
schema+CEL-equivalent validation, a watch-capable object store (the
kube-apiserver seam — in-memory for tests, pluggable for a real cluster),
reconcilers with the Ready/Progressing/Degraded condition machine, Events,
exponential-backoff workqueues, and drivers that attach either the classic
Istio/WASM data plane or the first-party batch engine sidecar on an NVIDIA
card (``spec.driver.gpu``, the ``gpu-engine`` Deployment).
"""

from .api_types import (  # noqa: F401
    ConfigMap,
    DriverConfig,
    Engine,
    EngineSpec,
    IstioDriverConfig,
    IstioWasmConfig,
    ObjectMeta,
    RuleSet,
    RuleSetCacheServerConfig,
    RuleSetSpec,
    RuleSourceReference,
    GpuDriverConfig,
    ValidationError,
)
from .store import ObjectStore  # noqa: F401
from .events import EventRecorder, FakeRecorder  # noqa: F401
from .ruleset_controller import RuleSetReconciler  # noqa: F401
from .engine_controller import EngineReconciler  # noqa: F401
from .manager import ControllerManager  # noqa: F401
