"""One run of one cell: the sidecar under test, the load, the probes.

The program under test is the port's ``TpuEngineSidecar``, configured as the
port's control plane renders a ``driver.gpu`` Engine, serving its ruleset
from the port's rule-cache server, both in this process. The load comes from
``portbench/loadgen.py`` in a child process over the sidecar's ext_proc
listener. Probes wrap two of the program's methods from outside:
``TpuEngineSidecar.record_verdict`` (each request as the sidecar received it,
and its ``Verdict``) and ``WafEngine.collect`` (each window's stage times).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from .generator import index_of

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CHILDREN: set = set()  # load generators alive, for the run's watchdog


def ruleset_text(cfg: dict) -> str:
    """The configuration's ruleset: setup files first, then the rule files
    in CRS order, with ``SecDataDir`` at the frozen data directory."""
    rules = BENCH / "configs" / cfg["rules"]["dir"]
    parts = []
    if cfg["rules"].get("data"):
        parts.append(f"SecDataDir {rules / cfg['rules']['data']}")
    for name in cfg["rules"]["files"]:
        parts.append((rules / name).read_text())
    return "\n".join(parts)


def controller_config(cache_port: int, key: str, knobs: dict):
    """The sidecar config the port's control plane deploys for a
    ``driver.gpu`` Engine with its defaults on RuleSet ``key``: the Engine
    reconciled on an in-memory store, the rendered container's args with
    the cache server, the ports (0: ephemeral) and the audit log (off: it
    would write to standard output) overridden, parsed by ``gpu-engine``'s
    ``build_config``; then ``knobs``, fields the controller does not render."""
    from coraza_kubernetes_operator_tpu_torch.cmd import gpu_engine
    from coraza_kubernetes_operator_tpu_torch.controlplane import (
        DriverConfig, Engine, EngineReconciler, EngineSpec, EventRecorder, GpuDriverConfig,
        ObjectMeta, ObjectStore,
    )
    from coraza_kubernetes_operator_tpu_torch.controlplane.api_types import RuleSetReference

    ns, name = key.split("/")
    store = ObjectStore()
    store.create(Engine(metadata=ObjectMeta(name="portbench", namespace=ns),
                        spec=EngineSpec(rule_set=RuleSetReference(name),
                                        driver=DriverConfig(gpu=GpuDriverConfig()))))
    EngineReconciler(store, EventRecorder(), cache_server_cluster="coraza-cache").reconcile(ns, "portbench")
    dep = store.get("Deployment", ns, "coraza-gpu-engine-portbench")
    container = dep.spec["template"]["spec"]["containers"][0]
    overrides = {"--cache-server-cluster": "127.0.0.1", "--cache-server-port": str(cache_port),
                 "--port": "0", "--extproc-port": "0", "--audit-log": ""}
    args = [a for a in container["args"] if a.split("=")[0] not in overrides]
    cfg = gpu_engine.build_config(args + [f"{k}={v}" for k, v in overrides.items()])
    return dataclasses.replace(cfg, **knobs)


class Probes:
    """What the benchmark reads from the program while it runs."""

    def __init__(self):
        self.lock = threading.Lock()
        self.verdicts: dict[int, tuple] = {}  # index -> (request, verdict)
        self.windows: list[tuple] = []  # (t, n_requests, assemble_s, confirm_s)
        self._undo: list = []

    def install(self, sidecar_cls, engine_cls) -> None:
        probes = self
        real_record = sidecar_cls.record_verdict
        real_collect = engine_cls.collect

        def record_verdict(sc, request, verdict, tenant=None):
            i = index_of(request.uri)
            if i is not None:
                with probes.lock:
                    probes.verdicts[i] = (request, verdict)
            return real_record(sc, request, verdict, tenant=tenant)

        def collect(engine, inflight):
            out = real_collect(engine, inflight)
            with probes.lock:
                probes.windows.append((time.monotonic(), inflight.n_requests, inflight.assemble_s,
                                       inflight.stage_s.get("confirm", 0.0)))
            return out

        sidecar_cls.record_verdict = record_verdict
        engine_cls.collect = collect
        self._undo = [(sidecar_cls, "record_verdict", real_record), (engine_cls, "collect", real_collect)]

    def remove(self) -> None:
        for cls, name, real in self._undo:
            setattr(cls, name, real)
        self._undo = []


def counters(sc) -> dict:
    """The program's own counters, read at one instant."""
    from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

    engine = sc.tenants.engine_for(None)
    st = sc.batcher.stats
    ex = EXEC_CACHE.stats()
    return {
        "t": time.monotonic(),
        "batches": st.batches, "requests": st.requests, "errors": st.errors,
        "graph_hits": ex["hits"], "graph_misses": ex["misses"], "graph_bypasses": ex["bypasses"],
        "graph_captures": ex["captures"],
        "prefilter": dict(engine.prefilter_stats) if engine is not None else {},
        "fallback_requests": sc.degraded.fallback_requests,
    }


def start_loadgen(job: dict) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen([sys.executable, "-m", "portbench.loadgen"], cwd=str(ROOT), env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    CHILDREN.add(proc)
    proc.stdin.write(json.dumps(job) + "\n")
    proc.stdin.flush()
    return proc


def read_line(proc: subprocess.Popen, want: str) -> str:
    line = proc.stdout.readline()
    if not line.startswith(want):
        proc.kill()
        proc.wait()
        raise RuntimeError(f"load generator: expected {want!r}, read {line[:200]!r} (exit {proc.poll()})")
    return line


class Serving:
    """A sidecar under test with its rule-cache server and probes, from
    ``start`` to ``stop``."""

    def __init__(self, cfg: dict, device: str | None):
        from coraza_kubernetes_operator_tpu_torch.cache import RuleSetCache, RuleSetCacheServer
        from coraza_kubernetes_operator_tpu_torch.engine.waf import WafEngine
        from coraza_kubernetes_operator_tpu_torch.sidecar import TpuEngineSidecar

        self.probes = Probes()
        self.probes.install(TpuEngineSidecar, WafEngine)
        key = cfg["instance_key"]
        cache = RuleSetCache()
        cache.put(key, ruleset_text(cfg))
        self.srv = RuleSetCacheServer(cache, host="127.0.0.1", port=0)
        self.srv.start()
        self.sc = None
        try:
            knobs = dict(cfg["sidecar"], device=device, host="127.0.0.1")
            scfg = controller_config(self.srv.port, key, knobs)
            self.sc = TpuEngineSidecar(scfg)
            self.sc.start()
            t_wait = time.monotonic()
            while self.sc.serving_mode() != "promoted":
                if time.monotonic() - t_wait > 900:
                    raise RuntimeError("the sidecar was not promoted within 900 s")
                time.sleep(0.02)
        except BaseException:
            self.stop()
            raise

    def drive(self, traffic: dict, seed: int, seconds: float, trace: bool = False,
              drain_s: float = 60.0) -> dict:
        """One warm-up and one measured window of ``traffic``; returns what
        was read. A traced run profiles the device over the window's last
        ``SLICE_S`` seconds but half a second (``profile_slice``: less where
        a graph capture cuts it), and reads the counters once
        more where that slice starts (``c_mid``): its host-side metrics
        come from the part of the window before the profiler."""
        sc, proc = self.sc, None
        job = {"port": sc.config.extproc_port, "mix": traffic["mix"], "seed": seed,
               "load": traffic["load"], "warm": traffic["warm_requests"], "seconds": seconds,
               "drain_s": drain_s}
        if trace:
            from coraza_kubernetes_operator_tpu_torch.engine.compile_cache import EXEC_CACHE

            from .profile import SLICE_S, profile_slice

            # CUPTI's first session starts slowly: start it once here,
            # before any load, so the window's session starts warm.
            profile_slice(0.05, EXEC_CACHE)
        try:
            proc = start_loadgen(job)
            read_line(proc, "warm")
            t_warm = time.monotonic()
            c0 = counters(sc)
            proc.stdin.write("go\n")
            proc.stdin.flush()
            prof = c_mid = None
            if trace:
                length = min(SLICE_S, seconds / 3)
                time.sleep(max(0.0, t_warm + seconds - length - 0.5 - time.monotonic()))
                c_mid = counters(sc)
                prof = profile_slice(length, EXEC_CACHE)
            read_line(proc, "end")
            c1 = counters(sc)
            out = json.loads(proc.stdout.readline())
            proc.wait(timeout=60)
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
            CHILDREN.discard(proc)
        return {"t_warm": t_warm, "c0": c0, "c_mid": c_mid, "c1": c1, "load": out,
                "probes": self.probes, "profile": prof}

    def stop(self) -> None:
        if self.sc is not None:
            self.sc.stop()
            self.sc = None
        self.srv.stop()
        self.probes.remove()
        gc.collect()


def run_sidecar(cfg: dict, traffic: dict, seed: int, seconds: float, device: str | None,
                trace: bool = False) -> dict:
    """Serve one cell's load from a fresh sidecar. ``setup_s`` ends when the
    warm-up's last verdict arrived."""
    serving = Serving(cfg, device)
    try:
        return serving.drive(traffic, seed, seconds, trace=trace)
    finally:
        serving.stop()
