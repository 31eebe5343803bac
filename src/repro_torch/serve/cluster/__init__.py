"""Multi-replica serving: Router + placement policies + ServingCluster
+ the traffic-scaling trace loop (the port's copy of
``repro.serve.cluster``; the reference's ``docs/architecture.md``, "The
cluster tier", draws the picture).

Lazy exports (PEP 562): ``policy``, ``router`` and ``traffic`` are
host-side; ``cluster`` pulls in the engines (torch) only when a cluster
is actually built.
"""
import importlib

_EXPORTS = {
    "CostAwarePolicy": "policy",
    "LeastLoadedPolicy": "policy",
    "PlacementPolicy": "policy",
    "RoundRobinPolicy": "policy",
    "make_policy": "policy",
    "predicted_queue_seconds": "policy",
    "RouteStats": "router",
    "Router": "router",
    "ServingCluster": "cluster",
    "ClusterTelemetry": "metrics",
    "serve_trace": "traffic",
    "skewed_trace": "traffic",
    "unit_latency": "traffic",
}
_SUBMODULES = ("cluster", "metrics", "policy", "router", "traffic")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name):
    if name in _EXPORTS:
        mod = importlib.import_module(f"repro_torch.serve.cluster.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.serve.cluster.{name}")
    raise AttributeError(
        f"module 'repro_torch.serve.cluster' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS) | set(_SUBMODULES))
