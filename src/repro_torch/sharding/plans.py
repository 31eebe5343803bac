"""Rank candidate mesh layouts and cluster topologies by predicted step
time: the pricing half of ``repro.sharding.plans``, the port's copy.

``rank_plans`` prices every (data, model) factorization of a device
count through ``CostModel.predict`` over an analytic census
(``repro_torch.core.costmodel.analytic``) and returns the candidates
sorted by predicted step time, so the measured tables choose the mesh.
``rank_cluster_topologies`` spends a device budget on engine replicas
the same way: how many replicas, and the best-ranked mesh inside each.
The port prices with the H100's measured table (``hopper_h100``) by
default; it has no TPU table.

Not ported yet: the mesh half (``sanitize_specs``, ``named_tree``,
``train_shardings``, ``strip_axis``, ``paged_decode_shardings``,
``serve_shardings``), which builds concrete shardings over a device
mesh.  It waits for the engines' ``mesh=`` and tensor parallelism over
``torch.distributed``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.costmodel.model import CostModel, Prediction


@dataclasses.dataclass
class RankedPlan:
    """One candidate mesh layout with its cost-model verdict."""
    data: int                       # data-parallel (FSDP/batch) axis size
    model: int                      # model-parallel (TP/EP/SP) axis size
    prediction: Prediction

    @property
    def step_s(self) -> float:
        return self.prediction.step_s

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return (self.data, self.model)

    def describe(self) -> str:
        p = self.prediction
        return (f"data={self.data} model={self.model}: "
                f"step={p.step_s:.3e}s ({p.bottleneck}-bound)")


def candidate_mesh_shapes(n_devices: int,
                          cfg=None) -> List[Tuple[int, int]]:
    """All (data, model) factorizations of the device count, dropping model
    widths that cannot shard both the Q and the KV head dims evenly (an
    uneven model axis would replicate those projections, so the analytic
    census would overprice its benefit).

    The head filter applies only to attention archs: headless configs
    (``attn_impl='none'``, or configs without head fields) keep every
    factorization."""
    n_heads = getattr(cfg, "n_heads", None)
    n_kv = getattr(cfg, "n_kv_heads", None) or 0
    headless = (cfg is None or not n_heads
                or getattr(cfg, "attn_impl", "gqa") in (None, "none"))
    shapes = []
    for m in range(1, n_devices + 1):
        if n_devices % m:
            continue
        if not headless and m > 1 and (n_heads % m or n_kv % m):
            continue
        shapes.append((n_devices // m, m))
    return shapes or [(n_devices, 1)]


def rank_plans(cfg, cell, n_devices: int,
               cost_model: Optional[CostModel] = None,
               accum: int = 1) -> List[RankedPlan]:
    """Rank candidate (data, model) mesh layouts by predicted step time.

    Each candidate is priced through the cost model over an analytic
    census parameterized by its model-parallel width (per-device FLOPs,
    HBM bytes, ring-collective wire bytes, op histogram).  Returns plans
    sorted ascending by predicted step time: ``[0]`` is the recommended
    mesh."""
    from repro_torch.core.costmodel.analytic import analytic_census
    cost_model = cost_model or CostModel.from_named("hopper_h100")
    plans = []
    for d, m in candidate_mesh_shapes(n_devices, cfg):
        census = analytic_census(cfg, cell, n_devices, n_model=m,
                                 accum=accum)
        pred = cost_model.predict(census)
        plans.append(RankedPlan(data=d, model=m, prediction=pred))
    plans.sort(key=lambda pl: pl.step_s)
    return plans


@dataclasses.dataclass
class ClusterTopology:
    """One way to spend a device budget on a serving cluster: how many
    engine replicas, and the best-ranked (data, model) mesh inside each."""
    n_replicas: int
    plan: RankedPlan                # per-replica factorization (rank_plans)
    predicted_tok_s: float          # n_replicas x batch / per-replica step_s

    @property
    def devices_per_replica(self) -> int:
        return self.plan.data * self.plan.model

    def describe(self) -> str:
        return (f"replicas={self.n_replicas} x [data={self.plan.data} "
                f"model={self.plan.model}]: "
                f"predicted={self.predicted_tok_s:.1f} tok/s "
                f"(step={self.plan.step_s:.3e}s, "
                f"{self.plan.prediction.bottleneck}-bound)")


def rank_cluster_topologies(cfg, cell, n_devices: int,
                            cost_model: Optional[CostModel] = None,
                            max_replicas: Optional[int] = None,
                            ) -> List[ClusterTopology]:
    """Factor a device budget into ``replicas x (data, model)`` and rank
    by predicted cluster throughput.

    For every replica count dividing the budget, the per-replica mesh is
    ``rank_plans``' best over the remaining devices, and the cluster's
    predicted rate is ``n_replicas x global_batch / step_s``: replicas
    serve independent traffic, so their rates add.  Returned descending
    by predicted tok/s, ties to fewer replicas; ``[0]`` is the topology
    ``serve.cluster.ServingCluster.build`` uses when handed a budget."""
    tops: List[ClusterTopology] = []
    for r in range(1, n_devices + 1):
        if n_devices % r or (max_replicas is not None and r > max_replicas):
            continue
        plan = rank_plans(cfg, cell, n_devices // r, cost_model)[0]
        rate = r * cell.global_batch / max(plan.step_s, 1e-30)
        tops.append(ClusterTopology(n_replicas=r, plan=plan,
                                    predicted_tok_s=rate))
    tops.sort(key=lambda t: (-t.predicted_tok_s, t.n_replicas))
    return tops
