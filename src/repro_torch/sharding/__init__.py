"""Mesh-layout and cluster-topology ranking priced by the cost model (the
pricing half of ``repro.sharding``; see ``plans``)."""
from repro_torch.sharding.plans import (ClusterTopology, RankedPlan,  # noqa
                                        candidate_mesh_shapes,
                                        rank_cluster_topologies, rank_plans)
