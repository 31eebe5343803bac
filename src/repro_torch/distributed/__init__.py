"""Distributed-runtime policy of the port: ``fault_tolerance`` (heartbeats,
stragglers, restart budget), the port's copy of the reference's.

Not ported yet: ``elastic``, ``compression`` and ``overlap``, which wait
for sharding over ``torch.distributed``."""
from repro_torch.distributed import fault_tolerance  # noqa: F401
