"""Hardware specs for the cost model (``hardware``).

The reference's ``predictor`` and ``roofline`` shims adapt HLO dry runs
and have no counterpart here: the port prices analytic censuses only
(``repro_torch.core.costmodel``).
"""
