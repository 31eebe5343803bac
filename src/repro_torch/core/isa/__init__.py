"""Instruction-level analysis on the card: the PTX -> SASS census of the
``isa_mapping`` experiment's cases (``sass_census``, sources in
``csrc/isa_cases.cu``)."""
from repro_torch.core.isa.sass_census import (BASELINE, CASES, census,
                                              op_mapping_table)

__all__ = ["BASELINE", "CASES", "census", "op_mapping_table"]
