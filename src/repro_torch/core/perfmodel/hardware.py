"""Hardware specifications for the cost model's roofline terms.

The NVIDIA H100 SXM 80 GB is the port's card; the A100 40 GB spec carries
the paper's published numbers so the transcribed tables can be
cross-validated against the paper itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float          # per chip, FLOP/s
    peak_flops_f32: float
    hbm_bandwidth: float            # bytes/s per chip
    hbm_bytes: float                # capacity per chip
    ici_link_bandwidth: float       # bytes/s per link (one direction)
    ici_links: int                  # links per chip taking part in a ring
    vmem_bytes: float = 0.0         # on-chip scratch (L2 + shared memory)
    mxu_shape: tuple = (16, 8, 16)  # tensor-core tile
    clock_hz: float = 0.0
    # independent grid-execution lanes (SMs): a kernel whose grid has
    # fewer cells than this cannot reach peak bandwidth - the
    # under-utilization term split-KV decoding exists to fix
    n_cores: int = 1
    notes: str = ""


# NVIDIA H100 Tensor Core GPU datasheet (SXM5 column, dense rates) and the
# NVIDIA H100 Tensor Core GPU Architecture whitepaper (132 SMs, 50 MB L2,
# NVLink 4: 18 links, 900 GB/s both directions together)
H100_SXM = HardwareSpec(
    name="h100-sxm-80g",
    peak_flops_bf16=989e12,         # tensor cores, dense bf16
    peak_flops_f32=67e12,           # CUDA cores, fp32
    hbm_bandwidth=3.35e12,          # HBM3
    hbm_bytes=80e9,
    ici_link_bandwidth=25e9,        # NVLink 4 per direction per link
    ici_links=18,
    vmem_bytes=50 * 2**20,          # L2
    mxu_shape=(16, 8, 16),          # mma.sync m16n8k16 tile
    clock_hz=1.98e9,                # maximum boost
    n_cores=132,                    # SMs
    notes="the port's card; hopper_h100.json calibrates this spec",
)

A100_40G = HardwareSpec(
    name="a100-40g",
    peak_flops_bf16=312e12,         # TC dense bf16
    peak_flops_f32=19.5e12,         # CUDA-core fp32
    hbm_bandwidth=1555e9,
    hbm_bytes=40 * 2**30,
    ici_link_bandwidth=25e9,        # NVLink3 per direction per link
    ici_links=12,
    vmem_bytes=40 * 2**20,          # L2
    mxu_shape=(16, 8, 16),          # HMMA.16816 SASS tile (the paper, Tab.III)
    clock_hz=1410e6,
    n_cores=108,                    # SMs (the paper, Sec. II)
    notes="the paper's device (Tesla A100); Tables II-V calibrate this spec",
)

SPECS: Dict[str, HardwareSpec] = {s.name: s for s in (H100_SXM, A100_40G)}
