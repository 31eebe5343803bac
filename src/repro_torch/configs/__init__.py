"""Architecture config registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from repro_torch.configs.base import SHAPE_CELLS, ModelCfg, ShapeCell, reduced

from repro_torch.configs.hymba_1p5b import CONFIG as _hymba
from repro_torch.configs.yi_34b import CONFIG as _yi
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.deepseek_v2_236b import CONFIG as _dsv2
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv6
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.seamless_m4t_medium import CONFIG as _m4t

ARCHS: dict[str, ModelCfg] = {
    "hymba-1.5b": _hymba,
    "yi-34b": _yi,
    "internlm2-20b": _internlm2,
    "gemma3-1b": _gemma3,
    "gemma2-2b": _gemma2,
    "deepseek-v2-236b": _dsv2,
    "olmoe-1b-7b": _olmoe,
    "rwkv6-1.6b": _rwkv6,
    "llava-next-34b": _llava,
    "seamless-m4t-medium": _m4t,
}


def get_config(arch: str) -> ModelCfg:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def cells_for(cfg: ModelCfg) -> list[ShapeCell]:
    """The runnable shape cells for an arch (long_500k only for sub-quadratic;
    every arch here has a decoder so decode cells always apply)."""
    cells = [SHAPE_CELLS["train_4k"], SHAPE_CELLS["prefill_32k"],
             SHAPE_CELLS["decode_32k"]]
    if cfg.sub_quadratic:
        cells.append(SHAPE_CELLS["long_500k"])
    return cells


__all__ = ["ARCHS", "SHAPE_CELLS", "ModelCfg", "ShapeCell", "get_config",
           "cells_for", "reduced"]
