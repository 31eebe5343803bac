"""Selective-SSM (Mamba) mixer of hymba's parallel SSM heads, train mode,
ported from ``repro.models.layers.mamba``.

hymba runs attention heads and SSM heads in parallel inside every layer:
both read the same normed input, and their pre-projection outputs are each
RMS-normed and mean-fused before the shared output projection (the trunk,
``models.transformer``, does the fusion).

  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,   y_t = C_t . h_t + D x_t

Train mode starts every row from a zero state and never reads the final
one, so the scan runs through ``kernels.ops.ssm_scan`` (the CUDA kernel on
the card, its plain version on the CPU).  The reference's ``lax.scan``
path with a carried state waits for the serving slice.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers.basic import uniform


def init_mamba(gen, cfg, device, dtype):
    """``init_mamba``'s distributions, drawn from ``gen``: matrices in
    ``dtype``; ``a_log`` [di,N] and the 1-D leaves in f32 (the reference
    uses ``a_log`` and ``dt_bias`` in f32)."""
    d, s = cfg.d_model, cfg.ssm
    di = d                       # hymba: expand=1, d_inner == d_model
    lim = d ** -0.5

    def mat(shape, lim):
        return uniform(gen, shape, lim, device, dtype)
    a = torch.arange(1, s.state_dim + 1, dtype=torch.float32, device=device)
    return {
        "w_in": mat((d, 2 * di), lim),                    # x and gate z
        "conv": mat((s.conv_width, di), s.conv_width ** -0.5),
        "w_bcdt": mat((di, 2 * s.state_dim + s.dt_rank), di ** -0.5),
        "w_dt": mat((s.dt_rank, di), s.dt_rank ** -0.5),
        "dt_bias": torch.zeros(di, device=device),
        "a_log": torch.log(a).repeat(di, 1),
        "d_skip": torch.ones(di, device=device),
    }


def mamba_mixer(p, x, cfg, ssm_fn=None):
    """x [Bt,S,D] -> y_pre [Bt,S,di], the gated pre-projection SSM path,
    from a zero state.

    ``ssm_fn`` is the scan (default ``kernels.ops.ssm_scan``); a check can
    pass its plain version to compare the kernel inside the model."""
    s = cfg.ssm
    cdt = x.dtype
    S, di = x.shape[1], x.shape[2]
    xz = torch.matmul(x, p["w_in"].to(cdt))
    xr, z = xz[..., :di], xz[..., di:]

    # depthwise causal conv of width W over the zero-padded sequence
    W = s.conv_width
    xin = F.pad(xr, (0, 0, W - 1, 0))
    conv_w = p["conv"].to(cdt)
    xc = F.silu(sum(xin[:, i:i + S] * conv_w[i] for i in range(W)))

    bcdt = torch.matmul(xc, p["w_bcdt"].to(cdt))
    N = s.state_dim
    Bm = bcdt[..., :N].contiguous()
    Cm = bcdt[..., N:2 * N].contiguous()
    dt = F.softplus(torch.matmul(bcdt[..., 2 * N:], p["w_dt"].to(cdt)).float()
                    + p["dt_bias"])
    A = -torch.exp(p["a_log"])                                 # [di,N] f32
    y = (ssm_fn or functools.partial(kops.ssm_scan, tuned=True))(
        xc, dt, Bm, Cm, A)
    return (y.to(cdt) + xc * p["d_skip"].to(cdt)) * F.silu(z)
