"""Selective-SSM (Mamba) mixer of hymba's parallel SSM heads, ported from
``repro.models.layers.mamba``.

hymba runs attention heads and SSM heads in parallel inside every layer:
both read the same normed input, and their pre-projection outputs are each
RMS-normed and mean-fused before the shared output projection (the trunk,
``models.transformer``, does the fusion).

  h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t,   y_t = C_t . h_t + D x_t

* **Train mode** (no state in, none needed) starts every row from a zero
  state and never reads the final one, so the scan runs through
  ``kernels.ops.ssm_scan`` (the CUDA kernel on the card, its plain version
  on the CPU); its gradient is ``SsmScanFn``'s (the backward kernel on the
  card), each input's in that input's dtype.
* **Prefill and decode** carry the state: the causal conv reads the
  ``W-1`` rows before the new ones from the state's buffer, and the scan
  is the reference's (``kernels.ref.ssm_scan_carry``, a plain f32 time
  loop) from the state's ``h``.  The new conv buffer is stored in bf16
  whatever the compute dtype, as the reference stores it.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
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


def mamba_mixer(p, x, cfg, state=None, need_state=False, ssm_fn=None):
    """x [Bt,S,D] -> (y_pre [Bt,S,di], new state): the gated
    pre-projection SSM path.

    ``state`` {'conv': [Bt,W-1,di], 'h': [Bt,di,N] f32} or None (a zero
    start).  With no state and ``need_state`` False (train) the scan is
    ``ssm_fn`` (default ``kernels.ops.ssm_scan``; a check can pass its
    plain version to compare the kernel inside the model) and the new
    state is None; otherwise it is the carried scan and the new state is
    ``{'conv': the last W-1 conv inputs in bf16, 'h': hT}``."""
    s = cfg.ssm
    cdt = x.dtype
    Bt, S, di = x.shape
    xz = torch.matmul(x, p["w_in"].to(cdt))
    xr, z = xz[..., :di], xz[..., di:]

    # depthwise causal conv of width W over the buffer (or zeros) and the
    # new rows
    W = s.conv_width
    if state is None:
        xin = F.pad(xr, (0, 0, W - 1, 0))
    else:
        xin = torch.cat([state["conv"].to(cdt), xr], dim=1)
    conv_w = p["conv"].to(cdt)
    xc = F.silu(sum(xin[:, i:i + S] * conv_w[i] for i in range(W)))

    bcdt = torch.matmul(xc, p["w_bcdt"].to(cdt))
    N = s.state_dim
    Bm = bcdt[..., :N].contiguous()
    Cm = bcdt[..., N:2 * N].contiguous()
    dt = F.softplus(torch.matmul(bcdt[..., 2 * N:], p["w_dt"].to(cdt)).float()
                    + p["dt_bias"])
    A = -torch.exp(p["a_log"])                                 # [di,N] f32
    new_state = None
    if state is None and not need_state:
        y = (ssm_fn or functools.partial(kops.ssm_scan, tuned=True))(
            xc, dt, Bm, Cm, A)
    else:
        h0 = (state["h"] if state is not None else
              torch.zeros((Bt, di, N), dtype=torch.float32, device=x.device))
        y, hT = ref.ssm_scan_carry(xc, dt, Bm, Cm, A, h0)
        new_state = {"conv": xin[:, -(W - 1):].to(torch.bfloat16), "h": hT}
    return (y.to(cdt) + xc * p["d_skip"].to(cdt)) * F.silu(z), new_state


def init_mamba_state(cfg, batch, n_layers, device):
    """The decode state of ``n_layers`` layers: ``conv`` [L,B,W-1,di] bf16
    and ``h`` [L,B,di,N] f32, zeros (as ``init_mamba_state``)."""
    s, di = cfg.ssm, cfg.d_model
    return {
        "conv": torch.zeros((n_layers, batch, s.conv_width - 1, di),
                            dtype=torch.bfloat16, device=device),
        "h": torch.zeros((n_layers, batch, di, s.state_dim),
                         dtype=torch.float32, device=device),
    }
