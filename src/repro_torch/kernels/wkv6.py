"""RWKV6 WKV recurrence: the wrapper around the CUDA kernel
(``csrc/wkv6.cu``), which replaces the TPU Pallas kernel
``repro.kernels.wkv6.wkv6``, and around its gradient's kernel
(``csrc/wkv6_bwd.cu``, ``wkv6_bwd``), behind ``Wkv6Fn``.

A tensor on the CPU goes to the plain version (``ref.wkv6_plain``); a CUDA
tensor launches the kernel or raises, with no fallback.  The kernel reads
``w`` and ``u`` in f32, as the Pallas kernel upcasts them: the wrapper
upcasts them first where they arrive in another float dtype.  The kernel
cuts its own grid from the shapes alone: each thread keeps a 4 x 4 tile of one
head's state, a block at most 32 of a head's columns.  It takes 16-byte
aligned tensors, and ``block_h``, the Pallas kernel's head tile, changes
neither the grid nor any value on the card.  The call reads no device
value on the host, so it can be captured in a CUDA graph.

With grad mode on and an input that requires grad, ``wkv6`` runs through
``Wkv6Fn``: the same forward, and ``wkv6_bwd`` for the gradient (on the
CPU ``ref.wkv6_bwd_plain``, on the card the kernel, which cuts the
sequence into segments of ``BWD_SEG`` steps: their walks from zero, a
serial combine into each segment's start state and end cotangent (kept in
a workspace), then each segment's gradient, a block a (row, head, segment)
adding its column groups' partials in order).

``wkv6.launches`` counts forward kernel launches and ``wkv6.bwd_launches``
the backward's (plain integers; reset them to 0 before a run to prove the
run went through the kernels).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv6_bwd_plain, wkv6_plain

HEAD_DIMS = (16, 32, 64)      # csrc: the N the kernel is built for
BWD_SEG = 64                  # csrc/wkv6_bwd.cu kSeg: steps a segment
BWD_CHUNK = 8                 # csrc/wkv6_bwd.cu kSteps: states rebuilt
BWD_GROUP = 4                 # csrc/wkv6_bwd.cu kTile: columns a partial
_fns = {}


def _launcher(name="wkv6"):
    """The C entry point of ``csrc/<name>.cu`` (``wkv6`` or
    ``wkv6_bwd``), bound on first use."""
    if name not in _fns:
        fn = getattr(_build.load(name), f"{name}_launch")
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P] * 6 + [I] * 5 + [P] if name == "wkv6" else
                       [P] * 12 + [L] + [I] * 5 + [P])
        fn.restype = I
        _fns[name] = fn
    return _fns[name]


def bwd_workspace_floats(B, S, H, N):
    """The backward kernel's f32 workspace: for each ``BWD_SEG``-step
    segment of each (row, head), its start state and its end cotangent
    (N^2 each), the product of its decays and its partial of du (N
    each)."""
    bhs = B * H * -(-S // BWD_SEG)
    return 2 * bhs * N * N + 2 * bhs * N


def _check_args(r, k, v, w, u, block_h):
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must all be [B,S,H,N]; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u must be [H,N] = {(H, N)}, got {tuple(u.shape)}")
    if block_h <= 0 or H % block_h:
        raise ValueError(f"block_h={block_h} does not divide {H} heads")


def _check_cuda(r, k, v, w, u):
    N = r.shape[-1]
    if N not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head_dim in {HEAD_DIMS}, got {N}")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"r, k, v must be bf16 or f32, got {r.dtype}")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
    for name, t in (("w", w), ("u", u)):
        if not t.is_floating_point():
            raise TypeError(f"{name} must be a float tensor, got {t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # (w in another float dtype is upcast into a new, aligned tensor)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.data_ptr() % 16 and (name != "w" or t.dtype == torch.float32):
            raise ValueError(f"{name} must be 16-byte aligned")


def _forward(r, k, v, w, u, block_h):
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, block_h=block_h)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on CUDA or CPU, not {r.device}")
    _check_cuda(r, k, v, w, u)
    w, u = w.float(), u.float()
    B, S, H, N = r.shape
    y = torch.empty_like(r)
    rc = _launcher()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), y.data_ptr(), int(r.dtype == torch.bfloat16),
        B, S, H, N,
        torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed (rc={rc})")
    wkv6.launches += 1
    return y


class Wkv6Fn(torch.autograd.Function):
    """``wkv6`` with its gradient: the forward kernel, then ``wkv6_bwd`` on
    the saved inputs.  ``block_h`` gets no gradient; each gradient comes
    back in its input's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, block_h):
        ctx.save_for_backward(r, k, v, w, u)
        return _forward(r, k, v, w, u, block_h)

    @staticmethod
    def backward(ctx, dy):
        xs = ctx.saved_tensors
        grads = wkv6_bwd(*xs, dy)
        return tuple(g.to(x.dtype) if need else None for g, x, need in
                     zip(grads, xs, ctx.needs_input_grad)) + (None,)


def wkv6(r, k, v, w, u, *, block_h=1):
    """r,k,v [B,S,H,N] (bf16 or f32); w [B,S,H,N] decay in (0, 1); u [H,N]
    -> y [B,S,H,N] in r's dtype, from a zero f32 state per (row, head).
    ``block_h`` keeps the Pallas kernel's meaning, the heads one grid cell
    carries, and must divide H; on the card the kernel takes its grid from
    the shapes alone (a 4 x 4 state tile a thread, at most 32 columns of
    one head a block), so it changes no value.  With grad mode on and an
    input that requires grad, the call goes through ``Wkv6Fn``."""
    _check_args(r, k, v, w, u, block_h)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u)):
        return Wkv6Fn.apply(r, k, v, w, u, block_h)
    return _forward(r, k, v, w, u, block_h)


def wkv6_bwd(r, k, v, w, u, dy):
    """The gradient of ``wkv6(r, k, v, w, u)`` at the cotangent ``dy``
    (cast to r's dtype and made contiguous, as autograd may hand it over
    strided): (dr, dk, dv in r's dtype, dw f32, du in u's dtype).  On CPU
    tensors ``ref.wkv6_bwd_plain``; on CUDA tensors the kernel (one launch
    counted in ``wkv6.bwd_launches``), which reads w and u in f32 and
    takes what the forward kernel takes."""
    _check_args(r, k, v, w, u, 1)
    if dy.shape != r.shape:
        raise ValueError(f"dy {tuple(dy.shape)} must be r's shape "
                         f"{tuple(r.shape)}")
    dy = dy.to(r.dtype).contiguous()
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, dy)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd runs on CUDA or CPU, not {r.device}")
    _check_cuda(r, k, v, w, u)
    if dy.device != r.device or dy.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned on r's device")
    wf, uf = w.float(), u.float().contiguous()
    B, S, H, N = r.shape
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    du = torch.empty((H, N), dtype=torch.float32, device=r.device)
    n = bwd_workspace_floats(B, S, H, N)
    ws = torch.empty(n, dtype=torch.float32, device=r.device)
    rc = _launcher("wkv6_bwd")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), wf.data_ptr(),
        uf.data_ptr(), dy.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ws.data_ptr(), n,
        int(r.dtype == torch.bfloat16), B, S, H, N,
        torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed (rc={rc})")
    wkv6.bwd_launches += 1
    return dr, dk, dv, dw, du.to(u.dtype)


wkv6.launches = 0
wkv6.bwd_launches = 0
