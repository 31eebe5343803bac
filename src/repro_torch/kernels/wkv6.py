"""RWKV6 WKV recurrence: the wrapper around the CUDA kernel
(``csrc/wkv6.cu``), which replaces the TPU Pallas kernel
``repro.kernels.wkv6.wkv6``.

A tensor on the CPU goes to the plain version (``ref.wkv6_plain``); a CUDA
tensor launches the kernel or raises, with no fallback.  The kernel reads
``w`` and ``u`` in f32, as the Pallas kernel upcasts them: the wrapper
upcasts them first where they arrive in another float dtype.  The kernel
cuts its own grid from the shapes alone: each thread keeps a 4 x 4 tile of one
head's state, a block at most 32 of a head's columns.  It takes 16-byte
aligned tensors, and ``block_h``, the Pallas kernel's head tile, changes
neither the grid nor any value on the card.  The call reads no device
value on the host, so it can be captured in a CUDA graph.

The kernel has no backward: with grad mode on, an input that requires
grad raises ``NotImplementedError`` on every device (``refuse_grad``).

``wkv6.launches`` counts kernel launches (plain integer; reset it to 0
before a run to prove the run went through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.ref import wkv6_plain

HEAD_DIMS = (16, 32, 64)      # csrc: the N the kernel is built for
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("wkv6").wkv6_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = I
        _fn = fn
    return _fn


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


def wkv6(r, k, v, w, u, *, block_h=1):
    """r,k,v [B,S,H,N] (bf16 or f32); w [B,S,H,N] decay in (0, 1); u [H,N]
    -> y [B,S,H,N] in r's dtype, from a zero f32 state per (row, head).
    ``block_h`` keeps the Pallas kernel's meaning, the heads one grid cell
    carries, and must divide H; on the card the kernel takes its grid from
    the shapes alone (a 4 x 4 state tile a thread, at most 32 columns of
    one head a block), so it changes no value."""
    _check_args(r, k, v, w, u, block_h)
    refuse_grad("wkv6", r, k, v, w, u)
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


wkv6.launches = 0
