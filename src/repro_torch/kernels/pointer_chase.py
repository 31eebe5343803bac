"""Pointer-chase probe: the wrapper around the CUDA kernel
(``csrc/pointer_chase.cu``), which replaces the TPU Pallas kernel
``repro.kernels.microbench_chase.pointer_chase``.

A tensor on the CPU goes to the plain version (``ref.pointer_chase_plain``);
a CUDA tensor launches the kernel or raises, with no fallback.  ``space``
picks where the chase reads: ``"shared"`` copies the whole array into shared
memory first (the port of the Pallas kernel's VMEM residency; up to
``SHARED_MAX_ENTRIES``), ``"global"`` reads device memory with the cache
operator ``cache_op`` (``"ca"``, ``"cg"`` or ``"cv"``, the paper's Fig. 2),
after a coalesced warming read under the same operator when ``warm``.
Every entry of ``nxt`` must index the array.  With ``timing=`` (a CUDA int64
tensor of 2) the kernel writes the chase's ``clock64()`` cycles and
``%globaltimer`` nanoseconds there.

``pointer_chase.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pointer_chase_plain

SPACES = ("shared", "global")
CACHE_OPS = ("ca", "cg", "cv")
SHARED_MAX_ENTRIES = 232448 // 4          # 227 KB of shared memory a block
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("pointer_chase").pointer_chase_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, I, I, I, I, P, P, P]
        fn.restype = I
        _fn = fn
    return _fn


def pointer_chase(nxt, start, *, hops=1024, space="global", cache_op="ca",
                  warm=True, timing=None):
    """nxt [N] int32 (entries in [0, N)); start scalar -> the index after
    ``hops`` dependent loads ``i <- nxt[i]``, a 0-d int32 tensor."""
    if nxt.dim() != 1 or nxt.dtype != torch.int32:
        raise TypeError("nxt must be a 1-d int32 tensor")
    n, start, hops = nxt.shape[0], int(start), int(hops)
    if not 0 <= start < n or hops < 0:
        raise ValueError(f"start {start} outside [0, {n}) or hops {hops} < 0")
    if space not in SPACES or cache_op not in CACHE_OPS:
        raise ValueError(f"space must be one of {SPACES} and cache_op one "
                         f"of {CACHE_OPS}")
    if nxt.device.type == "cpu":
        return pointer_chase_plain(nxt, start, hops)
    if nxt.device.type != "cuda":
        raise ValueError(f"pointer_chase runs on CUDA or CPU, not {nxt.device}")
    if not nxt.is_contiguous():
        raise ValueError("nxt must be contiguous")
    if space == "shared" and n > SHARED_MAX_ENTRIES:
        raise ValueError(f"{n} entries do not fit a block's shared memory "
                         f"({SHARED_MAX_ENTRIES} at most)")
    if timing is not None and (timing.device != nxt.device
                               or timing.dtype != torch.int64
                               or timing.numel() < 2
                               or not timing.is_contiguous()):
        raise ValueError("timing must be a contiguous int64 CUDA tensor of 2")
    out = torch.empty((), dtype=torch.int32, device=nxt.device)
    rc = _launcher()(nxt.data_ptr(), n, start, hops, SPACES.index(space),
                     CACHE_OPS.index(cache_op), int(bool(warm)),
                     out.data_ptr(),
                     None if timing is None else timing.data_ptr(),
                     torch.cuda.current_stream(nxt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pointer_chase kernel launch failed (rc={rc})")
    pointer_chase.launches += 1
    return out


pointer_chase.launches = 0
