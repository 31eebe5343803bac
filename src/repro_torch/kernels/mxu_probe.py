"""Tensor-core probe: the wrapper around the CUDA kernel
(``csrc/mxu_probe.cu``: ``mma.sync`` on operands staged in shared memory),
which replaces the TPU Pallas kernel ``repro.kernels.mxu_probe.mxu_probe``.

A tensor on the CPU goes to the plain version (``ref.mxu_probe_plain``); a
CUDA tensor launches the kernel or raises, with no fallback.  Both refuse
what the reference refuses, with its messages: a block that does not divide
the problem, and a dependent chain over a non-square A.  The kernel takes
bf16 (m16n8k16) or f32 (tf32 m16n8k8), with every dimension and block a
multiple of 16, and its shared memory (``smem_bytes``) within a block's.
With ``timing=`` (a CUDA int64 tensor of 2) it writes the chain's
``clock64()`` cycles and ``%globaltimer`` nanoseconds there.

``smem_bytes`` is the kernel's own budget, line for line
(``mxu_probe_smem_bytes``); ``blocks_per_sm`` the occupancy the CUDA runtime
reports for a launch; ``throughput_reps`` the products one full wave of
blocks holds.  ``mxu_probe.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mxu_probe_plain

SMEM_MAX = 232448                    # 227 KB of shared memory a block
STAGES = 3                           # slots of the kernel's k-slab ring
HEAD_BYTES = 2048                    # mbarriers and the swizzle's alignment
MAX_UNITS = 8                        # mbarriers: column panels of a staged A
# the kernel's tolerance against the plain version, as a share of the
# plain output's largest magnitude: bf16 rounds each step to 8 bits either
# side of a tie in another summation order; f32 runs as tf32 (10-bit
# inputs, relative error 2^-11 per product, summed over K)
REL_TOL = 2e-2
_fns = None


def bind(lib: ctypes.CDLL) -> tuple:
    """The C entry points of a built ``csrc/mxu_probe.cu``: (launch,
    smem_bytes, blocks_per_sm)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    launch = lib.mxu_probe_launch
    launch.argtypes = [I, P, P, P, I, I, I, I, I, I, P, P]
    launch.restype = I
    smem = lib.mxu_probe_smem_bytes
    smem.argtypes = [I, I, I, I, I]
    smem.restype = ctypes.c_longlong
    occ = lib.mxu_probe_blocks_per_sm
    occ.argtypes = [I, I, I, I, I]
    occ.restype = I
    return launch, smem, occ


def _launchers():
    global _fns
    if _fns is None:
        _fns = bind(_build.load("mxu_probe"))
    return _fns


# the dtypes the kernel takes, as its C flag
_BF16 = {torch.bfloat16: 1, torch.float32: 0}


def _is_bf16(dtype) -> int:
    if dtype not in _BF16:
        raise TypeError(f"the kernel takes bf16 or f32, not {dtype}")
    return _BF16[dtype]


@functools.lru_cache(maxsize=None)
def _plan(bf16, K, bm, bn, chain):
    W = 64 if bf16 else 32               # elements of a 128-byte segment
    ni = 8 if bn % 64 == 0 and bf16 else (4 if bn % 32 == 0 else 2)
    wgn = 2 if bn >= 2 * 8 * ni else 1
    wgm = 8 // wgn
    pm, pn = 32 * wgm, 8 * ni * wgn
    rows_a, cols_b = min(pm, bm), min(pn, bn)
    pan_a, pan_b, pan_bs = -(-K // W), -(-bn // W), -(-cols_b // W)
    panel = 128 * K * pan_b
    staged_bytes = (2 if chain > 1 else 1) * panel + 128 * bm * pan_a
    staged = HEAD_BYTES + staged_bytes <= SMEM_MAX and pan_a <= MAX_UNITS
    tma = K % W == 0 and bn % W == 0 and (bm <= 256 or not staged)
    slot = 128 * rows_a + (128 * W * pan_bs if chain == 1 else 0)
    smem = HEAD_BYTES + (staged_bytes if staged else
                         (2 * panel if chain > 1 else 0) + STAGES * slot)
    return dict(ni=ni, wgm=wgm, wgn=wgn, pm=pm, pn=pn, rows_a=rows_a,
                cols_b=cols_b, pan_a=pan_a, pan_b=pan_b, pan_bs=pan_bs,
                staged=staged, tma=tma, smem=smem)


def plan(dtype, K, bm, bn, chain) -> dict:
    """The kernel's layout of a block (``make_plan`` in ``mxu_probe.cu``):
    a warp tile of 32 x 8 ``ni`` outputs on a ``wgm`` x ``wgn`` warp grid,
    so one pass covers ``pm`` x ``pn`` of the (bm, bn) tile.  Every shared
    tile is a row of 128-byte column panels (``pan_a`` of A [bm, K],
    ``pan_b`` of B's panel [K, bn]), swizzled by 16-byte chunk.
    ``staged`` where A and B's panel (two at chain > 1) stay in shared
    memory for the launch, else a ring of ``STAGES`` k-slabs of 128
    bytes; ``tma`` where the TMA unit loads them (K and bn whole panels,
    and a staged bm <= 256), else cp.async; ``smem`` the dynamic shared
    memory in bytes."""
    return dict(_plan(_is_bf16(dtype), int(K), int(bm), int(bn),
                      int(chain)))


def smem_bytes(dtype, K, bm, bn, chain) -> int:
    """Dynamic shared memory of a launch: 2 KB for the mbarriers and the
    1 KB alignment the swizzle needs, then, staged where it fits, B's
    panel [K, bn] (two at chain > 1: the double buffer) and the A tile
    [bm, K], each in 128-byte column panels (the last padded to 128
    bytes).  Else a ring of ``STAGES`` slots, each a 128-byte k-slab of
    min(pm, bm) A rows and, at chain 1, that slab's rows of min(pn, bn) B
    columns; at chain > 1 beside the two panels."""
    return _plan(_is_bf16(dtype), int(K), int(bm), int(bn),
                 int(chain))["smem"]


def blocks_per_sm(dtype, K, bm, bn, chain=1) -> int:
    """Blocks of a (bm, bn) launch that one SM holds at once, as the CUDA
    runtime's occupancy calculator reports it for the kernel (card only)."""
    n = _launchers()[2](_is_bf16(dtype), K, bm, bn, int(chain))
    if n < 0:
        raise RuntimeError(f"mxu_probe occupancy query failed for K={K}, "
                           f"block ({bm}, {bn}), chain {chain}")
    return n


def throughput_reps(sms, blocks_per_sm, tiles_per_product) -> int:
    """Independent products that make one full wave of the probe's blocks:
    ``ceil(sms * blocks_per_sm / tiles_per_product)``."""
    return max(1, -(-int(sms) * int(blocks_per_sm) // int(tiles_per_product)))


def mxu_probe(a, b, *, chain=4, block=(128, 128), timing=None):
    """a [M,K]; b [K,N] -> [M,N] in b's dtype: per (bm, bn) tile,
    C <- (A @ C) * 0.001 cast to the dtype, ``chain`` times, from C = b."""
    M, K = a.shape
    K2, N = b.shape
    if K2 != K:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         "chain")
    # the reference's min-clamp; a block that does not divide is refused
    bm, bn = max(min(block[0], M), 1), max(min(block[1], N), 1)
    if M % bm or N % bn:
        raise ValueError(
            f"mxu_probe block ({bm}, {bn}) must divide the problem "
            f"({M}, {N})")
    if chain > 1:
        assert M == K, "a dependent chain needs square A (C <- A @ C)"
    if (bm, bn) != (M, N):
        assert chain == 1 or bm == K
    if not a.is_cuda:
        if a.device.type == "cpu":
            return mxu_probe_plain(a, b, chain=chain)
        raise ValueError(f"mxu_probe runs on CUDA or CPU, not {a.device}")
    dt = a.dtype
    bf16 = _BF16.get(dt)
    dev = a.get_device()
    if bf16 is None or b.dtype != dt or b.get_device() != dev:
        raise TypeError("a and b must be bf16 or f32 tensors of one dtype on "
                        "one device")
    pa, pb = a.data_ptr(), b.data_ptr()
    if (pa | pb) % 32 or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous and 32-byte aligned")
    if (M | N | K | bm | bn) % 16:
        raise ValueError(f"the kernel takes dimensions and blocks that "
                         f"are multiples of 16, got M,N,K=({M},{N},{K}), "
                         f"block ({bm},{bn})")
    chain = int(chain)
    need = _plan(bf16, K, bm, bn, chain)["smem"]
    if need > SMEM_MAX:
        raise ValueError(f"block ({bm}, {bn}) at K={K}, chain {chain} needs "
                         f"{need} bytes of shared memory, more than "
                         f"{SMEM_MAX}")
    if timing is not None and (timing.get_device() != dev
                               or timing.dtype != torch.int64
                               or timing.numel() < 2
                               or not timing.is_contiguous()):
        raise ValueError("timing must be a contiguous int64 CUDA tensor of 2")
    out = a.new_empty(M, N)
    rc = _launchers()[0](bf16, pa, pb, out.data_ptr(), M, N, K, bm, bn,
                         chain, None if timing is None else timing.data_ptr(),
                         torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"mxu_probe kernel launch failed (rc={rc})")
    mxu_probe.launches += 1
    return out


mxu_probe.launches = 0
