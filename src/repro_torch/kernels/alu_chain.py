"""ALU-chain probe: the wrapper around the CUDA kernel (``csrc/alu_chain.cu``),
which replaces the TPU Pallas kernel ``repro.kernels.microbench_alu.alu_chain``.

A tensor on the CPU goes to the plain version (``ref.alu_chain_plain``); a
CUDA tensor launches the kernel or raises, with no fallback.  The kernel takes
one (8,128) tile (one element per thread) in f32, bf16 or int32 and any of the
harness's 21 ops where the harness runs them (``ref.alu_legal``).  With
``timing=`` (a CUDA int64 tensor of 2) it writes the chain's in-kernel
``clock64()`` cycles and ``%globaltimer`` nanoseconds there.

``alu_chain.launches`` counts kernel launches (plain integer; reset it to 0
before a run to prove the run went through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ALU_OPS, alu_chain_plain, alu_legal

# MUFU-class ops: approximate instructions on the card
MUFU_OPS = {"rsqrt", "sqrt", "exp", "log", "sin", "tanh", "sigmoid"}
# op name -> id: the order of the kernel's ``enum Op``
OP_IDS = {name: i for i, name in enumerate(ALU_OPS)}
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
TILE = (8, 128)
_fn = None


def tolerance(op, dtype, length):
    """The kernel's tolerance against the plain version for a chain of
    ``length`` ops: int32 exact; otherwise ``length`` times one op's error
    (at least twice it).  One op errs by at most: bf16 one ulp (2^-8; the
    kernel rounds once per op, PyTorch at each intermediate step); f32
    tanh.approx 2^-11 relative, the other approximate MUFU ops 2^-20,
    relative or absolute (sin.approx and lg2.approx bound the absolute
    error), the rest one f32 ulp (2^-23; FFMA rounds once where y*c + c
    rounds twice)."""
    if dtype == torch.int32:
        return dict(rtol=0.0, atol=0.0)
    n = max(2, int(length))
    if dtype == torch.bfloat16:
        return dict(rtol=n * 2.0 ** -8, atol=1e-5)
    if op in MUFU_OPS:
        per = 2.0 ** -11 if op == "tanh" else 2.0 ** -20
        return dict(rtol=n * per, atol=max(1e-6, n * 2.0 ** -20))
    return dict(rtol=n * 2.0 ** -23, atol=1e-6)


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("alu_chain").alu_chain_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, I, P, P, P, I, P, P]
        fn.restype = I
        _fn = fn
    return _fn


def alu_chain(x, c, *, op="fma", length=64, dependent=True, timing=None):
    """x [8,128]; c scalar (or 0-d tensor) -> the chained result [8,128] in
    x's dtype: ``length`` ops threaded through one value (dependent) or
    over ``x + i`` kept live by ``out + y * 0`` (independent)."""
    if op not in ALU_OPS:
        raise ValueError(f"unknown op {op!r}; ops: {', '.join(ALU_OPS)}")
    if not alu_legal(op, x.dtype):
        raise ValueError(f"op {op!r} is not run in {x.dtype}")
    if int(length) <= 0:
        raise ValueError("length must be positive")
    if x.device.type == "cpu":
        return alu_chain_plain(x, c, op=op, length=int(length),
                               dependent=dependent)
    if x.device.type != "cuda":
        raise ValueError(f"alu_chain runs on CUDA or CPU, not {x.device}")
    if tuple(x.shape) != TILE or not x.is_contiguous():
        raise ValueError(f"the kernel takes one contiguous {TILE} tile, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_IDS:
        raise TypeError(f"x must be f32, bf16 or int32, got {x.dtype}")
    cv = torch.as_tensor(c, dtype=x.dtype).reshape(()).to(x.device)
    cbuf = torch.stack([cv, cv, torch.zeros_like(cv)])
    if timing is not None and (timing.device != x.device
                               or timing.dtype != torch.int64
                               or timing.numel() < 2
                               or not timing.is_contiguous()):
        raise ValueError("timing must be a contiguous int64 CUDA tensor of 2")
    out = torch.empty_like(x)
    rc = _launcher()(OP_IDS[op], _DTYPE_IDS[x.dtype], int(bool(dependent)),
                     x.data_ptr(), cbuf.data_ptr(), out.data_ptr(),
                     int(length), None if timing is None else timing.data_ptr(),
                     torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"alu_chain kernel launch failed (rc={rc})")
    alu_chain.launches += 1
    return out


alu_chain.launches = 0
