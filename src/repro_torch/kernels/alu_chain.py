"""ALU-chain probe: the wrapper around the CUDA kernel (``csrc/alu_chain.cu``),
which replaces the TPU Pallas kernel ``repro.kernels.microbench_alu.alu_chain``.

A tensor on the CPU goes to the plain version (``ref.alu_chain_plain``); a
CUDA tensor launches the kernel or raises, with no fallback.  The kernel takes
one (8,128) tile (one element per thread) in f32, bf16 or int32 and any of the
harness's 21 ops where the harness runs them (``ref.alu_legal``).  With
``timing=`` (a CUDA int64 tensor of 2) it writes the chain's in-kernel
``clock64()`` cycles and ``%globaltimer`` nanoseconds there.

One call is one launch and no other device work: ``c`` goes to the kernel as
its bits by value (a Python number, or a CPU tensor read on the host) or as
the address of a one-element CUDA tensor of x's dtype, which the kernel
reads; the output comes from the caching allocator.

``alu_chain.launches`` counts kernel launches (plain integer; reset it to 0
before a run to prove the run went through the kernel).
"""
from __future__ import annotations

import ctypes
import math
import re
import struct

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ALU_OPS, alu_chain_plain, alu_legal

# MUFU-class ops: approximate instructions on the card
MUFU_OPS = {"rsqrt", "sqrt", "exp", "log", "sin", "tanh", "sigmoid"}
# op name -> id: the order of the kernel's ``enum Op``
OP_IDS = {name: i for i, name in enumerate(ALU_OPS)}
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
# (op, dtype) -> (op id, dtype id): every instance the kernel has
_IDS = {(op, dt): (OP_IDS[op], d) for op in ALU_OPS
        for dt, d in _DTYPE_IDS.items() if alu_legal(op, dt)}
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


def scalar_bits(c, dtype) -> int:
    """The bits of the number ``c`` in ``dtype`` (f32, bf16 or int32) as an
    unsigned int, as ``torch.as_tensor(c, dtype=dtype)`` would hold them:
    f32 by C's round-to-nearest cast (inf past its range), bf16 from that
    f32 by round-to-nearest-even (NaN as 0x7FC0, as PyTorch), int32 by
    truncation toward zero."""
    if dtype == torch.int32:
        v = int(c)
        if not -2 ** 31 <= v < 2 ** 31:
            raise OverflowError(f"c={c} does not fit int32")
        return v & 0xFFFFFFFF
    v = float(c)
    try:
        b = struct.unpack("<I", struct.pack("<f", v))[0]
    except OverflowError:
        b = 0xFF800000 if v < 0 else 0x7F800000
    if dtype == torch.float32:
        return b
    if math.isnan(v):
        return 0x7FC0
    return (b + 0x7FFF + ((b >> 16) & 1)) >> 16


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load("alu_chain").alu_chain_launch
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        fn.argtypes = [I, I, I, P, P, U, U, U, P, I, P, P]
        fn.restype = I
        _fn = fn
    return _fn


def _check(op, dtype, length):
    """Raises where the harness does not run ``op`` in ``dtype`` or the
    length is not positive."""
    if op not in ALU_OPS:
        raise ValueError(f"unknown op {op!r}; ops: {', '.join(ALU_OPS)}")
    if not alu_legal(op, dtype):
        raise ValueError(f"op {op!r} is not run in {dtype}")
    if length <= 0:
        raise ValueError("length must be positive")


def prepare(x, c, *, op="fma", length=64, dependent=True, timing=None):
    """The work of one call on the card before its launch, done now: the
    checks, c's bits and the output from the caching allocator.  Returns
    ``(launch, out)``: ``launch()`` launches the kernel once into ``out``
    on the stream current now (and counts it), with no other host or
    device work; the harness times that alone.  Raises where the kernel
    does not take the call."""
    length = int(length)
    ids = _IDS.get((op, x.dtype))
    if ids is None or length <= 0 or not x.is_cuda:
        _check(op, x.dtype, length)
        if not x.is_cuda:
            raise ValueError(f"the kernel runs on CUDA, not {x.device}")
        raise TypeError(f"x must be f32, bf16 or int32, got {x.dtype}")
    if x.shape != TILE or not x.is_contiguous():
        raise ValueError(f"the kernel takes one contiguous {TILE} tile, "
                         f"got {tuple(x.shape)}")
    dev = x.get_device()
    cptr, cb = None, 0
    if isinstance(c, torch.Tensor) and c.is_cuda:
        if c.dtype != x.dtype or c.numel() != 1 or c.get_device() != dev:
            raise TypeError(f"a CUDA c must be one {x.dtype} element on "
                            f"x's card, got {c.dtype} {tuple(c.shape)} on "
                            f"{c.device}")
        cptr = c.data_ptr()
    else:
        cb = scalar_bits(c.item() if isinstance(c, torch.Tensor) else c,
                         x.dtype)
    tptr = None
    if timing is not None:
        if not (timing.is_cuda and timing.get_device() == dev
                and timing.dtype == torch.int64 and timing.numel() >= 2
                and timing.is_contiguous()):
            raise ValueError("timing must be a contiguous int64 CUDA tensor "
                             "of 2 on x's card")
        tptr = timing.data_ptr()
    out = torch.empty_like(x)
    fn = _launcher()
    args = (ids[0], ids[1], 1 if dependent else 0, x.data_ptr(), cptr, cb,
            cb, 0, out.data_ptr(), length, tptr,
            torch._C._cuda_getCurrentRawStream(dev))

    def launch():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"alu_chain kernel launch failed (rc={rc})")
        alu_chain.launches += 1

    return launch, out


def alu_chain(x, c, *, op="fma", length=64, dependent=True, timing=None):
    """x [8,128]; c a number or a one-element tensor -> the chained result
    [8,128] in x's dtype: ``length`` ops threaded through one value
    (dependent) or over ``x + i`` kept live by ``out + y * 0``
    (independent).  On the card ``c`` is a number, a CPU tensor, or a CUDA
    tensor of x's dtype on x's card (any other CUDA ``c`` raises: its
    conversion would be device work of its own)."""
    if x.is_cuda:
        launch, out = prepare(x, c, op=op, length=length,
                              dependent=dependent, timing=timing)
        launch()
        return out
    _check(op, x.dtype, int(length))
    if x.device.type != "cpu":
        raise ValueError(f"alu_chain runs on CUDA or CPU, not {x.device}")
    return alu_chain_plain(x, c, op=op, length=int(length),
                           dependent=dependent)


alu_chain.launches = 0


# cuobjdump -sass: a kernel function's header, an instruction (its
# opcode), a label line, and the opcodes that end a basic block
_SASS_FUNC = re.compile(r"Function : (\S+)")
_SASS_INST = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)")
_SASS_LABEL = re.compile(r"^\s*\.L_\w+:")
_SASS_ENDS = ("BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BSYNC",
              "BSSY", "WARPSYNC", "BREAK")
# alu_chain_kernel<T, OP, DEP>: T as mangled (f, i, or the bf16 struct)
_KERNEL_NAME = re.compile(r"alu_chain_kernelI(f|i|\d+__nv_bfloat16)"
                          r"Li(\d+)ELb([01])E")
_MANGLED_T = {"f": "float32", "i": "int32"}


def sass_blocks(sass: str) -> dict:
    """The basic blocks of each function in ``cuobjdump -sass`` output:
    ``{mangled name: [[opcode, ...], ...]}``, a block ending at a label or
    after a branch, exit, call or barrier."""
    out: dict = {}
    cur = None
    for line in sass.splitlines():
        m = _SASS_FUNC.search(line)
        if m:
            cur = []
            out[m.group(1)] = [cur]
            continue
        if cur is None:
            continue
        if _SASS_LABEL.match(line):
            cur = []
            out[list(out)[-1]].append(cur)
            continue
        m = _SASS_INST.search(line)
        if m:
            cur.append(m.group(1))
            if m.group(1).split(".")[0] in _SASS_ENDS:
                cur = []
                out[list(out)[-1]].append(cur)
    return out


def opcode_mix(block, top=6) -> dict:
    """The ``top`` most frequent opcodes of a block, with their counts."""
    counts: dict = {}
    for o in block:
        counts[o] = counts.get(o, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1])[:top])


def timed_body(sass: str, top: int = 6) -> dict:
    """Per kernel instance, its SASS for the 256-op body (the longest
    basic block of the instance): ``{(op, dtype, dependent): {"per_op":
    instructions over the body's ops (256 dependent, 255 independent),
    "instructions", "top": its most frequent opcodes}}``.  An op whose body
    branches (div, rem) has no block that long: ``per_op`` is None where
    the longest block holds fewer instructions than the body has ops."""
    names = list(ALU_OPS)
    out = {}
    for fn, blocks in sass_blocks(sass).items():
        k = _KERNEL_NAME.search(fn)
        if k is None:
            continue
        key = (names[int(k.group(2))], _MANGLED_T.get(k.group(1), "bfloat16"),
               k.group(3) == "1")
        body = max(blocks, key=len)
        ops = 256 if key[2] else 255
        out[key] = {"per_op": len(body) / ops if len(body) >= ops else None,
                    "instructions": len(body), "top": opcode_mix(body, top)}
    return out
