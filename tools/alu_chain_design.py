"""Design measurements of the ALU-chain probe (``csrc/alu_chain.cu``) on one
CUDA card; what ``PERF.md`` cites for the kernel's design.  Not part of the
package: run from the repository's root,

  PYTHONPATH=src python tools/alu_chain_design.py [--parts variants,host,...]

prints one JSON object with the card's name and the parts asked for (all by
default), and writes it to ``alu_chain_design.json`` in ``chip_smoke.py``'s
output directory.

* ``variants``: copies of the kernel's source with one change each (text
  substitutions, checked to apply; instances cut to ``CELLS``' ops), built
  at once and measured in turns (A, B, ..., then in reverse): for each cell
  the harness's cycles per op (``chip_smoke.alu_readings``: the in-kernel
  cycles' slope over lengths 4, 16, 64, 256) and the SASS of its 256-op
  body (``alu_chain.timed_body``: instructions per op, top opcodes).  The
  variants: ``ship`` (the kernel); ``loop8`` and ``loop64`` (no body of
  its own for a sweep length: every length runs the counted loop of 8 or
  64 ops, so the slope carries the loop's counter, compare and branch, and
  the independent terms a run-time counter); ``side_xor1`` (one side
  word, an XOR, as before this design), ``side_xor4`` (four in turn, XOR),
  ``side_imad1`` (one, IMAD), ``side_none`` (none); ``tail_imad`` (the
  int32 mul tail an IMAD, as the other ops'); ``acc1`` (= the
  ``serial_tail`` control), ``acc2``, ``acc4``, ``acc16`` (accumulators of
  the independent tail);
  ``const_c_guarded`` (c a compile-time constant, the chain's guards kept)
  and the ``ALU_FAULTS`` controls of ``chip_smoke.py``.
* ``host``: ``chip_smoke.alu_call_gates`` on the kernel and the
  ``host_side_cbuf`` control (device kernels and copies of one call under
  torch.profiler, event-timed ms of a length-1 call and of one
  ``torch.add``), and where a call's time goes: the wrapper with each
  form of c and its pieces (the bare ctypes launch, ``torch.empty_like``,
  the raw stream, the scalar's bits) beside ``torch.add``, each as host
  us a call (1,000 queued without a sync, over 1,000), ms of one call
  between an event pair, and device ms of one call behind a device
  sleep.
* ``values``: every (op, dtype, mode) against the plain version at lengths
  1, 4, 12, 256 and 300, the failures listed, not raised.
* ``sass``: the kernel's full build (seconds, library bytes, SASS lines)
  and the 256-op body of every instance (``alu_chain.timed_body``).
* ``parent`` (with ``--parent DIR``, not in the default parts): the SASS
  blocks of another tree's kernel for ``CELLS``' ops, for the instructions
  an op before this design.
"""
from __future__ import annotations

import importlib.util
import json
import re
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import alu_chain as talu

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CELLS = tuple((op, dt, dep) for op, dt in (
    ("add", "float32"), ("mul", "float32"), ("fma", "float32"),
    ("max", "float32"), ("exp", "float32"), ("add", "int32"),
    ("mul", "int32"), ("and", "int32"), ("max", "int32"),
    ("add", "bfloat16"), ("fma", "bfloat16")) for dep in (True, False))
OPS_CUT = {"FLOAT_OPS": "X(ADD) X(MUL) X(FMA) X(MAX) X(EXP)",
           "INT_OPS": "X(ADD) X(MUL) X(AND) X(MAX)"}

_DEP_SWITCH = "  switch (length) {\n    case 4: dep_ops"
_IND_SWITCH = "  switch (length) {\n    case 4: ind_ops"
_NO_BODIES = [(_DEP_SWITCH, "  switch (0) {\n    case 4: dep_ops"),
              (_IND_SWITCH, "  switch (0) {\n    case 4: ind_ops")]
_SIDE = "  return sizeof(T) == 2 ? s ^ b : s * m + b;"
_KSIDE = "constexpr int kSide = 4;"
_TAIL = "    return OP == MUL ? acc ^ (y & z) : y * z + acc;"
_KACC = "constexpr int kAcc = 8;"
_KBLOCK = "constexpr int kBlock = 8;"
VARIANTS = {
    "ship": [],
    "loop8": _NO_BODIES,
    "loop64": _NO_BODIES + [(_KBLOCK, "constexpr int kBlock = 64;")],
    "side_xor1": [(_SIDE, "  return s ^ b;"),
                  (_KSIDE, "constexpr int kSide = 1;")],
    "side_xor4": [(_SIDE, "  return s ^ b;")],
    "side_imad1": [(_KSIDE, "constexpr int kSide = 1;")],
    "side_none": [(_SIDE, "  return s;")],
    "tail_imad": [(_TAIL, "    return y * z + acc;")],
    **{f"acc{n}": [(_KACC, f"constexpr int kAcc = {n};")]
       for n in (1, 2, 4, 16)},
    "const_c_guarded": chip_smoke.ALU_FAULTS["const_c"][:1],
    **{k: v for k, v in chip_smoke.ALU_FAULTS.items() if k != "serial_tail"},
}


def _key(cell):
    op, dt, dep = cell
    return f"{op}.{dt}.{'dep' if dep else 'ind'}"


def variants() -> dict:
    srcs = {f"alu_chain_{name}": chip_smoke.alu_source(subs, OPS_CUT)
            for name, subs in VARIANTS.items()}
    t0 = time.perf_counter()
    libs = _build.build_all([], variants=srcs)
    out = {"build_s": time.perf_counter() - t0,
           "build_seconds": {n: _build.BUILD_LOG[n]["seconds"] for n in libs}}
    fns = {n: chip_smoke.alu_bind(p) for n, p in libs.items()}
    bodies = {n: talu.timed_body(_build.sass(p)) for n, p in libs.items()}
    dev = torch.device("cuda")
    runs = {n: [] for n in libs}
    order = list(libs)
    for name in order + order[::-1]:
        runs[name].append(chip_smoke.alu_readings(torch, dev, CELLS,
                                                  fns[name]))
    for name in order:
        short = name[len("alu_chain_"):]
        out[short] = {_key(c): {
            "cycles": [r[c] for r in runs[name]],
            "sass_per_op": bodies[name].get(c, {}).get("per_op"),
            "top": bodies[name].get(c, {}).get("top")} for c in CELLS}
    return out


def _device_ms(fn, n=20) -> float:
    """ms of one ``fn()`` queued behind a device sleep between a CUDA event
    pair (the host's share hidden), median of ``n``."""
    ts = []
    for _ in range(n + 3):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts[3:]))


def host(n=1000) -> dict:
    """Where a call's time goes: the call gates, and for the wrapper with
    each form of c, its pieces, ``torch.add`` and ``torch.empty_like``:
    host us a call (``n`` calls queued without a sync, over ``n``), ms one
    call between an event pair (as ``chip_smoke.gpu_ms``), and device ms
    one call behind a device sleep."""
    import ctypes
    dev = torch.device("cuda")
    x = torch.linspace(0.5, 1.5, 1024, device=dev).reshape(8, 128)
    c = 1.0009765625
    forms = {"number": c, "cuda_tensor": torch.tensor(c, device=dev),
             "cpu_tensor": torch.tensor(c)}
    out = chip_smoke.alu_call_gates(
        torch, x, forms,
        {"kernel": talu.alu_chain,
         "host_side_cbuf": lambda *a, **kw: chip_smoke.alu_host_side_cbuf(
             torch, *a, **kw)})
    t = torch.ones(1024, device=dev)
    fn = talu._launcher()
    o = torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(0)
    cb = talu.scalar_bits(c, torch.float32)
    args = (0, 0, 1, x.data_ptr(), None, cb, cb, 0, o.data_ptr(), 1, None,
            stream)
    cargs = (ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(1),
             ctypes.c_void_p(x.data_ptr()), None, ctypes.c_uint(cb),
             ctypes.c_uint(cb), ctypes.c_uint(0), ctypes.c_void_p(
                 o.data_ptr()), ctypes.c_int(1), None,
             ctypes.c_void_p(stream))
    calls = {f"kernel_{f}": (lambda cv=cv: talu.alu_chain(x, cv, op="add",
                                                          length=1))
             for f, cv in forms.items()}
    calls.update({
        "ctypes_launch": lambda: fn(*args),
        "ctypes_launch_cargs": lambda: fn(*cargs),
        "torch_add": lambda: torch.add(t, 1.0),
        "torch_add_out": lambda: torch.add(t, 1.0, out=t),
        "empty_like": lambda: torch.empty_like(x),
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "scalar_bits": lambda: talu.scalar_bits(c, torch.float32)})
    res = {}
    for name, call in calls.items():
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        res[name] = {"host_us": us,
                     "ms": chip_smoke.gpu_ms(torch, call, 30),
                     "device_ms": _device_ms(call)}
    out["pieces"] = res
    return out


def values() -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    fails, n = [], 0
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        if dt == torch.int32:
            x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (8, 128))
                                 .astype(np.int32)).to(dev)
        else:
            x = torch.from_numpy((rng.normal(size=(8, 128)) + 2.0)
                                 .astype(np.float32)).to(dt).to(dev)
        cv = torch.tensor(1.0009765625).to(dt).to(dev)
        for op in ref.ALU_OPS:
            if not ref.alu_legal(op, dt):
                continue
            for dep in (True, False):
                for length in (1, 4, 12, 256, 300):
                    out = talu.alu_chain(x, cv, op=op, length=length,
                                         dependent=dep)
                    want = ref.alu_chain_plain(x, cv, op=op, length=length,
                                               dependent=dep)
                    n += 1
                    try:
                        torch.testing.assert_close(
                            out.double(), want.double(), equal_nan=True,
                            **talu.tolerance(op, dt, length))
                    except AssertionError as e:
                        fails.append(f"{op}.{dt}.{dep}.{length}: "
                                     f"{str(e)[:200]}")
    return {"cases": n, "failed": fails}


def sass() -> dict:
    lib = _build.build("alu_chain")
    text = _build.sass(lib)
    log = _build.BUILD_LOG["alu_chain"]
    return {"build": {"cached": log["cached"], "seconds": log["seconds"],
                      "library_bytes": lib.stat().st_size,
                      "sass_lines": text.count("\n")},
            "bodies": {_key(k): v for k, v in
                       sorted(talu.timed_body(text).items())}}


def parent(root=None) -> dict:
    """The SASS of the kernel of another tree (``--parent``, a checkout's
    root): for the cells of ``CELLS``, each instance's blocks of 8 or more
    instructions (the parent times an 8-op unrolled body inside a counted
    loop, both modes in one function), with their opcode mix."""
    src = (Path(root) / "src/repro_torch/kernels/csrc/alu_chain.cu")
    text = _build.sass(_build.build("alu_chain_parent", src.read_text()))
    names = list(ref.ALU_OPS)
    want = {(op, dt) for op, dt, _ in CELLS}
    out = {}
    for fn, blocks in talu.sass_blocks(text).items():
        m = re.search(r"alu_chain_kernelI(f|i|\d+__nv_bfloat16)Li(\d+)E", fn)
        if m is None:
            continue
        key = (names[int(m.group(2))],
               {"f": "float32", "i": "int32"}.get(m.group(1), "bfloat16"))
        if key in want:
            out[".".join(key)] = [{"instructions": len(b),
                                   "top": talu.opcode_mix(b, 8)}
                                  for b in blocks if len(b) >= 8]
    return out


PARTS = ("sass", "values", "host", "variants")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS} and parent")
    ap.add_argument("--parent", default=None,
                    help="the root of another tree, for the part parent")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("alu_chain_design needs a CUDA card")
    import traceback
    out = {"card": torch.cuda.get_device_name(0)}
    chip_smoke.OUT.mkdir(exist_ok=True)
    rc = 0
    for part in parts:
        try:
            out[part] = (parent(args.parent) if part == "parent"
                         else globals()[part]())
        except Exception:           # the other parts still run
            out[part] = {"error": traceback.format_exc()}
            rc = 1
        (chip_smoke.OUT / "alu_chain_design.json").write_text(
            json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
