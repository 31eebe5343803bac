"""Design measurements of the tensor-core flash-attention backward
(``csrc/flash_attention_bwd_mma.cu``) on one CUDA card; what ``PERF.md``
cites for the kernel's design.  Not part of the package: run from the
repository's root,

  PYTHONPATH=src python tools/flash_attention_bwd_design.py [--parts split,...]
      [--parent DIR]

prints one JSON object with the card's name and power limit, the parts
asked for (all by default) and ``ptxas``, every variant build's ``ptxas
-v`` lines.

Every part times ``flash_attention_bwd`` at the train path's bf16 shapes
(``CASES``: gemma2-2b B=4, gemma3-1b B=4 and internlm2-20b B=2 at 512
tokens, causal, softcap and window off, and gemma2-2b with window 128 and
softcap 50), each setting in turns in one process (A, B, ..., then in
reverse, twice), and reports for each ``stream_ms`` (20 calls back to back
between a CUDA event pair, over 20, median of 5; ``chip_smoke.stream_ms``:
host-bound where the wrapper's host work outlasts the kernels),
``graph_ms`` (the same 20 calls captured in one CUDA graph and replayed:
device time alone) and ``max_rel``, the largest gradient's max |got - want| / max|want|
against ``ref.flash_attention_bwd_mma_plain`` (probes are not the
function).

``split``: the group split (``bwd_split``) at the aims
``BWD_BLOCKS_PER_SM`` 0 (no split: one block per KV head loops over its
whole group), 1 (the wrapper's), 2 and 64 (every query head its own
block, up to 8 a cluster), with the ``ns`` each gives.

Parts that compare builds compile copies of the source with one change
each (text substitutions, checked to apply), and bind each in turn in
place of the wrapper's library: ``exp``, ``expf`` (the kernel) or
``__expf`` (``fast_exp``: MUFU.EX2 without expf's range reduction);
``bounds``, the dq kernel at ``__launch_bounds__(256, 2)`` for DP <=
128 (the kernel: two blocks an SM at internlm2's D=128, ptxas fitting 128
registers) or at one block an SM (``dq_1_block``); ``probes``,
builds that are not the function: the dq kernel alone (``dq_only``: the
dk/dv kernel not launched) and the dk/dv kernel alone (``dkdv_only``: the
dq kernel not launched, so D is stale),
the time of each kernel of the pair; ``phases``, each kernel alone (as in
``probes``) with one of its parts not run: the S and dP products
(``*_no_sdp``, ``dkdv_no_st``), the elementwise P and dS (scale, cap,
exp: ``*_no_elementwise``), the accumulating products (``dq_no_dq_mma``,
``dkdv_no_acc``) and the ring's next tile (``*_no_loads``: the slots
keep the first tile).

``profile``: at the cases with neither window nor softcap, the kernel's
and SDPA's backward (``torch.autograd.grad`` through
``F.scaled_dot_product_attention``) by ``torch.profiler``: device us a
call by kernel name, and the host's us to enqueue a call.

``train`` (not in the default parts; needs ``--parent``, another
checkout's root, say a ``git archive`` of the parent commit): phase
``train`` (a) of ``chip_smoke.py`` (full-width gemma2-2b, 3 AdamW steps)
of the parent and of this tree in turns, parent, change, change, parent,
parent, change, each in a process of its own: each run's step walls.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# name -> (B, H, KH, D, window, softcap), 512 tokens, causal
CASES = {"gemma2": (4, 8, 4, 256, None, None),
         "gemma3": (4, 4, 1, 256, None, None),
         "internlm2": (2, 48, 8, 128, None, None),
         "gemma2_w128_cap50": (4, 8, 4, 256, 128, 50.0)}
S = 512

_DQ_LAUNCH = ("  fa_bwd_dq_mma<DP><<<dim3(a.H, a.B, (a.Sq + kT - 1) / kT), "
              "kThreads,\n")
_DKDV_LAUNCH = "  const dim3 grid(a.KH * a.ns"
_NEVER = "(a.B < 0 ? {} : 0)"    # a loop bound that is 0 at run time
_DQ_ONLY = [("  " + _DKDV_LAUNCH.strip(), "  return (int)e;\n  "
             + _DKDV_LAUNCH.strip(), 1)]
_DKDV_ONLY = [(_DQ_LAUNCH, "  if (a.B < 0)\n" + _DQ_LAUNCH, 1)]
_DQ_BOUNDS = "__launch_bounds__(kThreads, DP <= 128 ? 2 : 1)\n    fa_bwd_dq_mma("
_SDP_LOOP = ("    for (int kk = 0; kk < kKSteps; ++kk) {\n"
             "      uint32_t aq[4], ag[4];\n")
_DQ_LOOP = "    for (int kk = 0; kk < 2; ++kk) {\n      const uint32_t af[4]"
_DQ_ELEM = ("        const float x = capped(s[t][e], a, &dc);\n"
            "        float p = expf(x - (hi ? L1 : L0));\n")
_ST_LOOP = ("    for (int kk = 0; kk < kKSteps; ++kk) {\n"
            "      uint32_t ak[4], av[4];\n")
_ACC_LOOP = "    for (int kk = 0; kk < kT / 16; ++kk) {\n"
_DKDV_ELEM = ("        const float x = capped(st[t][e], a, &dc);\n"
              "        float p = expf(x - Lc[e & 1]);\n")
# part -> variant -> [(old, new, count)]
VARIANTS = {
    "exp": {"kernel": [], "fast_exp": [("expf(x - ", "__expf(x - ", 2)]},
    "bounds": {"kernel": [],
               "dq_1_block": [(_DQ_BOUNDS, _DQ_BOUNDS.replace(
                   "DP <= 128 ? 2 : 1", "1"), 1)]},
    "probes": {"kernel": [], "dq_only": _DQ_ONLY, "dkdv_only": _DKDV_ONLY},
    "phases": {
        "dq_only": _DQ_ONLY,
        "dq_no_sdp": _DQ_ONLY + [(_SDP_LOOP, _SDP_LOOP.replace(
            "kk < kKSteps", "kk < " + _NEVER.format("kKSteps")), 1)],
        "dq_no_elementwise": _DQ_ONLY + [(_DQ_ELEM, (
            "        dc = 1.f;\n        const float x = s[t][e];\n"
            "        float p = x;\n"), 1)],
        "dq_no_dq_mma": _DQ_ONLY + [(_DQ_LOOP, _DQ_LOOP.replace(
            "kk < 2", "kk < " + _NEVER.format("2")), 1)],
        "dq_no_loads": _DQ_ONLY + [("    fetch(j + 1);\n", (
            "    if (a.B < 0) fetch(j + 1);\n    else cp_async_commit();\n"),
            1)],
        "dkdv_only": _DKDV_ONLY,
        "dkdv_no_st": _DKDV_ONLY + [(_ST_LOOP, _ST_LOOP.replace(
            "kk < kKSteps", "kk < " + _NEVER.format("kKSteps")), 1)],
        "dkdv_no_elementwise": _DKDV_ONLY + [(_DKDV_ELEM, (
            "        dc = 1.f;\n        const float x = st[t][e];\n"
            "        float p = x;\n"), 1)],
        "dkdv_no_acc": _DKDV_ONLY + [(_ACC_LOOP, _ACC_LOOP.replace(
            "kk < kT / 16", "kk < " + _NEVER.format("kT / 16")), 1)],
        "dkdv_no_loads": _DKDV_ONLY + [("    fetch(n + 1);\n", (
            "    if (a.B < 0) fetch(n + 1);\n    else cp_async_commit();\n"),
            1)]},
}
PTXAS: dict = {}       # build name -> its ptxas -v lines


def _source(subs, name="") -> str:
    src = (_build.CSRC / f"{fa.BWD_MMA}.cu").read_text()
    for old, new, count in subs:
        if src.count(old) != count:
            raise RuntimeError(f"{name}: anchor not found {count}x: {old!r}")
        src = src.replace(old, new)
    return src


def _compile_lib(name: str, src: str) -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{name}.cu"
    lib = _build.BUILD_DIR / f"lib{name}.so"
    path.write_text(src)
    proc = subprocess.run([_build._tool("nvcc"), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(path)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    PTXAS[name] = [ln.strip() for ln in (proc.stdout + proc.stderr)
                   .splitlines() if "registers" in ln or "spill" in ln
                   or "Compiling entry" in ln]
    return ctypes.CDLL(str(lib))


def _bind(lib: ctypes.CDLL):
    fn = lib.flash_attention_bwd_mma_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 10 + [I] * 7 + [F, I, I, F, P]
    fn.restype = I
    return fn


def _inputs():
    """Each case's q, k, v, out, d_out, lse and keywords, and the plain
    version's gradients."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for case, (B, H, KH, D, window, softcap) in CASES.items():
        c = dict(B=B, H=H, KH=KH, D=D, window=window, softcap=softcap)
        q, k, v, out, dout, kw = chip_smoke.flash_bwd_inputs(
            torch, g, dev, c, torch.bfloat16, S=S)
        lse, _ = chip_smoke.flash_bwd_lse(torch, q, k, v, out, kw)
        want = ref.flash_attention_bwd_mma_plain(q, k, v, out, dout, lse,
                                                 **kw)
        data[case] = ((q, k, v, out, dout, lse), kw, want)
    return data


def graph_ms(fn, n=20, reps=5):
    """Device time of ``fn``: ``n`` calls captured in one CUDA graph,
    replayed between a CUDA event pair, over ``n``; the median of
    ``reps`` replays.  No host cost: ``stream_ms`` of a call whose host
    part takes longer than its kernels times the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _measure(res, name, data):
    for case, (args, kw, want) in data.items():
        r = res[name].setdefault(case, {"stream_ms": [], "graph_ms": []})
        got = fa.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        r["max_rel"] = max(chip_smoke.flash_bwd_ratios(got, want))
        r["ns"] = fa.bwd_split(args[0].shape[0], S, args[0].shape[2],
                               args[1].shape[2])

        def call():
            return fa.flash_attention_bwd(*args, **kw)
        r["stream_ms"].append(chip_smoke.stream_ms(torch, call))
        r["graph_ms"].append(graph_ms(call))


def compare(part: str, data) -> dict:
    sources = {name: _source(subs, name)
               for name, subs in VARIANTS[part].items()}
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {name: pool.submit(
            lambda n, src: _bind(_compile_lib(f"fa_bwd_{part}_{n}", src)),
            name, src) for name, src in sources.items()}
        builds = {name: f.result() for name, f in futures.items()}
    res = {name: {} for name in builds}
    order = list(builds)
    for name in (order + order[::-1]) * 2:
        fa._fns[fa.BWD_MMA] = builds[name]
        _measure(res, name, data)
    fa._fns.pop(fa.BWD_MMA)
    return res


def split(data) -> dict:
    aims, aim = (0, 1, 2, 64), fa.BWD_BLOCKS_PER_SM
    res = {str(n): {} for n in aims}
    for n in (aims + aims[::-1]) * 2:
        fa.BWD_BLOCKS_PER_SM = n
        fa.bwd_split.cache_clear()
        _measure(res, str(n), data)
    fa.BWD_BLOCKS_PER_SM = aim
    fa.bwd_split.cache_clear()
    return res


def _sdpa_bwd(args, kw):
    """SDPA's backward alone on the same q, k, v and cotangent (causal,
    GQA; window and softcap off), as phase ``flash_bwd_kernel`` times it."""
    import torch.nn.functional as F
    q, k, v, _, dout, _ = args
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       scale=kw["scale"], enable_gqa=True)
    go = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(o, (qt, kt, vt), go,
                                       retain_graph=True)


def _profile_one(fn, n=20) -> dict:
    """Device us a call of ``fn`` by kernel name (``torch.profiler``, n
    calls) and the host's us to enqueue a call (200 calls, no sync)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = {e.key[:80]: e.device_time_total / n
               for e in prof.key_averages() if e.device_time_total > 0}
    t = time.perf_counter()
    for _ in range(200):
        fn()
    host = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    return {"device_us": sum(kernels.values()), "kernels_us": kernels,
            "host_us": host}


def profile_part(data) -> dict:
    """The kernel's and SDPA's backward device time by kernel and host
    time a call, at each case SDPA computes the same function."""
    out = {}
    for case, (args, kw, _) in data.items():
        if kw["window"] is not None or kw["softcap"] is not None:
            continue
        out[case] = {
            "kernel": _profile_one(lambda: fa.flash_attention_bwd(*args,
                                                                  **kw)),
            "sdpa": _profile_one(_sdpa_bwd(args, kw))}
    return out


TRAIN_ORDER = ("parent", "change", "change", "parent", "parent", "change")


def train_one(root: Path) -> dict:
    """Phase ``train`` (a) of the ``chip_smoke.py`` at ``root`` (its
    ``src`` first on the path): full-width gemma2-2b, 3 AdamW steps."""
    spec = importlib.util.spec_from_file_location("chip_smoke_train",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    line, failed = cs.train_full(torch, 0)
    return {"step_ms": line["step_ms"],
            "median_step_ms_2_3": line["median_step_ms_2_3"],
            "launches_per_step": line["launches_per_step"][0],
            "losses": line["losses"], "failed": failed}


def train_part(parent: Path) -> dict:
    """Phase ``train`` (a) of ``parent`` (another checkout's root) and of
    this tree in turns (``TRAIN_ORDER``), each in a process of its own
    with that tree's ``src`` on the path."""
    import os
    import sys
    res = {"parent": [], "change": []}
    for side in TRAIN_ORDER:
        root = parent.resolve() if side == "parent" else ROOT
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run([sys.executable, __file__, "--train-root",
                               str(root)], capture_output=True, text=True,
                              env=env, check=True)
        res[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return res


PARTS = ("split",) + tuple(VARIANTS) + ("profile",)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS} and train")
    ap.add_argument("--parent", type=Path,
                    help="another checkout's root, for the train part")
    ap.add_argument("--train-root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_bwd_design needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.train_root is not None:
        print(json.dumps(train_one(args.train_root)))
        return 0
    parts = args.parts.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    data = _inputs() if set(parts) - {"train"} else {}
    for part in parts:
        if part == "split":
            out[part] = split(data)
        elif part == "profile":
            out[part] = profile_part(data)
        elif part == "train":
            if args.parent is None:
                raise SystemExit("the train part needs --parent")
            out[part] = train_part(args.parent)
        else:
            out[part] = compare(part, data)
    out["ptxas"] = PTXAS
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
