"""Design measurements of the wkv6 backward (``csrc/wkv6_bwd.cu``) on one
CUDA card; what ``PERF.md`` cites for the kernel's design.  Not part of the
package: run from the repository's root,

  PYTHONPATH=src python tools/wkv6_bwd_design.py
      [--parts variants,phases,profile,parent] [--parent DIR]

writes one JSON object with the card's name and power limit, the parts
asked for (``variants,phases`` by default) and ``ptxas``, every variant
build's ``ptxas -v`` lines, to ``--out`` (default
``chiprun_out/wkv6_bwd_design.json``) and prints it less ``ptxas``.

``variants`` and ``phases`` time ``wkv6_bwd`` at the train micro-batch
(``chip_smoke.WKV_BWD_TRAIN``, bf16, case "short"), each build in turns in
one process (A, B, ..., then in reverse, twice), and report for each
``stream_ms`` (20 calls back to back between a CUDA event pair, over 20,
median of 5), ``graph_ms`` (the same 20 calls captured in one CUDA graph
and replayed: device time alone) and ``max_rel``, the largest gradient's
max |got - want| / max|want| against ``ref.wkv6_bwd_plain`` in f64
(probes are not the function).  Each build is a copy of the source with
one change (text substitutions, checked to apply), bound in turn in place
of the wrapper's library; the wrapper sizes the workspace by
``BWD_SEG``, which a variant of another segment length sets to its own.

``variants``: segments of 32 or 48 steps (``seg_32``, ``seg_48``: more
segments, so more work in passes 1 and 2, and 3 or 5 state tiles a thread
kept in shared memory where 64 steps keep 7; 80 or more steps do not fit
the block's shared memory).

``phases``: each pass alone (``local``, ``combine``, ``main``: the other
launches left out, so a pass may read a stale workspace) and the third
pass without the forward sweep's arithmetic (``main_no_sweep``: the kept
states are the segment's start).

``profile``: one full-width rwkv6-1.6b train step (phase train (c) of
``chip_smoke.py``: 2 micro-batches of 2 x 4,096 tokens, AdamW, remat; the
second of two steps) under ``torch.profiler``: device ms by kernel (the
top 30) and by kind (the kinds' name patterns in ``KINDS``), the step's
device total and wall, and the peak memory.  With ``--parent`` the same of
the other tree first, each in a process of its own.

``parent`` (needs ``--parent``, another checkout's root, say a ``git
archive`` of the parent commit): phase ``wkv6_bwd_kernel`` of
``chip_smoke.py`` (its train-shape lines) and phase train (c)'s rwkv6
(``train_recurrent_full``: the median of steps 2-3, each step's wall, the
peak memory, the launches) of the parent and of this tree in turns,
parent, change, change, parent, each in a process of its own with that
tree's ``src`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import wkv6 as twkv

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import flash_attention_bwd_design as mma_design  # noqa: E402

chip_smoke = mma_design.chip_smoke
graph_ms, PTXAS = mma_design.graph_ms, mma_design.PTXAS

_SEG = "constexpr int kSeg = 64;"
_LOCAL = "  wkv6_bwd_local<T, N><<<"
_COMBINE = "  wkv6_bwd_combine<<<"
_MAIN = "  wkv6_bwd_kernel<T, N><<<"
_DU = "  wkv6_bwd_du<<<"


def _unlaunched(*launches):
    """Substitutions that leave these launches out."""
    return [(x, "  if (B < 0)\n" + x, 1) for x in launches]


# part -> variant -> ([(old, new, count)], segment length)
VARIANTS = {
    "variants": {
        "kernel": ([], 64),
        "seg_32": ([(_SEG, "constexpr int kSeg = 32;", 1)], 32),
        "seg_48": ([(_SEG, "constexpr int kSeg = 48;", 1)], 48)},
    "phases": {
        "kernel": ([], 64),
        "local": (_unlaunched(_COMBINE, _MAIN, _DU), 64),
        "combine": (_unlaunched(_LOCAL, _MAIN, _DU), 64),
        "main": (_unlaunched(_LOCAL, _COMBINE, _DU), 64),
        "main_no_sweep": (_unlaunched(_LOCAL, _COMBINE, _DU) + [
            ("        step_tile(st, wi, ki, vj);", "", 1)], 64)},
}


def _source(subs, name="") -> str:
    src = (_build.CSRC / "wkv6_bwd.cu").read_text()
    for old, new, count in subs:
        if src.count(old) != count:
            raise RuntimeError(f"{name}: anchor not found {count}x: {old!r}")
        src = src.replace(old, new)
    return src


def _bind(lib):
    fn = lib.wkv6_bwd_launch
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P] * 12 + [L] + [I] * 5 + [P]
    fn.restype = I
    return fn


def _inputs():
    g = torch.Generator(device="cuda").manual_seed(0)
    shape = chip_smoke.WKV_BWD_TRAIN
    args = chip_smoke.wkv_inputs(torch, g, "cuda", *shape.values(),
                                 torch.bfloat16, "short")
    dy = torch.randn(args[0].shape, generator=g,
                     device="cuda").to(torch.bfloat16)
    want = ref.wkv6_bwd_plain(*(t.double() for t in args), dy.double())
    return args, dy, want


def compare(part: str) -> dict:
    builds = VARIANTS[part]
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        futures = {name: pool.submit(
            lambda n, subs: _bind(mma_design._compile_lib(
                f"wkv6_bwd_{part}_{n}", _source(subs, n))), name, subs)
            for name, (subs, _) in builds.items()}
        libs = {name: f.result() for name, f in futures.items()}
    args, dy, want = _inputs()
    res = {name: {"stream_ms": [], "graph_ms": [], "seg": seg}
           for name, (_, seg) in builds.items()}
    order = list(libs)
    seg0 = twkv.BWD_SEG
    try:
        for name in (order + order[::-1]) * 2:
            twkv._fns["wkv6_bwd"] = libs[name]
            twkv.BWD_SEG = builds[name][1]
            r = res[name]

            def call():
                return twkv.wkv6_bwd(*args, dy)
            got = call()
            torch.cuda.synchronize()
            r["max_rel"] = max(chip_smoke.flash_bwd_ratios(got, want))
            r["stream_ms"].append(chip_smoke.stream_ms(torch, call))
            r["graph_ms"].append(graph_ms(call))
    finally:
        twkv._fns.pop("wkv6_bwd", None)
        twkv.BWD_SEG = seg0
    return res


# kind -> name patterns of its kernels (the first kind that matches)
KINDS = {"wkv6_bwd": ("wkv6_bwd",), "wkv6": ("wkv6_kernel",),
         "matmul": ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "cublas"),
         "optimizer": ("multi_tensor", "foreach", "adam"),
         "softmax_loss": ("softmax", "nll", "cross_entropy", "log_"),
         "reduce": ("reduce",),
         "elementwise": ("elementwise", "vectorized", "unrolled", "copy",
                         "fill", "cat", "index")}


def _kind(name: str) -> str:
    low = name.lower()
    for kind, pats in KINDS.items():
        if any(p in low for p in pats):
            return kind
    return "other"


def profile_one() -> dict:
    """Phase train (c)'s rwkv6 step (the second of two) by
    ``torch.profiler``: device ms by kernel and kind."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import train
    cfg = get_config("rwkv6-1.6b").replace(
        microbatch=chip_smoke.TRAIN_RECURRENT_MICRO)
    model = build_model(cfg, device="cuda")
    params = model.init(0, dtype=torch.float32)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def hook(step, _):
        if step == 0:
            prof.start()
        elif step == 1:
            prof.stop()
    torch.cuda.reset_peak_memory_stats()
    res = train(model, params=params, seed=0, hooks=[hook],
                **dict(chip_smoke.TRAIN_RECURRENT, num_steps=2))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kernels, kinds = {}, {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and e.device_type.name == "CUDA":
            ms = e.device_time_total / 1e3
            kernels[e.key[:100]] = {"ms": ms, "calls": e.count}
            kinds[_kind(e.key)] = kinds.get(_kind(e.key), 0.0) + ms
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:30])
    return {"step_ms": [1e3 * t for t in res.step_times_s],
            "device_ms": sum(k["ms"] for k in kernels.values()),
            "kinds_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels": top, "peak_gib": peak}


def tree_one() -> dict:
    """This process's tree: phase wkv6_bwd_kernel's train-shape lines and
    phase train (c)'s rwkv6."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        chip_smoke.phase_wkv6_bwd_kernel(torch, torch.device("cuda"), 0)
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    train = [{k: x[k] for k in ("case", "ms", "stream_ms", "bound_ms")}
             for x in lines if x.get("label") == "train"]
    line, failed = chip_smoke.train_recurrent_full(torch, 0, "rwkv6-1.6b")
    keep = ("step_ms", "median_step_ms_2_3", "tokens_per_s", "peak_gib",
            "launches_per_step")
    return {"wkv6_bwd_kernel": train, "failed": failed,
            "train_c": {k: line[k] for k in keep}}


TREE_ORDER = ("parent", "change", "change", "parent")


def _in_tree(root: Path, flag: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           flag, "--tree", str(root)], capture_output=True,
                          text=True, env=env)
    if proc.returncode:
        raise RuntimeError(f"{root} {flag}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def parent_part(parent: Path) -> dict:
    res = {"parent": [], "change": []}
    for side in TREE_ORDER:
        res[side].append(_in_tree(parent.resolve() if side == "parent"
                                  else ROOT, "--tree-one"))
    return res


def profile_part(parent) -> dict:
    sides = ([("parent", parent.resolve())] if parent else []) + [
        ("change", ROOT)]
    return {side: _in_tree(root, "--profile-one") for side, root in sides}


PARTS = tuple(VARIANTS)


def main(argv=None) -> int:
    import argparse
    global chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS}, profile and parent")
    ap.add_argument("--parent", type=Path,
                    help="another checkout's root, for parent and profile")
    ap.add_argument("--tree-one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--profile-one", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "wkv6_bwd_design.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_bwd_design needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.tree_one or args.profile_one:
        # that tree's own phase functions
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_tree", args.tree / "chip_smoke.py")
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        print(json.dumps(tree_one() if args.tree_one else profile_one()))
        return 0
    parts = args.parts.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    for part in parts:
        if part == "parent":
            if args.parent is None:
                raise SystemExit("the parent part needs --parent")
            out[part] = parent_part(args.parent)
        elif part == "profile":
            out[part] = profile_part(args.parent)
        else:
            out[part] = compare(part)
    print(json.dumps(out, indent=1))
    out["ptxas"] = PTXAS
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
