"""Design measurements of the CUDA-core flash-attention backward
(``csrc/flash_attention_bwd.cu``, the f32 route) on one CUDA card; what
``PERF.md`` cites for the kernel's design.  Not part of the package: run
from the repository's root,

  PYTHONPATH=src python tools/flash_attention_bwd_f32_design.py
      [--parts split,variants,phases,profile,parent] [--parent DIR]

prints one JSON object with the card's name and power limit, the parts
asked for (all but ``parent`` by default) and ``ptxas``, every variant
build's ``ptxas -v`` lines.

Every part times ``flash_attention_bwd`` in f32 at the train path's
shapes at B 1 (``CASES``: ``chip_smoke.FLASH_BWD_CASES``, 512 tokens,
causal), fed the CUDA-core forward's L, each setting in turns in one
process (A, B, ..., then in reverse, twice), and reports for each
``stream_ms`` (20 calls back to back between a CUDA event pair, over 20,
median of 5), ``graph_ms`` (the same 20 calls in one CUDA graph, replayed:
device time alone) and ``max_rel``, the largest gradient's max |got -
want| / max|want| against ``ref.flash_attention_bwd_plain`` fed the same
L (probes are not the function).

``split``: the same kernel under other schedules (the wrapper copies
whatever ``bwd_work`` gives to the card): the stream-K split
(``bwd_work``) at its blocks (``rule``: one an SM, the dq kernel two at
D 128, 5 a step and 3 a segment), at other costs a segment
(``cost_5_0`` .. ``cost_5_12``), with the dq kernel at one an SM
(``dq_132``), with twice the rule's blocks in each kernel (``double``:
half the span a block, more units shared), and the first design's split
(``parts_1``, ``parts_2``: each unit cut into parts of at most T steps,
one a block, T the steps over one or two blocks an SM); each with its
grids, segments and shared units.

Parts that compare builds compile copies of the source with one change
each (text substitutions, checked to apply) and bind each in turn in
place of the wrapper's library.  ``variants``: the score loop unrolled
twice (``score_unroll_2``) or fully (``score_unroll_full``; the kernel:
fully at DP <= 128, twice at 256).  ``phases``: each kernel alone
(``dq_only``, ``dkdv_only``: the other and the fold not launched, so the
dk/dv kernel reads a stale D), and each with one part of its tile step
not run: the S and dP products (``*_no_s``, ``*_no_dp``), the
accumulating products (``dq_no_acc``, ``dkdv_no_acc``) and the ring's
next tile (``*_no_loads``: a slot keeps its first tile).  The fold's
time is ``profile``'s.

``profile``: at the cases with neither window nor softcap, the kernels'
and SDPA's f32 backward (``torch.autograd.grad`` through
``F.scaled_dot_product_attention``) by ``torch.profiler``: device us a
call by kernel name, and the host's us to enqueue a call.

``parent`` (needs ``--parent``, another checkout's root, say a ``git
archive`` of the parent commit): the f32 cases' ``stream_ms``,
``graph_ms`` and ``ms`` (one call between CUDA events, median of 20) and
the reduced f32 gemma2 train step of ``chip_smoke.py``'s phase train (b)
(``TRAIN_REDUCED``, 8 steps on the card: the median of steps 2-8 of
``TrainResult.step_times_s``) of the parent and of this tree in turns,
parent, change, change, parent, each in a process of its own with that
tree's ``src`` on the path.
"""
from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import flash_attention_bwd_design as mma_design  # noqa: E402

chip_smoke = mma_design.chip_smoke
graph_ms, PTXAS = mma_design.graph_ms, mma_design.PTXAS

CASES = {f"{c['arch']}_w{c['window']}_cap{c['softcap']}": dict(c, B=1)
         for c in chip_smoke.FLASH_BWD_CASES}
S = chip_smoke.FLASH_BWD_S

_DQ_LAUNCH = "  fa_bwd_dq<T, DP><<<"
_DKDV_LAUNCH = "  fa_bwd_dkdv<T, DP><<<"
_FOLD_LAUNCH = "  fa_bwd_fold<T><<<"


def _unlaunched(*launches):
    """Substitutions that leave these kernel launches out."""
    return [(x, "  if (a.B < 0)\n" + x, 1) for x in launches]


_DQ_ONLY = _unlaunched(_DKDV_LAUNCH, _FOLD_LAUNCH)
_DKDV_ONLY = _unlaunched(_DQ_LAUNCH, _FOLD_LAUNCH)
_NEVER = "if (a.B < 0) "
_UNROLL = "#pragma unroll (DP <= 128 ? DP / 32 : 2)\n"


def _skip(call: str):
    """A substitution that leaves the statement ``call`` unrun."""
    return (call, _NEVER + call, 1)


# part -> variant -> [(old, new, count)]
VARIANTS = {
    "variants": {
        "kernel": [],
        "score_unroll_2": [(_UNROLL, "#pragma unroll 2\n", 1)],
        "score_unroll_full": [(_UNROLL, "#pragma unroll\n", 1)]},
    "phases": {
        "dq_only": _DQ_ONLY,
        "dq_no_s": _DQ_ONLY + [_skip(
            "score_tile<T, DP>(sQ, Kt, warp, cg, ds, sacc);")],
        "dq_no_dp": _DQ_ONLY + [_skip(
            "score_tile<T, DP>(sdO, Vt, warp, cg, ds, sacc);")],
        "dq_no_acc": _DQ_ONLY + [_skip(
            "accum_tile<T, DP>(sdS, Kt, warp, cc, ks, acc);")],
        "dq_no_loads": _DQ_ONLY + [_skip("if (t + 1 < je) issue(")],
        "dkdv_only": _DKDV_ONLY,
        "dkdv_no_s": _DKDV_ONLY + [_skip(
            "score_tile<T, DP>(sK, Qt, warp, cg, ds, sacc);")],
        "dkdv_no_dp": _DKDV_ONLY + [_skip(
            "score_tile<T, DP>(sV, dOt, warp, cg, ds, sacc);")],
        "dkdv_no_acc": _DKDV_ONLY + [
            _skip("accum_tile<T, DP>(sP, dOt, warp, cc, ks, dv);"),
            _skip("accum_tile<T, DP>(sdS, Qt, warp, cc, ks, dk);")],
        "dkdv_no_loads": _DKDV_ONLY + [_skip("if (u + 1 < ue) issue(")]},
}


def _source(subs, name="") -> str:
    src = (_build.CSRC / f"{fa.BWD}.cu").read_text()
    for old, new, count in subs:
        if src.count(old) != count:
            raise RuntimeError(f"{name}: anchor not found {count}x: {old!r}")
        src = src.replace(old, new)
    return src


def _bind(lib):
    import ctypes
    fn = lib.flash_attention_bwd_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 12 + [I] * 14 + [F, I, I, F, P]
    fn.restype = I
    return fn


def _inputs(dev):
    """Each case's q, k, v, out, d_out, the forward's L and keywords, and
    the plain version's gradients fed that L."""
    g = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for case, c in CASES.items():
        q, k, v, out, dout, kw = chip_smoke.flash_bwd_inputs(
            torch, g, dev, c, torch.float32, S=S)
        lse, _ = chip_smoke.flash_bwd_lse(torch, q, k, v, out, kw)
        # a parent tree's CUDA-core forward may give no L (its backward
        # recomputes it)
        want = (ref.flash_attention_bwd_plain(q, k, v, out, dout, **kw)
                if lse is None else ref.flash_attention_bwd_plain(
                    q, k, v, out, dout, lse, **kw))
        data[case] = ((q, k, v, out, dout, lse), kw, want)
    return data


def _measure(res, name, data, event_ms=False):
    for case, (args, kw, want) in data.items():
        r = res[name].setdefault(case, {"stream_ms": [], "graph_ms": []})
        got = fa.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        r["max_rel"] = max(chip_smoke.flash_bwd_ratios(got, want))

        def call():
            return fa.flash_attention_bwd(*args, **kw)
        r["stream_ms"].append(chip_smoke.stream_ms(torch, call))
        r["graph_ms"].append(graph_ms(call))
        if event_ms:
            r.setdefault("ms", []).append(chip_smoke.gpu_ms(torch, call, 20))


def compare(part: str, data) -> dict:
    sources = {name: _source(subs, name)
               for name, subs in VARIANTS[part].items()}
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {name: pool.submit(
            lambda n, src: _bind(mma_design._compile_lib(
                f"fa_bwd_f32_{part}_{n}", src)), name, src)
            for name, src in sources.items()}
        builds = {name: f.result() for name, f in futures.items()}
    res = {name: {} for name in builds}
    order = list(builds)
    for name in (order + order[::-1]) * 2:
        fa._fns[fa.BWD] = builds[name]
        _measure(res, name, data)
    fa._fns.pop(fa.BWD)
    return res


def _stream_k(step=None, segment=None, dq_blocks=None, scale=1):
    """A schedule of the kernel's stream-K spans at these costs a step and
    a segment (the package's ``BWD_STEP_COST``, ``BWD_SEGMENT_COST`` where
    None), the dq kernel at ``dq_blocks`` blocks (the rule's where None),
    every grid times ``scale``."""
    def starts(units, nb):
        old = fa.BWD_STEP_COST, fa.BWD_SEGMENT_COST
        fa.BWD_STEP_COST = old[0] if step is None else step
        fa.BWD_SEGMENT_COST = old[1] if segment is None else segment
        try:
            return fa.stream_k(units, nb * scale)
        finally:
            fa.BWD_STEP_COST, fa.BWD_SEGMENT_COST = old
    return starts, dq_blocks


def _parts(aim):
    """The first design's split: each unit cut into near-equal parts of
    at most T steps, one a block, T the kernel's steps over ``aim`` blocks
    an SM (rounded up)."""
    def starts(units, nb):
        n = units.n.tolist()
        T = max(1, -(-sum(n) // (aim * fa.SMS)))
        out, u0 = [], 0
        for x in n:
            ns = -(-x // T)
            out += [u0 + s * x // ns for s in range(ns)]
            u0 += x
        return torch.tensor(out + [u0], dtype=torch.int64)
    return starts, None


# name -> (starts(units, the rule's blocks), the dq kernel's blocks)
SPLITS = {"rule": _stream_k(),
          "cost_5_0": _stream_k(5, 0), "cost_5_1": _stream_k(5, 1),
          "cost_5_6": _stream_k(5, 6), "cost_5_12": _stream_k(5, 12),
          "dq_132": _stream_k(dq_blocks=132),
          "double": _stream_k(scale=2),
          "parts_1": _parts(1), "parts_2": _parts(2)}


def _split_work(name):
    """``fa.bwd_work`` under split ``name``, cached like it (the wrapper
    copies a schedule to the card once an object)."""
    starts, dq_blocks = SPLITS[name]

    @functools.lru_cache(maxsize=None)
    def work(B, Sq, Skv, H, KH, D, *, causal=True, window=None):
        uq, uk = fa.bwd_units(B, Sq, Skv, H, KH, causal=causal,
                              window=window)
        nbq = dq_blocks or fa.SMS * (2 if D <= 128 else 1)
        return fa.bwd_schedule(Sq, Skv, (uq, uk), (
            fa.bwd_table(uq, starts(uq, nbq)),
            fa.bwd_table(uk, starts(uk, fa.SMS))))
    return work


def split(data) -> dict:
    rule = fa.bwd_work
    works = {name: _split_work(name) for name in SPLITS}
    res = {name: {} for name in SPLITS}
    order = list(SPLITS)
    for name in (order + order[::-1]) * 2:
        fa.bwd_work = works[name]
        _measure(res, name, data)
        for case, (args, kw, _) in data.items():
            q, k = args[0], args[1]
            w = fa.bwd_work(1, S, S, q.shape[2], k.shape[2], q.shape[3],
                            causal=kw["causal"], window=kw["window"])
            res[name][case].update(
                blocks=w.blocks(),
                segments=[len(w.dq.segs), len(w.dkdv.segs)],
                shared=[len(w.dq.folds), len(w.dkdv.folds)])
    fa.bwd_work = rule
    return res


def profile_part(data) -> dict:
    """The kernels' and SDPA's f32 backward: device us a call by kernel
    and host us a call, where SDPA computes the same function."""
    out = {}
    for case, (args, kw, _) in data.items():
        if kw["window"] is not None or kw["softcap"] is not None:
            continue
        out[case] = {
            "kernel": mma_design._profile_one(
                lambda: fa.flash_attention_bwd(*args, **kw)),
            "sdpa": mma_design._profile_one(mma_design._sdpa_bwd(args, kw))}
    return out


def train_step_ms() -> dict:
    """Phase train (b)'s reduced f32 gemma2 on the card
    (``chip_smoke.TRAIN_REDUCED``): each step's wall (ms) and the median
    of steps 2 to the last."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.zoo import build_model
    from repro_torch.train.loop import train
    cfg = reduced(get_config("gemma2-2b"), compute_dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init(0, dtype=torch.float32)
    res = train(model, params=params, **dict(chip_smoke.TRAIN_REDUCED,
                                             seed=0))
    steps = [1e3 * t for t in res.step_times_s]
    return {"step_ms": steps, "median_step_ms": statistics.median(steps[1:])}


def tree_one() -> dict:
    """This process's tree (``src`` on the path): the f32 cases and the
    reduced train step, one round."""
    data = _inputs(torch.device("cuda"))
    res = {"tree": {}}
    _measure(res, "tree", data, event_ms=True)
    return {"cases": res["tree"], "train_b": train_step_ms()}


TREE_ORDER = ("parent", "change", "change", "parent")


def parent_part(parent: Path) -> dict:
    """The f32 cases and the reduced train step of ``parent`` (another
    checkout's root) and of this tree in turns (``TREE_ORDER``), each in a
    process of its own with that tree's ``src`` on the path."""
    res = {"parent": [], "change": []}
    for side in TREE_ORDER:
        root = parent.resolve() if side == "parent" else ROOT
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run([sys.executable, __file__, "--tree-one"],
                              capture_output=True, text=True, env=env)
        if proc.returncode:
            raise RuntimeError(f"{side} ({root}): exit {proc.returncode}\n"
                               f"{proc.stderr[-3000:]}")
        res[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return res


PARTS = ("split",) + tuple(VARIANTS) + ("profile",)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated, of {PARTS} and parent")
    ap.add_argument("--parent", type=Path,
                    help="another checkout's root, for the parent part")
    ap.add_argument("--tree-one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_attention_bwd_f32_design needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.tree_one:
        print(json.dumps(tree_one()))
        return 0
    parts = args.parts.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    data = (_inputs(torch.device("cuda")) if set(parts) - {"parent"}
            else {})
    for part in parts:
        if part == "split":
            out[part] = split(data)
        elif part == "profile":
            out[part] = profile_part(data)
        elif part == "parent":
            if args.parent is None:
                raise SystemExit("the parent part needs --parent")
            out[part] = parent_part(args.parent)
        else:
            out[part] = compare(part, data)
    out["ptxas"] = PTXAS
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
