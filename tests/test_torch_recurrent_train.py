"""Recurrent training in the port (rwkv6, hymba) against the JAX package,
on the CPU, from the same numpy inputs.

* The plain backwards ``ref.wkv6_bwd_plain`` / ``ref.ssm_scan_bwd_plain``
  (the yardsticks of the backward kernels ``csrc/wkv6_bwd.cu`` and
  ``csrc/ssm_scan_bwd.cu``): against ``torch.autograd`` through the
  carried scans ``ref.wkv6_carry`` / ``ref.ssm_scan_carry`` in f64 on every
  case of ``chip_smoke.WKV_CASES`` / ``SSM_CASES`` (1e-10 of each
  gradient's max|g|: one function, two summation orders), and against
  ``jax.grad`` of the reference's ``_wkv_scan_ref`` / ``_ssm_scan_ref`` in
  f32 at S = 512, where the reference takes its sqrt-remat chunks (1e-4:
  f32 in another order).  The kernels' split of the sums into
  partials (``*_bwd_split_plain``) against the whole sums.
* ``Wkv6Fn`` / ``SsmScanFn`` on the CPU: their gradients are the plain
  backwards' bit for bit, in each input's dtype, with no launch counted;
  no autograd node without grad.
* The layers' parameter gradients (``rwkv_time_mix``, ``mamba_mixer``)
  and reduced f32 ``Model.loss`` gradients against ``jax.grad`` of the
  reference (``use_pallas=False``), every leaf within 1e-4 of its
  max|g|; remat changes no gradient.
* ``make_train_step`` on reduced f32 rwkv6 and hymba, accum 2, 3 steps
  of the same ``SyntheticLM`` batches from the same params, against
  ``jax.jit(make_train_step(...))`` (``tests/test_torch_train.py``'s
  gate: losses and grad norms within 1e-4 relative; params within the
  summed learning rate; AdamW's moments within 1e-3 of each leaf's max).
* ``chip_smoke.py``'s backward phases rehearsed: every control of
  ``WKV_BWD_MUST_CATCH`` / ``SSM_BWD_MUST_CATCH`` exceeds the f32 gate
  on its case by 10x while the sound f32 plain backward passes it; the
  bounds; remat's launch counts; the launcher trains reduced rwkv6.

The reference's grads and steps compile once a family (module-scoped
fixtures).
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.layers import mamba as jmamba
from repro.models.layers import rwkv as jrwkv
from repro.models.zoo import build_model as jbuild
from repro.train import optim as jopt
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.synthetic import DataConfig, SyntheticLM
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.kernels import wkv6 as twkv
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tlm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import mamba as tmamba
from repro_torch.models.layers import rwkv as trwkv
from repro_torch.models.zoo import build_model
from repro_torch.train import optim as topt
from repro_torch.train.step import make_train_step
from repro_torch.train.tree import leaves, unflatten
from test_torch_eval import _tree
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)
from test_torch_recurrent import _perturbed
from test_torch_train import _keys, _port_leaf, _step_gate

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCH_NAMES = ("rwkv6-1.6b", "hymba-1.5b")
F64_TOL = 1e-10        # of each gradient's max|g|
GRAD_TOL = 1e-4        # f32 against f32 in another order
MOMENT_TOL = 1e-3      # AdamW's m and v after 3 steps, of each leaf's max
STEP_ROWS, STEP_SEQ, STEP_ACCUM, N_STEPS, STEP_LR = 4, 16, 2, 3, 1e-2


def _ratio(got, want):
    """max |got - want| over max |want|, in f64."""
    got, want = (np.asarray(t.detach().double() if torch.is_tensor(t) else t,
                            np.float64) for t in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# --- the plain backwards ----------------------------------------------------

def _wkv_args(case, B=2, S=150, H=2, N=16, dtype=torch.float64, seed=0):
    g = _gen(seed)
    args = chip_smoke.wkv_inputs(torch, g, "cpu", B, S, H, N, torch.float32,
                                 case)
    dy = torch.randn(args[0].shape, generator=g)
    return [t.to(dtype) for t in args], dy.to(dtype)


def _ssm_args(case, Bt=2, S=150, Di=40, N=8, dtype=torch.float64, seed=0):
    g = _gen(seed)
    args = chip_smoke.ssm_inputs(torch, g, "cpu", Bt, S, Di, N,
                                 torch.float32, case)
    dy = torch.randn(args[0].shape, generator=g)
    return [t.to(dtype) for t in args], dy.to(dtype)


@pytest.mark.parametrize("case", sorted(chip_smoke.WKV_CASES))
def test_wkv6_bwd_plain_matches_autograd_f64(case):
    """Through two of the plain backward's 64-step chunks (S 150)."""
    args, dy = _wkv_args(case)
    xs = [t.clone().requires_grad_() for t in args]
    s0 = torch.zeros((2, 2, 16, 16), dtype=torch.float64)
    want = torch.autograd.grad(ref.wkv6_carry(*xs, s0)[0], xs, dy)
    got = ref.wkv6_bwd_plain(*args, dy)
    assert [g.dtype for g in got] == [torch.float64] * 5
    for g, w in zip(got, want):
        assert _ratio(g, w) < F64_TOL


@pytest.mark.parametrize("case", sorted(chip_smoke.SSM_CASES))
def test_ssm_scan_bwd_plain_matches_autograd_f64(case):
    args, dy = _ssm_args(case)
    xs = [t.clone().requires_grad_() for t in args]
    h0 = torch.zeros((2, 40, 8), dtype=torch.float64)
    want = torch.autograd.grad(ref.ssm_scan_carry(*xs, h0)[0], xs, dy)
    got = ref.ssm_scan_bwd_plain(*args, dy)
    assert [g.dtype for g in got] == [torch.float64] * 5
    for g, w in zip(got, want):
        assert _ratio(g, w) < F64_TOL


def _np(ts):
    return [t.numpy() for t in ts]


def test_wkv6_bwd_plain_matches_jax_grad():
    """f32 against ``jax.grad`` of ``_wkv_scan_ref`` at S 512, through its
    sqrt-remat chunks of 256, u in f32 as the reference's training scan."""
    S = 512
    args, dy = _wkv_args("short", B=1, S=S, H=2, N=16,
                         dtype=torch.float32, seed=S)
    r, k, v, w, u = _np(args)
    s0 = jnp.zeros((1, 2, 16, 16), jnp.float32)
    want = jax.grad(lambda *a: jnp.sum(jrwkv._wkv_scan_ref(*a, s0)[0]
                                       * dy.numpy()),
                    argnums=tuple(range(5)))(r, k, v, w, u)
    got = ref.wkv6_bwd_plain(*args, dy)
    for g, wg in zip(got, want):
        assert _ratio(g, wg) < GRAD_TOL


def test_ssm_scan_bwd_plain_matches_jax_grad():
    """f32 against ``jax.grad`` of ``_ssm_scan_ref`` at S 512 (its
    sqrt-remat chunks)."""
    S = 512
    args, dy = _ssm_args("eval", Bt=1, S=S, Di=16, N=8,
                         dtype=torch.float32, seed=S)
    h0 = jnp.zeros((1, 16, 8), jnp.float32)
    want = jax.grad(lambda *a: jnp.sum(jmamba._ssm_scan_ref(*a, h0)[0]
                                       * dy.numpy()),
                    argnums=tuple(range(5)))(*_np(args))
    got = ref.ssm_scan_bwd_plain(*args, dy)
    for g, wg in zip(got, want):
        assert _ratio(g, wg) < GRAD_TOL


@pytest.mark.parametrize("N,S,seg", [(16, 37, None), (64, 37, None),
                                     (16, 37, 8), (64, 37, 16),
                                     (64, 2 * twkv.BWD_SEG + 5, twkv.BWD_SEG)])
def test_wkv6_bwd_split_plain_adds_the_column_blocks(N, S, seg):
    """The kernel's split (a head's columns in groups of 4, one partial a
    group, the states rebuilt 8 steps at a time), with the sequence cut
    into segments of ``seg`` steps (the last one ragged) walked from their
    combined start states and end cotangents, gives the whole sums."""
    args, dy = _wkv_args("long", S=S, N=N)
    want = ref.wkv6_bwd_plain(*args, dy)
    parts = ref.wkv6_bwd_parts(*args, dy, cols=twkv.BWD_GROUP,
                               chunk=twkv.BWD_CHUNK, seg=seg)
    nseg = -(-S // (seg or S))
    assert len(parts["dr"]) == N // twkv.BWD_GROUP
    assert len(parts["du"]) == 2 and len(parts["du"][0]) == nseg
    assert len(parts["du"][0][0]) == len(parts["dr"])
    got = ref.wkv6_bwd_split_plain(*args, dy, cols=twkv.BWD_GROUP,
                                   chunk=twkv.BWD_CHUNK, seg=seg)
    for g, w in zip(got, want):
        assert _ratio(g, w) < F64_TOL


def test_wkv6_bwd_segments_hold_long_memory_and_underflow_f64():
    """S 4096 in f64 over the kernel's segments: half the state rows decay
    by w near 5e-6 (a segment's product of w underflows to 0), the others
    by w near 1 (the state carries across every segment).  The combine
    only multiplies, so the split equals the plain backward within 1e-10
    of each gradient's max|g|."""
    g = _gen(4096)
    B, S, H, N = 1, 4096, 1, 16
    r, k, v, dy = (torch.randn((B, S, H, N), generator=g,
                               dtype=torch.float64) * 0.3 for _ in range(4))
    lo = torch.rand((B, S, H, N), generator=g, dtype=torch.float64)
    w = torch.where(torch.arange(N) % 2 == 0, 5e-6 * (1 + lo),
                    1 - 1e-4 * lo)
    u = torch.randn((H, N), generator=g, dtype=torch.float64) * 0.3
    local = ref.wkv6_bwd_local(r, k, v, w, dy, seg=twkv.BWD_SEG)
    p = torch.stack([x[2] for x in local])
    assert len(local) == S // twkv.BWD_SEG
    assert (p[..., ::2] == 0).all() and (p[..., 1::2] > 0.99).all()
    want = ref.wkv6_bwd_plain(r, k, v, w, u, dy)
    got = ref.wkv6_bwd_split_plain(r, k, v, w, u, dy, cols=twkv.BWD_GROUP,
                                   chunk=twkv.BWD_CHUNK, seg=twkv.BWD_SEG)
    for x, y in zip(got, want):
        assert _ratio(x, y) < F64_TOL


def test_ssm_scan_bwd_split_plain_adds_the_groups_and_rows():
    """Channel groups of 16 (40 channels: the last group half full) and
    one dA partial a row give the whole sums."""
    args, dy = _ssm_args("eval", S=37)
    want = ref.ssm_scan_bwd_plain(*args, dy)
    parts = ref.ssm_scan_bwd_parts(*args, dy, group=tssm.BWD_GROUP,
                                   chunk=tssm.BWD_CHUNK)
    assert len(parts["dB"]) == 3 and len(parts["dA"]) == 2
    got = ref.ssm_scan_bwd_split_plain(*args, dy, group=tssm.BWD_GROUP,
                                       chunk=tssm.BWD_CHUNK)
    for g, w in zip(got, want):
        assert _ratio(g, w) < F64_TOL


# --- the autograd functions on the CPU --------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_fn_on_the_cpu_is_the_plain_backward(dtype):
    args, dy = _wkv_args("fast", S=20, dtype=torch.float32)
    args = [t.to(dtype) if i != 3 else t for i, t in enumerate(args)]
    dy = dy.to(dtype)
    xs = [t.clone().requires_grad_() for t in args]
    twkv.wkv6.launches = twkv.wkv6.bwd_launches = 0
    got = torch.autograd.grad(twkv.wkv6(*xs), xs, dy)
    want = ref.wkv6_bwd_plain(*args, dy)
    assert [g.dtype for g in got] == [t.dtype for t in args]
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))
    assert twkv.wkv6.launches == twkv.wkv6.bwd_launches == 0
    with torch.no_grad():
        assert twkv.wkv6(*xs).grad_fn is None
    assert twkv.wkv6(*args).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_fn_on_the_cpu_is_the_plain_backward(dtype):
    args, dy = _ssm_args("eval", S=20, dtype=torch.float32)
    args = [t.to(dtype) if i in (0, 2, 3) else t
            for i, t in enumerate(args)]
    dy = dy.to(dtype)
    xs = [t.clone().requires_grad_() for t in args]
    tssm.ssm_scan.launches = tssm.ssm_scan.bwd_launches = 0
    got = torch.autograd.grad(tssm.ssm_scan(*xs, block_d=8), xs, dy)
    want = ref.ssm_scan_bwd_plain(*args, dy)
    assert [g.dtype for g in got] == [t.dtype for t in args]
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))
    assert tssm.ssm_scan.launches == tssm.ssm_scan.bwd_launches == 0
    with torch.no_grad():
        assert tssm.ssm_scan(*xs, block_d=8).grad_fn is None
    assert tssm.ssm_scan(*args, block_d=8).grad_fn is None


def test_backward_wrappers_take_a_strided_cotangent_and_check_shapes():
    args, dy = _wkv_args("short", S=12, dtype=torch.float32)
    strided = dy.transpose(1, 2).contiguous().transpose(1, 2)
    for g, w in zip(twkv.wkv6_bwd(*args, strided),
                    twkv.wkv6_bwd(*args, dy)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="dy"):
        twkv.wkv6_bwd(*args, dy[:, 1:])
    args, dy = _ssm_args("eval", S=12, dtype=torch.float32)
    with pytest.raises(ValueError, match="dy"):
        tssm.ssm_scan_bwd(*args, dy[..., 1:])


# --- layers and models against jax.grad -------------------------------------

def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy()).requires_grad_()


def _flat_pairs(want, got, path=()):
    if isinstance(want, dict):
        for k in want:
            yield from _flat_pairs(want[k], got[k], path + (k,))
    else:
        yield path, want, got


def _layer_grads(jfn, tfn, tree, x, dyn):
    want = jax.jit(jax.grad(lambda p: jnp.sum(jfn(p, jnp.asarray(x))[0]
                                              * dyn)))(
        jax.tree.map(jnp.asarray, tree))
    tp = _torch_tree(tree)
    out = tfn(tp, torch.from_numpy(x))[0]
    flat = [t for _, _, t in _flat_pairs(tree, tp)]
    grads = torch.autograd.grad((out * torch.from_numpy(dyn)).sum(), flat)
    n = 0
    for (path, w, _), g in zip(_flat_pairs(want, tp), grads):
        assert _ratio(g, w) < GRAD_TOL, path
        n += 1
    assert n == len(flat)


def test_rwkv_time_mix_param_grads_match_jax():
    jcfg = jreduced(JARCHS["rwkv6-1.6b"], compute_dtype="float32")
    cfg = reduced(ARCHS["rwkv6-1.6b"], compute_dtype="float32")
    tree = _perturbed(jrwkv.init_rwkv_tmix(jax.random.PRNGKey(1), jcfg), 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    dyn = rng.normal(size=x.shape).astype(np.float32)
    _layer_grads(
        lambda p, xx: jrwkv.rwkv_time_mix(p, xx, jcfg, need_state=False),
        lambda p, xx: trwkv.rwkv_time_mix(p, xx, cfg), tree, x, dyn)


def test_mamba_mixer_param_grads_match_jax():
    jcfg = jreduced(JARCHS["hymba-1.5b"], compute_dtype="float32")
    cfg = reduced(ARCHS["hymba-1.5b"], compute_dtype="float32")
    tree = _perturbed(jmamba.init_mamba(jax.random.PRNGKey(5), jcfg), 5)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    dyn = rng.normal(size=x.shape).astype(np.float32)
    _layer_grads(
        lambda p, xx: jmamba.mamba_mixer(p, xx, jcfg, need_state=False),
        lambda p, xx: tmamba.mamba_mixer(p, xx, cfg), tree, x, dyn)


@functools.lru_cache(maxsize=None)
def _family(arch):
    """The reduced f32 reference model, ``init_lm``'s tree as numpy with
    its constant leaves perturbed, and the port's config and model."""
    jcfg = jreduced(JARCHS[arch], compute_dtype="float32")
    cfg = reduced(ARCHS[arch], compute_dtype="float32")
    return jbuild(jcfg), _tree(jcfg), cfg, build_model(cfg, device="cpu")


def _batch(vocab, seq=16, rows=2, step=0):
    return SyntheticLM(DataConfig(vocab, seq, rows)).batch(step)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_grads_match_jax(arch):
    jm, tree, cfg, model = _family(arch)
    b = _batch(cfg.vocab_size)
    want = jax.jit(jax.grad(lambda p, bb: jm.loss(p, bb)[0]))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in b.items()})
    params = params_from_jax(tree, cfg, "cpu", dtype=torch.float32)
    xs = [t.requires_grad_() for t in leaves(params)]
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    got = unflatten(params, torch.autograd.grad(loss, xs))
    n = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        keys = _keys(path)
        if keys[0] == "pre_layers":
            continue
        err = _ratio(_port_leaf(got, keys, cfg.n_layers), np.asarray(w))
        assert err < GRAD_TOL, (keys, err)
        n += cfg.n_layers if keys[0] == "layers" else 1
    assert n == len(xs)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_remat_changes_no_recurrent_gradient(arch, monkeypatch):
    """Each layer under ``torch.utils.checkpoint`` gives the gradient
    without it bit for bit, and runs the recurrence's forward twice."""
    _, tree, cfg, _ = _family(arch)
    toks = torch.from_numpy(_batch(cfg.vocab_size)["tokens"])
    mod, name = ((twkv, "wkv6_plain") if cfg.family == "ssm"
                 else (tssm, "ssm_scan_plain"))
    plain, calls = getattr(mod, name), []
    monkeypatch.setattr(mod, name, lambda *a, **kw: (
        calls.append(1), plain(*a, **kw))[1])
    grads, counts = [], []
    for remat in (True, False):
        calls.clear()
        params = params_from_jax(tree, cfg, "cpu", dtype=torch.float32)
        xs = [t.requires_grad_() for t in leaves(params)]
        logits, _ = tlm.lm_apply(params, cfg, tokens=toks, mode="train",
                                 remat=remat)
        grads.append(torch.autograd.grad(logits.square().mean(), xs))
        counts.append(len(calls))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert counts == [2 * cfg.n_layers, cfg.n_layers]


# --- the train step against the reference's ---------------------------------

@functools.lru_cache(maxsize=None)
def _ref_steps(arch):
    """The reference's jitted AdamW step, accum 2, for ``N_STEPS`` on
    ``SyntheticLM`` batches: its metrics, final params and state."""
    jm, tree, cfg, _ = _family(arch)
    jo = jopt.make_optimizer("adamw", lr_peak=STEP_LR)
    step = jax.jit(jmake_train_step(jm, jo, STEP_ACCUM))
    p = jax.tree.map(jnp.asarray, tree)
    s = jo.init(p)
    out = {"loss": [], "grad_norm": [], "lr": []}
    for b in _step_batches(cfg.vocab_size):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        for k in out:
            out[k].append(float(m[k]))
    return out, jax.device_get(p), jax.device_get(s)


def _step_batches(vocab):
    data = SyntheticLM(DataConfig(vocab, STEP_SEQ, STEP_ROWS))
    return [data.batch(i) for i in range(N_STEPS)]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_matches_jax(arch):
    want, want_params, want_state = _ref_steps(arch)
    _, tree, cfg, model = _family(arch)
    opt = topt.make_optimizer("adamw", lr_peak=STEP_LR)
    step = make_train_step(model, opt, STEP_ACCUM)
    params = params_from_jax(tree, cfg, "cpu", dtype=torch.float32)
    state = opt.init(params)
    got = {"loss": [], "grad_norm": [], "lr": []}
    for b in _step_batches(cfg.vocab_size):
        params, state, m = step(params, state, b)
        for k in got:
            got[k].append(float(m[k]))
    assert _step_gate(got, want) == []
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    tol = sum(want["lr"])
    for name, tree_got, tree_want, bound in (
            ("params", params, want_params, None),
            ("m", state["m"], want_state["m"], MOMENT_TOL),
            ("v", state["v"], want_state["v"], MOMENT_TOL)):
        for path, w in jax.tree_util.tree_leaves_with_path(tree_want):
            keys = _keys(path)
            if keys[0] == "pre_layers":
                continue
            g = _port_leaf(tree_got, keys, cfg.n_layers)
            w = np.asarray(w)
            diff = np.abs(g - w).max()
            limit = tol if bound is None else bound * max(np.abs(w).max(),
                                                          1e-30)
            assert diff <= limit, (name, keys, diff, limit)
    assert int(state["count"]) == int(want_state["count"]) == N_STEPS


# --- chip_smoke.py's backward phases, rehearsed -------------------------------

@pytest.mark.parametrize("name", sorted(chip_smoke.WKV_BWD_MUST_CATCH))
def test_wkv_bwd_must_catch_controls_exceed_the_gate(name):
    """On its case at N 64 (16 column groups a head) over three of the
    kernel's segments (S 160), f32 inputs: the sound f32 plain backward
    passes the f32 gate against the f64 one, the fault exceeds it by
    10x."""
    args, dy = _wkv_args(chip_smoke.WKV_BWD_MUST_CATCH[name], B=1, S=160,
                         H=2, N=64, dtype=torch.float32)
    a64 = [t.double() for t in args] + [dy.double()]
    want = ref.wkv6_bwd_plain(*a64)
    sound = chip_smoke.flash_bwd_ratios(twkv.wkv6_bwd(*args, dy), want)
    assert max(sound) <= chip_smoke.REC_BWD_TOL["float32"]
    row = chip_smoke.rec_bwd_controls(torch, want, {name: lambda: (
        chip_smoke.wkv_bwd_fault(torch, ref, name, *a64))})[name]
    assert row["caught"] and max(row["ratios"]) > 10 * 1e-4


@pytest.mark.parametrize("name", sorted(chip_smoke.SSM_BWD_MUST_CATCH))
def test_ssm_bwd_must_catch_controls_exceed_the_gate(name):
    """On its case over 3 channel groups (40 channels) and 6 chunks, f32
    inputs."""
    args, dy = _ssm_args(chip_smoke.SSM_BWD_MUST_CATCH[name], Bt=2, S=96,
                         Di=40, N=16, dtype=torch.float32)
    a64 = [t.double() for t in args] + [dy.double()]
    want = ref.ssm_scan_bwd_plain(*a64)
    sound = chip_smoke.flash_bwd_ratios(tssm.ssm_scan_bwd(*args, dy), want)
    assert max(sound) <= chip_smoke.REC_BWD_TOL["float32"]
    row = chip_smoke.rec_bwd_controls(torch, want, {name: lambda: (
        chip_smoke.ssm_bwd_fault(torch, ref, name, *a64))})[name]
    assert row["caught"] and max(row["ratios"]) > 10 * 1e-4


def test_written_out_faults_are_sound_without_their_fault():
    """The controls' written-out backwards, with no fault, are the plain
    backward's function."""
    args, dy = _wkv_args("short", S=30)
    want = ref.wkv6_bwd_plain(*args, dy)
    late = chip_smoke.wkv_bwd_g_late(torch, *args, dy)
    assert _ratio(late[0], want[0]) < F64_TOL          # dr: S alone
    # with w the same at every step, one step late is no fault
    args[3] = args[3][:, :1].expand_as(args[3]).contiguous()
    for g, x in zip(chip_smoke.wkv_bwd_g_late(torch, *args, dy),
                    ref.wkv6_bwd_plain(*args, dy)):
        assert _ratio(g, x) < F64_TOL
    sargs, sdy = _ssm_args("eval", S=40)
    want = ref.ssm_scan_bwd_plain(*sargs, sdy)
    for g, x in zip(chip_smoke.ssm_bwd_written_out(torch, *sargs, sdy, None),
                    want):
        assert _ratio(g, x) < F64_TOL


def test_bwd_bounds_count_the_gradients():
    """At the train shapes the operations bound both gradients: wkv6 14 N^2
    + 16 N f32 operations a (row, step, head), the scan 18 N + 4 a (row,
    step, channel), above its exponentials and bytes."""
    ms, by = chip_smoke.wkv_bwd_bound(2, 4096, 32, 64)
    assert by == "operations"
    assert ms == pytest.approx(2 * 4096 * 32 * (14 * 64 * 64 + 16 * 64)
                               / 67e12 * 1e3)
    ms, by = chip_smoke.ssm_bwd_bound(2, 4224, 1600, 16)
    assert by == "operations"
    assert ms == pytest.approx(2 * 4224 * 1600 * (18 * 16 + 4) / 67e12 * 1e3)
    exps, _ = chip_smoke._bound(0, 0, 1.0, exps=2 * 4224 * 1600 * 16)
    assert exps < ms


def test_train_launch_counts_for_the_recurrent_families():
    """Remat's launches a full-width step at accum 2: the forward twice a
    layer a micro-batch, the backward once."""
    for arch, fwd, bwd, n in (("rwkv6-1.6b", "wkv6", "wkv6_bwd", 24),
                              ("hymba-1.5b", "ssm_scan", "ssm_scan_bwd",
                               32)):
        want = chip_smoke.train_want_per_step(ARCHS[arch], 2, mma=False)
        assert want[fwd] == 2 * n * 2 and want[bwd] == n * 2
        assert sum(want.values()) == 3 * n * 2
    want = chip_smoke.train_want_per_step(ARCHS["gemma2-2b"], 2, mma=True)
    assert want["flash_attention_bwd_mma"] == 52 and want["wkv6"] == 0


def test_workspaces_hold_the_kernels_state_and_partials():
    """wkv6: a start state, an end cotangent, a decay product and a du
    partial a (row, head, 64-step segment); no state kept inside a
    segment."""
    assert twkv.bwd_workspace_floats(2, 4096, 32, 64) == (
        2 * 2 * 32 * 64 * 64 * 64 + 2 * 2 * 32 * 64 * 64)
    assert tssm.bwd_workspace_floats(2, 4224, 1600, 16) == (
        2 * 264 * 1600 * 16 + 2 * 100 * 2 * 4224 * 16 + 2 * 1600 * 16)


def test_launcher_trains_reduced_rwkv6_on_the_cpu(capsys):
    assert launch_train.main(["--arch", "rwkv6-1.6b", "--reduced",
                              "--device", "cpu", "--steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "step 0 loss" in out and "done: 1 steps" in out
