"""Dense training in the port against the JAX package, on the CPU.

* ``Model.loss``'s gradient for gemma2-2b, gemma3-1b, internlm2-20b and
  yi-34b, reduced, f32, through ``FlashAttentionFn`` (its backward the
  plain ``flash_attention_bwd_plain`` here), against ``jax.grad`` of the
  reference's loss (``use_pallas=False``): every leaf within 1e-4 of the
  leaf's max|g| (the same f32 function in another summation order;
  measured at most 2e-6).
* The optimizers: ``tests/test_optim.py``'s own checks (descent,
  clipping, the warmup-cosine shape, Adafactor's factored slots), and
  ``make_adamw``/``make_adafactor`` against the reference's on the same
  grads for 3 steps, every state leaf within 1e-6 of its max.
* ``make_train_step`` on reduced gemma2-2b in f32, accum 2, 5 steps of
  the same ``SyntheticLM`` batches from the same params, against
  ``jax.jit(make_train_step(...))``: losses and grad norms within 1e-4
  relative at every step; params within the summed learning rate of the
  steps (Adam's first steps move each weight by about the learning rate,
  sign-like on near-zero gradients, so a last-bit gradient difference may
  move a weight by up to that much).  The control, the accumulated grads
  left undivided by ``accum``, fails the grad-norm gate (AdamW with
  clipping is nearly blind to the gradient's scale, so the losses alone
  would not show it).  With ``cast_params_once`` in bf16, 3 steps
  against the reference's in bf16 (losses 1e-3, grad norms 1e-2).
* The loop (``tests/test_engine_and_loop.py``'s checks): the loss falls;
  a restart from a checkpoint at step 5 gives the uninterrupted run's
  losses, and the saved params and optimizer state are bit-equal to those
  of the same steps taken one by one; ``cost_model=`` prices every step;
  ``autotuner=`` fills ``tuned_configs`` and restores the previous handle
  (``tests/test_autotune.py``'s check).
* Refusals (``mesh=`` in ``train``), remat, ``Prefetcher`` and the
  launcher.  rwkv6 and hymba train in ``tests/test_torch_recurrent_train.py``.

The reference's models are built once (``_models``) and its steps
compiled once, in a module-scoped fixture.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS, reduced as jreduced
from repro.models.zoo import build_model as jbuild
from repro.train import optim as jopt
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.synthetic import DataConfig, Prefetcher, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tlm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.train import optim as topt
from repro_torch.train.loop import train
from repro_torch.train.step import accum_steps_for, make_train_step
from repro_torch.train.tree import leaves, tree_map, unflatten
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)

DENSE = ("gemma2-2b", "gemma3-1b", "internlm2-20b", "yi-34b")
GRAD_TOL = 1e-4        # of each leaf's max|g|
STEP_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _models(arch):
    """The reduced f32 reference model, seed-0 params as a numpy tree in
    the reference's layout (read only: the port's copies come from
    ``_port_params``), the port's config and model; built once per arch.
    The params are the port's own init, its layers stacked as the
    reference scans them (the reference's init would cost seconds of
    tracing a test)."""
    jcfg = jreduced(JARCHS[arch], compute_dtype="float32")
    cfg = reduced(ARCHS[arch], compute_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(0, dtype=torch.float32)
    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k != "layers"}
    tree["layers"] = tree_map(lambda *ts: torch.stack(ts).numpy(),
                              *params["layers"])
    tree["pre_layers"] = []
    return jbuild(jcfg), tree, cfg, model


def _port_params(tree, cfg):
    return params_from_jax(tree, cfg, "cpu", dtype=torch.float32)


def _port_leaf(tree, keys, n_layers):
    """The port's leaf (or its per-layer leaves stacked, for the
    reference's scanned ``layers``) at the reference's path ``keys``."""
    if keys[0] == "layers":
        nodes = tree["layers"]
        for k in keys[1:]:
            nodes = [n[k] for n in nodes]
        return torch.stack(nodes).numpy()
    for k in keys:
        tree = tree[k]
    return tree.numpy()


def _keys(path):
    return [getattr(p, "key", getattr(p, "idx", None)) for p in path]


def _batch(vocab, seq=16, rows=2, step=0):
    return SyntheticLM(DataConfig(vocab, seq, rows)).batch(step)


# -- the model's gradients ---------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_loss_grads_match_jax(arch):
    jm, tree, cfg, model = _models(arch)
    b = _batch(cfg.vocab_size)
    want = jax.jit(jax.grad(lambda p, bb: jm.loss(p, bb)[0]))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in b.items()})
    params = _port_params(tree, cfg)
    xs = [t.requires_grad_() for t in leaves(params)]
    loss, _ = model.loss(params, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    got = unflatten(params, torch.autograd.grad(loss, xs))
    n = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        keys = _keys(path)
        if keys[0] == "pre_layers":
            continue
        w = np.asarray(w)
        g = _port_leaf(got, keys, cfg.n_layers)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err < GRAD_TOL, (keys, err)
        n += cfg.n_layers if keys[0] == "layers" else 1
    assert n == len(xs)


def test_remat_changes_no_gradient_and_save_attn_raises():
    """``remat`` (``torch.utils.checkpoint`` a layer) gives the gradient
    without it, bit for bit; the reference's ``save_attn`` policy is not
    ported and raises."""
    _, tree, cfg, _ = _models("gemma2-2b")
    toks = torch.from_numpy(_batch(cfg.vocab_size)["tokens"])
    grads = []
    for remat in (True, False):
        params = _port_params(tree, cfg)
        xs = [t.requires_grad_() for t in leaves(params)]
        logits, _ = tlm.lm_apply(params, cfg, tokens=toks, mode="train",
                                 remat=remat)
        grads.append(torch.autograd.grad(logits.square().mean(), xs))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="save_attn"):
        params = _port_params(tree, cfg)
        params["ln_f"]["scale"].requires_grad_()
        tlm.lm_apply(params, cfg.replace(remat_policy="save_attn"),
                     tokens=toks, mode="train")


# -- the optimizers ----------------------------------------------------------

def _quadratic_losses(opt, steps):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((256, 3)) + 5.0}
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        w = params["w"].clone().requires_grad_()
        loss = torch.mean(torch.square(w - target))
        (g,) = torch.autograd.grad(loss, [w])
        upd, state, _ = opt.update({"w": g}, state, params)
        params = {"w": params["w"] + upd["w"]}
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends(name):
    opt = (topt.make_adamw(lambda s: 0.3, weight_decay=0.0)
           if name == "adamw" else topt.make_adafactor(lambda s: 0.3))
    losses = _quadratic_losses(opt, 120)
    assert losses[-1] < 0.05 * losses[0]


def test_clip_by_global_norm():
    g = {"a": torch.ones(10) * 100.0}
    clipped, gn = topt.clip_by_global_norm(g, 1.0)
    assert float(gn) > 100
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0,
                               rtol=1e-5)


def test_warmup_cosine_shape():
    s = topt.warmup_cosine(1e-3, warmup=10, total=100)
    assert float(s(torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(s(torch.tensor(10))), 1e-3, rtol=1e-5)
    assert float(s(torch.tensor(50))) < 1e-3
    assert float(s(torch.tensor(100))) >= 1e-4 * 0.99  # floor
    j = jopt.warmup_cosine(1e-3, warmup=10, total=100)
    for step in (0, 3, 10, 47, 100, 140):
        assert float(s(torch.tensor(step))) == float(j(jnp.asarray(step)))


def test_adafactor_factored_shapes():
    opt = topt.make_optimizer("adafactor")
    st = opt.init({"big": torch.zeros((256, 512)), "small": torch.zeros(8)})
    assert st["slots"]["big"]["vr"].shape == (256,)
    assert st["slots"]["big"]["vc"].shape == (512,)
    assert st["slots"]["small"]["v"].shape == (8,)
    assert st["count"].dtype == torch.int32


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_state_matches_reference(name):
    """3 updates on the same grads: every state leaf and the params within
    1e-6 of the leaf's max, the metrics within 1e-6 relative."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(256, 200)),
              "b": [rng.normal(size=(8,)), rng.normal(size=(130, 3, 140))]}
    params = jax.tree.map(lambda x: x.astype(np.float32), params)
    jo = jopt.make_optimizer(name, lr_peak=1e-2)
    to = topt.make_optimizer(name, lr_peak=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(3):
        g = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3)
                         .astype(np.float32), params)
        ju, js, jm = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts, tm = to.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = tree_map(lambda p, u: p + u, tp, tu)
        want, got = jax.tree.leaves((js, jp)), leaves((ts, tp))
        assert len(want) == len(got)
        for a, b in zip(want, got):
            a, b = np.asarray(a, np.float64), b.numpy().astype(np.float64)
            assert np.abs(a - b).max() <= 1e-6 * max(np.abs(a).max(), 1.0)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)


# -- the train step ----------------------------------------------------------

STEP_ARCH, STEP_ROWS, STEP_SEQ, STEP_ACCUM, N_STEPS = (
    "gemma2-2b", 4, 16, 2, 5)
STEP_LR = 1e-2


def _step_batches(vocab):
    data = SyntheticLM(DataConfig(vocab, STEP_SEQ, STEP_ROWS))
    return [data.batch(i) for i in range(N_STEPS)]


@pytest.fixture(scope="module")
def ref_steps():
    """The reference's jitted step run for ``N_STEPS``: its losses, grad
    norms, learning rates and final params (numpy), and the shared
    inputs."""
    jm, tree, cfg, _ = _models(STEP_ARCH)
    jo = jopt.make_optimizer("adamw", lr_peak=STEP_LR)
    step = jax.jit(jmake_train_step(jm, jo, STEP_ACCUM))
    p = jax.tree.map(jnp.asarray, tree)
    s = jo.init(p)
    out = {"loss": [], "grad_norm": [], "lr": []}
    for b in _step_batches(cfg.vocab_size):
        p, s, m = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        for k in out:
            out[k].append(float(m[k]))
    return tree, cfg, out, jax.device_get(p)


def _port_steps(tree, cfg, optimizer):
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, optimizer, STEP_ACCUM)
    params = _port_params(tree, cfg)
    state = optimizer.init(params)
    out = {"loss": [], "grad_norm": [], "lr": []}
    for b in _step_batches(cfg.vocab_size):
        params, state, m = step(params, state, b)
        for k in out:
            out[k].append(float(m[k]))
    return out, params


def _step_gate(got, want):
    """The failed gates of a port run against the reference's."""
    failed = []
    for key in ("loss", "grad_norm"):
        rel = np.abs(np.subtract(got[key], want[key])) / np.abs(want[key])
        if rel.max() > STEP_RTOL:
            failed.append(f"{key} {rel.max()}")
    return failed


def test_train_step_matches_jax(ref_steps):
    tree, cfg, want, want_params = ref_steps
    got, params = _port_steps(tree, cfg,
                              topt.make_optimizer("adamw", lr_peak=STEP_LR))
    assert _step_gate(got, want) == []
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    tol = sum(want["lr"])
    n = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want_params):
        keys = _keys(path)
        if keys[0] == "pre_layers":
            continue
        diff = np.abs(_port_leaf(params, keys, cfg.n_layers) - w).max()
        assert diff <= tol, (keys, diff, tol)
        n += cfg.n_layers if keys[0] == "layers" else 1
    assert n == len(leaves(params))


def test_train_step_control_undivided_grads_fails(ref_steps):
    """The accumulated grads handed on without the division by ``accum``
    (the optimizer sees ``accum`` times them): the gate catches it."""
    tree, cfg, want, _ = ref_steps
    opt = topt.make_optimizer("adamw", lr_peak=STEP_LR)
    undivided = topt.Optimizer(opt.init, lambda g, s, p: opt.update(
        tree_map(lambda x: x * STEP_ACCUM, g), s, p))
    got, _ = _port_steps(tree, cfg, undivided)
    assert any(f.startswith("grad_norm") for f in _step_gate(got, want))


def test_train_step_cast_params_once_matches_jax_bf16():
    """``cast_params_once`` in bf16 (f32 params cast once a step, the
    gradient taken at the bf16 copies), 3 steps of accum 2 against the
    reference's: losses within 1e-3 relative and grad norms within 1e-2
    (bf16 rounds at other points in the two frameworks; measured 3e-5
    and 1.2e-3)."""
    jcfg = jreduced(JARCHS[STEP_ARCH], cast_params_once=True)
    cfg = reduced(ARCHS[STEP_ARCH], cast_params_once=True)
    jm = jbuild(jcfg)
    tree = _models(STEP_ARCH)[1]
    jo = jopt.make_optimizer("adamw", lr_peak=STEP_LR)
    to = topt.make_optimizer("adamw", lr_peak=STEP_LR)
    jstep = jax.jit(jmake_train_step(jm, jo, STEP_ACCUM))
    tstep = make_train_step(build_model(cfg, device="cpu"), to, STEP_ACCUM)
    jp = jax.tree.map(jnp.asarray, tree)
    js, tp = jo.init(jp), _port_params(tree, cfg)
    ts = to.init(tp)
    for b in _step_batches(cfg.vocab_size)[:3]:
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tmet = tstep(tp, ts, b)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-3)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-2)
    assert all(t.dtype == torch.float32 for t in leaves(tp))


def test_accum_steps_for_matches_reference():
    from repro.train.step import accum_steps_for as jaccum
    for arch in DENSE:
        for gb in (1, 4, 8, 12, 256):
            for shards in (1, 2):
                assert accum_steps_for(ARCHS[arch], gb, shards) == jaccum(
                    JARCHS[arch], gb, shards)


# -- the loop ----------------------------------------------------------------

def _tiny(arch="gemma2-2b", vocab=97, **kw):
    return build_model(reduced(ARCHS[arch], n_layers=2, vocab_size=vocab,
                               **kw), device="cpu")


def test_train_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="sharding"):
        train(_tiny(), mesh=object(), num_steps=1)


def test_train_loss_decreases():
    res = train(_tiny(), num_steps=30, global_batch=8, seq_len=32, lr=5e-3)
    assert res.steps_run == 30 and len(res.step_times_s) == 30
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.2, (first, last)


def test_train_restart_reproduces_losses_and_state(tmp_path):
    model = _tiny("internlm2-20b")
    kw = dict(global_batch=4, seq_len=16, lr=1e-3, seed=11)
    full = train(model, num_steps=10, **kw)
    d = tmp_path / "ck"
    params = model.init(11, dtype=torch.float32)
    first = train(model, num_steps=5, ckpt_dir=str(d), ckpt_every=5,
                  params=params, **kw)
    assert first.restored_from is None
    rest = train(model, num_steps=10, ckpt_dir=str(d), ckpt_every=5, **kw)
    assert rest.restored_from == 5 and rest.steps_run == 5
    assert first.losses + rest.losses == full.losses
    # the checkpoint at step 5 holds the first run's params (updated in
    # place) and the state of the same 5 steps taken one by one
    from repro_torch.checkpoint.manager import CheckpointManager
    opt = topt.make_optimizer(model.cfg.optimizer, lr_peak=kw["lr"])
    step = make_train_step(model, opt, accum_steps_for(model.cfg, 4, 1))
    p = model.init(11, dtype=torch.float32)
    s = opt.init(p)
    data = SyntheticLM(DataConfig(model.cfg.vocab_size, 16, 4, seed=11))
    for i in range(5):
        p, s, _ = step(p, s, data.batch(i))
    saved = CheckpointManager(d).restore(5, like={"p": p, "o": s})
    for a, b in zip(leaves(saved), leaves({"p": params, "o": s})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(leaves(saved["p"]), leaves(p)):
        assert torch.equal(a, b)


def test_train_prices_every_step():
    from repro_torch.core.costmodel import CostModel
    seen = []
    res = train(_tiny(vocab=64), num_steps=3, global_batch=4, seq_len=16,
                cost_model=CostModel.from_named("hopper_h100"),
                hooks=[lambda step, m: seen.append(m)])
    assert res.predicted_step_s is not None and res.predicted_step_s > 0
    assert len(seen) == 3
    for m in seen:
        assert m["predicted_step_s"] == res.predicted_step_s
        assert m["measured_step_s"] > 0
        assert {"loss", "grad_norm", "lr"} <= set(m)


def test_train_consumes_tuned_configs_and_restores_handle():
    from repro_torch.core import autotune
    from repro_torch.core.autotune import Autotuner

    model = _tiny("internlm2-20b", vocab=64)
    cfg = model.cfg
    tuner = Autotuner(dtype="bf16")
    # the train step sees per-microbatch rows: global_batch 4 / accum 2
    tuned = tuner.tune("flash_attention",
                       {"batch": 2, "seq_q": 16, "seq_kv": 16,
                        "heads": cfg.padded_heads,
                        "kv_heads": cfg.n_kv_heads,
                        "head_dim": cfg.head_dim})
    res = train(model, num_steps=2, global_batch=4, seq_len=16,
                autotuner=tuner)
    assert res.steps_run == 2
    assert res.tuned_configs == {"flash_attention": tuned.best}
    assert tuner.stats.hits > 0, "the train loop never hit the tuned cache"
    assert autotune.active() is None
    res = train(model, num_steps=1, global_batch=4, seq_len=16)
    assert res.tuned_configs is None


# -- data and launcher ------------------------------------------------------

def test_prefetcher_runs_one_ahead():
    seen = []

    def tf(x):
        seen.append(x)
        return x * 10
    it = Prefetcher(iter(range(5)), transform=tf)
    assert seen == [0]
    assert [next(it) for _ in range(3)] == [0, 10, 20]
    assert seen == [0, 1, 2, 3]


def test_launcher_trains_reduced_on_the_cpu_and_refuses_dry_run(capsys):
    assert launch_train.main(["--arch", "gemma2-2b", "--reduced",
                              "--device", "cpu", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "step 1 loss" in out and "done: 2 steps" in out
    for flag in ("--dry-run", "--multi-pod"):
        assert launch_train.main(["--arch", "gemma2-2b", flag]) == 2
        assert "ROADMAP" in capsys.readouterr().err
