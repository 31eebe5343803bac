"""The port's layer functions against ``repro.models.layers`` on the CPU,
in f32, from the same numpy inputs.  Tolerance: atol 1e-5 (f32, other
summation order); the paged write is checked bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention as jattn
from repro.models.layers import basic as jbasic
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import basic as tbasic

RNG = np.random.default_rng(7)


def _np(shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def test_rmsnorm_with_nonzero_scale():
    x, scale = _np((2, 5, 32)), _np((32,), 0.5)
    got = tbasic.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x), 1e-6)
    want = jbasic.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_activations_match_jax(act):
    """gelu is the tanh approximation on both sides (jax.nn.gelu's
    default)."""
    x = _np((64,), 3.0)
    got = tbasic.act_fn(act)(torch.from_numpy(x))
    want = jbasic.act_fn(act)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_rope_at_negative_positions():
    """Left-padded chunk rows sit at negative positions: same tables and
    rotation."""
    pos = np.asarray([[-3, -2, -1, 0, 1], [100, 101, 102, 103, 104]],
                     np.int32)
    x = _np((2, 5, 3, 16))
    s_t, c_t = tbasic.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    s_j, c_j = jbasic.rope_tables(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    got = tbasic.apply_rope(torch.from_numpy(x), s_t, c_t)
    want = jbasic.apply_rope(jnp.asarray(x), s_j, c_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_embed_unembed_softcap_and_padded_vocab(cap):
    """vocab 100 pads to 128 rows; padded columns come out at -1e9 and the
    argmax picks the same (first maximal) index."""
    vocab, d = 100, 32
    table = _np((128, d), 0.5)
    toks = RNG.integers(0, vocab, size=(2, 4)).astype(np.int32)
    p_t = {"table": torch.from_numpy(table)}
    p_j = {"table": jnp.asarray(table)}
    e_t = tbasic.embed_tokens(p_t, torch.from_numpy(toks).long(),
                              torch.float32, scale_by_dim=True)
    e_j = jbasic.embed_tokens(p_j, jnp.asarray(toks), jnp.float32,
                              scale_by_dim=True)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-5)
    got = tbasic.unembed(p_t, e_t, torch.float32, cap, vocab=vocab)
    want = jbasic.unembed(p_j, e_j, jnp.float32, cap, vocab=vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert np.all(got.numpy()[..., vocab:] == -1e9)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(want, -1)))


def test_gated_mlp_matches_jax():
    x = _np((2, 3, 32))
    p = {"w_gate": _np((32, 64), 0.2), "w_up": _np((32, 64), 0.2),
         "w_down": _np((64, 32), 0.2)}
    got = tbasic.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), "gelu")
    want = jbasic.mlp({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("Sq,write_pos", [
    (4, [-3, 5, -1]),      # left-padded chunk, mid-context, inactive row
    (1, [0, 9, -1]),       # decode: row 2 inactive
    (4, [2, 13, 6]),       # row 1 crosses into an unbacked (-1) block
])
def test_paged_write_and_gather_match_jax(Sq, write_pos):
    """The in-place write drops what JAX's ``mode="drop"`` scatter drops
    (negative positions, -1 blocks): the pool bytes come out identical,
    and the gathered view and its kpos mask match."""
    nb, bs, KH, hd = 8, 4, 2, 16
    pool_k, pool_v = _np((nb, bs, KH, hd)), _np((nb, bs, KH, hd))
    k_new, v_new = _np((3, Sq, KH, hd)), _np((3, Sq, KH, hd))
    bt = np.asarray([[3, 0, -1, -1, -1],
                     [5, 1, 6, -1, -1],
                     [2, 7, 4, -1, -1]], np.int32)
    wp = np.asarray(write_pos, np.int32)
    cache_j = {"k": jnp.asarray(pool_k, jnp.bfloat16),
               "v": jnp.asarray(pool_v, jnp.bfloat16)}
    new_j, k_j, v_j, kpos_j = jattn._paged_update_gather(
        cache_j, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(bt),
        jnp.asarray(wp))

    trash = np.zeros((1, bs, KH, hd), np.float32)
    tk = torch.from_numpy(np.concatenate([pool_k, trash])).to(torch.bfloat16)
    tv = torch.from_numpy(np.concatenate([pool_v, trash])).to(torch.bfloat16)
    tbt, twp = torch.from_numpy(bt), torch.from_numpy(wp)
    tattn.paged_write(tk, tv, torch.from_numpy(k_new),
                      torch.from_numpy(v_new), tbt, twp)
    for got, want in ((tk, new_j["k"]), (tv, new_j["v"])):
        np.testing.assert_array_equal(
            got[:nb].view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))
    k_t, kpos_t = tattn.paged_gather(tk[:nb], tbt, twp, Sq)
    v_t, _ = tattn.paged_gather(tv[:nb], tbt, twp, Sq)
    np.testing.assert_array_equal(kpos_t.numpy(), np.asarray(kpos_j))
    np.testing.assert_array_equal(k_t.float().numpy(),
                                  np.asarray(k_j, np.float32))
    np.testing.assert_array_equal(v_t.float().numpy(),
                                  np.asarray(v_j, np.float32))


@pytest.mark.parametrize("window", [None, 3])
def test_attend_masks_match_jax(window):
    """The chunked-prefill attention: causal, window, softcap and kpos = -1
    slots, GQA 4 over 2 heads."""
    B, Sq, Skv, H, KH, D = 2, 3, 10, 4, 2, 16
    q, k, v = _np((B, Sq, H, D)), _np((B, Skv, KH, D)), _np((B, Skv, KH, D))
    qpos = np.asarray([[5, 6, 7], [-2, -1, 0]], np.int32)
    kpos = np.where(np.arange(Skv)[None] <= qpos[:, -1:],
                    np.arange(Skv)[None], -1).astype(np.int32)
    got = tattn.attend(*(torch.from_numpy(a) for a in (q, k, v, qpos, kpos)),
                       scale=D ** -0.5, window=window, cap=50.0)
    want = jattn.attend(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)),
                        scale=D ** -0.5, window=window, cap=50.0,
                        is_global=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
