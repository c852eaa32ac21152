"""The port's model-layout ``flash_attention`` on strided views, on the
CPU: its plain route against the heads-first plain version, the JAX
package's ``ops.flash_attention`` (the Pallas kernel in interpret mode)
and its oracle ``attention_ref``, forward and gradients; the heads-first
wrapper on strided views, which it hands on as model-layout views; and
the layout checks.

Views are what the model hands the kernels without a copy: a transpose
of a heads-first tensor, a slice of a wider tensor (row stride larger
than D) and a slice that starts one element in (its data pointer off the
16-byte grid, which the card takes through the kernels' element-wise
path).  Inputs are numpy draws from a seed.

Tolerances: forward 2e-5 (the JAX sweep's float32 tolerance,
``tests/test_kernels.py``); gradients rtol 1e-4, atol 1e-5 (float32
reductions in another order, then a backward through the softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention,
                                                 flash_attention_bhsd)

torch.set_num_threads(1)
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)

# (B, Sq, Sk, Hq, Hkv, D, causal, window, Pallas block): the transformer
# path's layer (4 heads of 32, S 32, causal) at a small batch, a GQA layer
# with a window, and a non-causal rectangle (Sq != Sk)
CASES = [(2, 32, 32, 4, 4, 32, True, 0, 16),
         (2, 16, 16, 4, 2, 16, True, 4, 8),
         (2, 8, 24, 2, 1, 8, False, 0, 8)]
CASE_IDS = ["path-layer", "gqa-window", "rect"]
VIEWS = ["transpose", "wide-slice", "offset-slice"]


def _view(a: np.ndarray, how: str) -> torch.Tensor:
    """The model-layout array a [B, S, H, D] as a non-contiguous torch
    view holding the same values."""
    B, S, H, D = a.shape
    if how == "transpose":          # heads-first storage, viewed [B, S, H, D]
        t = torch.tensor(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
        return t.transpose(1, 2)
    wide = torch.zeros((B, S, H, 2 * D + 1))
    lo = 0 if how == "wide-slice" else 1
    wide[..., lo:lo + D] = torch.tensor(a)
    return wide[..., lo:lo + D]


def _qkv(B, Sq, Sk, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
             (B, Sq, Hq, D))]


def _heads_first(a):
    B, S, H, D = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, D))


@pytest.mark.parametrize("how", VIEWS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_model_layout_views_match_bhsd_pallas_and_ref(case, how):
    B, Sq, Sk, Hq, Hkv, D, causal, window, blk = case
    q, k, v, _ = _qkv(B, Sq, Sk, Hq, Hkv, D, seed=Sq * Sk + D)
    views = [_view(a, how) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = flash_attention(*views, causal=causal, window=window)
    assert got.shape == (B, Sq, Hq, D)
    got = got.numpy()
    bhsd = flash_attention_bhsd(*(torch.tensor(_heads_first(a))
                                  for a in (q, k, v)),
                                causal=causal, window=window)
    bhsd = bhsd.numpy().reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(got, bhsd)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, block_q=blk,
                       block_k=min(blk, Sk), interpret=True)
    ref = attention_ref(*(jnp.asarray(_heads_first(a)) for a in (q, k, v)),
                        causal=causal, window=window)
    ref = np.asarray(ref).reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)
    for r in (np.asarray(pallas), ref):
        np.testing.assert_allclose(got, r, **FWD)


@pytest.mark.parametrize("how", VIEWS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_model_layout_view_grads_match_jax_grad_of_ref(case, how):
    B, Sq, Sk, Hq, Hkv, D, causal, window, _ = case
    q, k, v, w = _qkv(B, Sq, Sk, Hq, Hkv, D, seed=Sq + Sk + D)
    views = [_view(a, how).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*views, causal=causal, window=window)
    (out * torch.tensor(w)).sum().backward()
    wb = jnp.asarray(_heads_first(w))
    jg = jax.grad(lambda a, b, c: jnp.sum(
        attention_ref(a, b, c, causal=causal, window=window) * wb),
        argnums=(0, 1, 2))(*(jnp.asarray(_heads_first(a))
                             for a in (q, k, v)))
    for t, r, H in zip(views, jg, (Hq, Hkv, Hkv)):
        S = t.shape[1]
        r = np.asarray(r).reshape(B, H, S, D).transpose(0, 2, 1, 3)
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), r, **GRAD)


def test_model_layout_cpu_route_counts_no_launch():
    reset_launches()
    q, k, v, _ = _qkv(1, 8, 8, 2, 2, 8, seed=3)
    views = [_view(a, "transpose").requires_grad_() for a in (q, k, v)]
    flash_attention(*views).sum().backward()
    assert all(n == 0 for n in LAUNCHES.values()), LAUNCHES


def _bhsd_view(a: np.ndarray, how: str) -> torch.Tensor:
    """The heads-first array a [BH, S, D] as a non-contiguous torch view
    with D contiguous: position-major storage, or a slice of a wider
    tensor."""
    if how == "transpose":
        return torch.tensor(np.ascontiguousarray(a.transpose(1, 0, 2))
                            ).transpose(0, 1)
    BH, S, D = a.shape
    wide = torch.zeros((BH, S, 2 * D + 1))
    lo = 0 if how == "wide-slice" else 1
    wide[..., lo:lo + D] = torch.tensor(a)
    return wide[..., lo:lo + D]


@pytest.mark.parametrize("how", VIEWS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_bhsd_views_match_contiguous_and_jax_grad_of_ref(case, how):
    """flash_attention_bhsd takes strided heads-first tensors (D
    contiguous) as they are: output and gradients equal those of the same
    data made contiguous, to the bit, and jax.grad of the oracle."""
    B, Sq, Sk, Hq, Hkv, D, causal, window, _ = case
    q, k, v, w = (_heads_first(a) for a in
                  _qkv(B, Sq, Sk, Hq, Hkv, D, seed=3 * Sq + Sk + D))
    views = [_bhsd_view(a, how).requires_grad_() for a in (q, k, v)]
    dense = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    assert not views[0].is_contiguous()
    outs = [flash_attention_bhsd(*ts, causal=causal, window=window)
            for ts in (views, dense)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for out in outs:
        (out * torch.tensor(w)).sum().backward()
    jg = jax.grad(lambda a, b, c: jnp.sum(
        attention_ref(a, b, c, causal=causal, window=window) *
        jnp.asarray(w)), argnums=(0, 1, 2))(q, k, v)
    for t, d, r in zip(views, dense, jg):
        torch.testing.assert_close(t.grad, d.grad, rtol=0, atol=0)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **GRAD)


def _d_strided(shape):
    """A [B, S, H, D] view whose D axis is not contiguous."""
    B, S, H, D = shape
    return torch.zeros((B, S, D, H)).transpose(2, 3)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_model_layout_check_refuses_strided_d(which):
    ts = [torch.zeros((2, 8, 4, 16)) for _ in range(3)]
    ts[which] = _d_strided((2, 8, 4, 16))
    assert ts[which].stride(-1) != 1
    with pytest.raises(ValueError, match="contiguous in D"):
        flash_attention(*ts)


@pytest.mark.parametrize("call", [
    lambda: flash_attention(torch.zeros(2, 8, 3, 16), torch.zeros(2, 8, 2, 16),
                            torch.zeros(2, 8, 2, 16)),
    lambda: flash_attention(torch.zeros(2, 8, 4, 16), torch.zeros(3, 8, 2, 16),
                            torch.zeros(3, 8, 2, 16)),
    lambda: flash_attention(torch.zeros(8, 4, 16), torch.zeros(8, 4, 16),
                            torch.zeros(8, 4, 16)),
    lambda: flash_attention(torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 4, 16),
                            torch.zeros(2, 8, 4, 16), window=-1),
], ids=["heads-not-a-multiple", "batch-mismatch", "rank-3", "window"])
def test_model_layout_check_refuses_bad_shapes(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_model_layout_plain_route_equals_plain_version_on_views():
    """The CPU route is attention_plain on the views made heads-first, to
    the bit."""
    q, k, v, _ = _qkv(2, 12, 12, 4, 2, 16, seed=7)
    views = [_view(a, "wide-slice") for a in (q, k, v)]
    got = flash_attention(*views, causal=True, window=5)
    ref = attention_plain(*(torch.tensor(_heads_first(a)) for a in (q, k, v)),
                          causal=True, window=5)
    torch.testing.assert_close(
        got, ref.reshape(2, 4, 12, 16).transpose(1, 2), rtol=0, atol=0)
