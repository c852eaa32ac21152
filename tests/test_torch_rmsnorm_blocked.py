"""The rmsnorm backward kernel's order of sums, emulated on the CPU
(``rmsnorm_bwd_blocked``), against ``jax.grad`` of the JAX package's
oracle ``rmsnorm_ref``; and the route choice (``rmsnorm_route``), which
fixes that order, branch by branch.  Inputs are numpy draws from a seed.

The emulation plays the part ``interpret=True`` plays for a Pallas kernel:
the card's tests hold the kernel against it at 1e-6.  Tolerances here are
``tests/test_torch_norm_attention.py``'s for gradients: rtol 1e-4, atol
1e-5 in float32 (dscale sums up to 1024 terms of magnitude ~10 in another
order than XLA's, so an entry near zero is off by a few 1e-6), 2e-2 in
bfloat16 (the JAX sweep's, ``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm_ref
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_blocked, rmsnorm_plain,
                                         rmsnorm_route)
from repro_torch.kernels.rmsnorm.rmsnorm import (BWD_WARPS, MAX_SPLITS,
                                                 VEC_MAX_D)

torch.set_num_threads(1)
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
H100_SMS = 132


def _draws(G, R, d, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(G, R, d)) * 3).astype(np.float32),
            rng.normal(size=(G, d)).astype(np.float32),
            rng.normal(size=(G, R, d)).astype(np.float32))


def _jax_grads(x, s, dy, dtype):
    """jax.grad of sum(rmsnorm_ref(x[g], s[g]) * dy[g]), group by group."""
    jdt = jnp.dtype(dtype)

    def loss(a, b, w):
        return jnp.sum(rmsnorm_ref(a, b).astype(jnp.float32)
                       * w.astype(jnp.float32))
    grad = jax.vmap(jax.grad(loss, argnums=(0, 1)))
    gx, gs = grad(jnp.asarray(x).astype(jdt), jnp.asarray(s).astype(jdt),
                  jnp.asarray(dy).astype(jdt))
    return (np.asarray(gx.astype(jnp.float32)),
            np.asarray(gs.astype(jnp.float32)))


# (G, R, d, dtype, route, splits; None: rmsnorm_route's on an H100): one
# client's block norms, the exit norms, more splits than rows, one row,
# R not a multiple of splits x warps x rows a warp, d off the vector
# width, d over the vec route's limit, and the bucketed shape in bf16
CASES = [
    (1, 1024, 128, "float32", "vec", None),
    (1, 1024, 128, "float32", "general", 32),
    (16, 32, 128, "float32", "vec", None),
    (2, 3, 64, "float32", "vec", 8),
    (4, 1, 128, "float32", "vec", 1),
    (4, 1, 128, "float32", "general", 4),
    (2, 37, 96, "float32", "vec", 5),
    (3, 37, 100, "float32", "general", 3),
    (2, 9, 99, "float32", "general", None),
    (1, 5, 2048, "float32", "general", None),
    (16, 1024, 128, "bfloat16", "vec", None),
    (4, 33, 100, "bfloat16", "general", None),
]


@pytest.mark.parametrize("G,R,d,dtype,route,splits", CASES)
def test_blocked_backward_matches_jax_grad_of_ref(G, R, d, dtype, route,
                                                  splits):
    x, s, dy = _draws(G, R, d, seed=G * 1000 + R + d)
    if splits is None:
        got_route, splits = rmsnorm_route(G, R, d, getattr(torch, dtype),
                                          [0], H100_SMS)
        assert got_route == route
    tdt = getattr(torch, dtype)
    tx, ts, tdy = (torch.tensor(a).to(tdt) for a in (x, s, dy))
    rstd = torch.rsqrt(torch.mean(tx.float() ** 2, dim=-1) + 1e-5)
    dx, dscale = rmsnorm_bwd_blocked(tx, ts, tdy, rstd, route, splits)
    assert dx.dtype == tdt and dscale.dtype == tdt
    assert dx.shape == (G, R, d) and dscale.shape == (G, d)
    gx, gs = _jax_grads(x, s, dy, dtype)
    np.testing.assert_allclose(dx.float().numpy(), gx, **TOL[dtype])
    np.testing.assert_allclose(dscale.float().numpy(), gs, **TOL[dtype])


@pytest.mark.parametrize("route", ["vec", "general"])
@pytest.mark.parametrize("splits,warps", [(1, 1), (3, 8), (32, 8), (7, 2)])
def test_blocked_backward_matches_autograd_of_plain(route, splits, warps):
    """Any split and warp count: the same gradients as autograd through
    the plain version, to float32 rounding."""
    x, s, dy = (torch.tensor(a) for a in _draws(2, 50, 64, seed=splits))
    rstd = torch.rsqrt(torch.mean(x ** 2, dim=-1) + 1e-5)
    dx, dscale = rmsnorm_bwd_blocked(x, s, dy, rstd, route, splits, warps)
    xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
    gx, gs = torch.autograd.grad(rmsnorm_plain(xr, sr), [xr, sr], dy)
    torch.testing.assert_close(dx, gx, **TOL["float32"])
    torch.testing.assert_close(dscale, gs, **TOL["float32"])


def test_blocked_backward_sums_in_split_order():
    """The order is the kernel's, not another's: the emulation's dscale is
    the split-ordered sum of its per-split sums, bit for bit."""
    x, s, dy = (torch.tensor(a) for a in _draws(1, 64, 32, seed=3))
    rstd = torch.rsqrt(torch.mean(x ** 2, dim=-1) + 1e-5)
    _, whole = rmsnorm_bwd_blocked(x, s, dy, rstd, "vec", 4, warps=2)
    total = None
    for k in range(4):
        rows = slice(16 * k, 16 * k + 16)
        _, part = rmsnorm_bwd_blocked(x[:, rows], s, dy[:, rows],
                                      rstd[:, rows], "vec", 1, warps=2)
        total = part if total is None else total + part
    assert torch.equal(whole, total)


def test_blocked_backward_of_no_rows():
    x = torch.zeros((3, 0, 8))
    dx, dscale = rmsnorm_bwd_blocked(x, torch.ones((3, 8)), x,
                                     torch.zeros((3, 0)), "vec", 1)
    assert dx.shape == (3, 0, 8) and torch.equal(dscale, torch.zeros(3, 8))


@pytest.mark.parametrize("d,dtype,ptrs,route", [
    (128, torch.float32, [0, 512, 4096], "vec"),
    (128, torch.bfloat16, [0, 512], "vec"),
    (100, torch.float32, [0], "vec"),
    (99, torch.float32, [0], "general"),
    (100, torch.bfloat16, [0], "general"),
    (8, torch.bfloat16, [0], "vec"),
    (VEC_MAX_D, torch.float32, [0], "vec"),
    (VEC_MAX_D + 4, torch.float32, [0], "general"),
    (2048, torch.bfloat16, [0], "general"),
    (128, torch.float32, [0, 4], "general"),
    (128, torch.bfloat16, [8, 0], "general"),
    (128, torch.float32, [16, 32, 48], "vec"),
], ids=["f32", "bf16", "d100-f32", "d99-f32", "d100-bf16", "d8-bf16",
        "d-at-cap", "d-over-cap", "d2048-bf16", "x-off-grid",
        "bf16-off-grid", "all-on-grid"])
def test_route_by_width_and_alignment(d, dtype, ptrs, route):
    assert rmsnorm_route(4, 16, d, dtype, ptrs, H100_SMS)[0] == route


@pytest.mark.parametrize("G,R,sms,splits", [
    (1, 1024, 132, 32),     # one client: capped at MAX_SPLITS
    (16, 1024, 132, 32),    # the bucketed block norms
    (16, 32, 132, 1),       # the exit norms: four rows a warp at least
    (16, 64, 132, 2),
    (1, 7, 132, 1),
    (1, 1, 132, 1),
    (1000, 1024, 132, 1),   # enough groups to fill the card alone
    (64, 1024, 132, 9),     # 4 x 132 / 64 -> 9
    (1, 1024, 4, 16),       # a small card
    (1, 100, 132, 4),       # ceil(100 / 32) = 4 -> 25 rows a split -> 4
    (1, 97, 132, 4),        # ceil(97 / 32) = 4 -> 25 rows a split -> 4
    (1, 76, 132, 3),        # ceil(76 / 32) = 3 -> 26 rows a split -> 3
    (1, 0, 132, 1),         # no rows
    (0, 5, 132, 1),         # no groups
])
def test_route_splits(G, R, sms, splits):
    assert rmsnorm_route(G, R, 128, torch.float32, [0], sms)[1] == splits


@pytest.mark.parametrize("G", [1, 2, 5, 16, 64, 300])
def test_route_splits_cover_rows_without_empty_splits(G):
    for R in list(range(1, 70)) + [127, 128, 129, 1000, 1024, 4097]:
        for sms in (1, 8, 132):
            S = rmsnorm_route(G, R, 64, torch.float32, [0], sms)[1]
            rps = -(-R // S)
            assert 1 <= S <= min(MAX_SPLITS, R)
            assert S * rps >= R and (S - 1) * rps < R
            # no more splits than four rows a warp would fill
            assert S <= -(-R // (4 * BWD_WARPS))
