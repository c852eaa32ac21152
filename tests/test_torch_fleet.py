"""The port's FleetState kernels (Eq. 3-7) against the JAX fleet (float32,
64-bit mode off) on the same seeded fleet, with batteries drawn so that
some devices cannot afford some submodels and some die when charged.

Tolerance: rtol=1e-5, atol=1e-6 on times and energies (single float32
element-wise ops).  Masks, survivals and deaths must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro_torch.core import fleet as tfleet

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = (609064, 2736424, 11234600, 45204776)
FRACS = (0.2809416240637261, 0.5206277493758174, 0.7603138746879087, 1.0)


@pytest.fixture(scope="module")
def fleets():
    n, seed = 24, 3
    rng = np.random.default_rng(seed)
    data = rng.integers(8, 400, n).tolist()
    jf = jfleet.make_fleet_state(n, seed, data_sizes=data, backend="jax")
    tf = tfleet.make_fleet_state(n, seed, data_sizes=data, device="cpu")
    # drain batteries to straddle each device's submodel costs
    _, _, e_tra, e_com = jfleet.fleet_cost_matrix(jf, SIZES, FRACS, 5, 32)
    need = np.asarray(e_tra + e_com)
    rem = (need[np.arange(n), rng.integers(0, 4, n)]
           * rng.uniform(0.9, 1.1, n)).astype(np.float32)
    alive = rng.random(n) > 0.1
    jf = jf.replace(remaining=jnp.asarray(rem), alive=jnp.asarray(alive))
    tf = tf.replace(remaining=torch.tensor(rem), alive=torch.tensor(alive))
    return jf, tf, rng


def test_fleet_fields_match(fleets):
    jf, tf, _ = fleets
    for name in ("compute", "p_train", "p_com", "bandwidth", "battery",
                 "data_size", "mode_compute", "mode_power"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)))


def test_cost_matrix_matches(fleets):
    jf, tf, _ = fleets
    ref = jfleet.fleet_cost_matrix_jit(jf, SIZES, FRACS, 5, 32)
    got = tfleet.fleet_cost_matrix(tf, SIZES, FRACS, 5, 32)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_affordability_is_equal(fleets):
    jf, tf, _ = fleets
    ref = np.asarray(jfleet.fleet_affordability_jit(jf, SIZES, FRACS, 5, 32))
    got = tfleet.fleet_affordability(tf, SIZES, FRACS, 5, 32).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref[:, :-1].sum() < ref[:, :-1].size   # both outcomes occur


def test_charge_matches(fleets):
    jf, tf, rng = fleets
    _, _, e_tra, e_com = jfleet.fleet_cost_matrix_jit(jf, SIZES, FRACS, 5, 32)
    m = rng.integers(0, 4, len(tf))
    need = np.asarray(e_tra + e_com)[np.arange(len(tf)), m]
    active = rng.random(len(tf)) > 0.3
    jnew, jok = jfleet.fleet_charge_jit(jf, jnp.asarray(need),
                                        jnp.asarray(active))
    tnew, tok = tfleet.fleet_charge(tf, torch.tensor(need),
                                    torch.tensor(active))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tnew.alive.numpy(), np.asarray(jnew.alive))
    np.testing.assert_allclose(tnew.remaining.numpy(),
                               np.asarray(jnew.remaining), **TOL)
    dead = np.asarray(jf.alive) & active & ~np.asarray(jok)
    assert dead.any() and np.asarray(jok).any()
    np.testing.assert_allclose(tfleet.fleet_total_remaining(tnew),
                               jfleet.fleet_total_remaining(jnew), **TOL)


def _same_fleet(tf, jf):
    """Energy, liveness and the virtual clocks equal (exact: selections and
    float32 copies, no arithmetic but one product with energy_scale)."""
    for name in ("remaining", "alive", "busy_until"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)),
                                      err_msg=name)


# (name, JAX call, port call): each churn update of the async engine and
# hot-plug (fleet.py:336-406) on the same fleet, one after another
CHURN_STEPS = [
    ("disconnect", lambda f, m: m.fleet_disconnect(f, 18)),
    ("set_busy", lambda f, m: m.fleet_set_busy(
        f, [0, 5, 7], np.array([12.5, 3.25, 1e5 + 0.1]))),
    ("set_busy scalar", lambda f, m: m.fleet_set_busy(f, [9], 7.75)),
    ("kill", lambda f, m: m.fleet_kill(f, [1, 5])),
    ("set_alive False", lambda f, m: m.fleet_set_alive(f, [2, 3], False)),
    ("set_alive True", lambda f, m: m.fleet_set_alive(f, [3, 20], True)),
    ("connect", lambda f, m: m.fleet_connect(f, 18, 0.6, now=41.5)),
]


def test_churn_updates_match(fleets):
    jf, tf, _ = fleets
    assert tf.busy_until.dtype == torch.float32
    _same_fleet(tf, jf)
    for name, step in CHURN_STEPS:
        jf2, tf2 = step(jf, jfleet), step(tf, tfleet)
        _same_fleet(tf2, jf2)
        # functional: the input states are unchanged
        _same_fleet(tf, jf)
        jf, tf = jf2, tf2
        for now in (0.0, 3.25, 12.5, 50.0):
            np.testing.assert_array_equal(tfleet.fleet_idle(tf, now),
                                          jfleet.fleet_idle(jf, now),
                                          err_msg=f"{name} idle at {now}")
    assert not tf.alive[18:].logical_not().any()
    np.testing.assert_array_equal(tf.busy_until[18:].numpy(), 41.5)
