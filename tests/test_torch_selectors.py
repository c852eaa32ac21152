"""The baseline selectors (``greedy``, ``random``, ``static``) and the
fleet's tier labels against the JAX package's, on the paper's 40-device
fleet over several rounds: identical participants and model choices,
with and without a fleet-wide budget, with dead devices and with ties in
the remaining energy (the stable sort gives them to the lower index).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core import selection as jselection
from repro_torch.core import fleet as tfleet
from repro_torch.core import selection as tselection
from repro_torch.fl.engine import check_supported
from repro_torch.fl.simulation import FLConfig, _make_selector
from repro_torch.models.family import get_family

N = 40
SIZES, FRACTIONS = get_family("cnn").cost_model(10)


def _fleets(seed, remaining_frac, alive):
    data = list(np.random.default_rng(seed).integers(20, 300, N))
    jf = jfleet.make_fleet_state(N, seed, data_sizes=data, backend="jax")
    tf = tfleet.make_fleet_state(N, seed, data_sizes=data, device="cpu")
    rem = (np.asarray(jf.battery, np.float32)
           * np.asarray(remaining_frac, np.float32)).astype(np.float32)
    jf = jf.replace(remaining=jnp.asarray(rem), alive=jnp.asarray(alive))
    tf = tf.replace(remaining=torch.tensor(rem), alive=torch.tensor(alive))
    return jf, tf


def _round_states(seed, rounds):
    """Per round: a remaining fraction per device (a few tied, some so low
    that only small submodels are affordable) and liveness."""
    rng = np.random.default_rng(seed + 100)
    for t in range(rounds):
        frac = rng.choice([0.001, 0.002, 0.004, 0.006, 0.01, 0.02], N)
        frac = frac * rng.uniform(0.5, 1.0, N)
        frac[5:9] = frac[5]                      # a tie in remaining energy
        alive = rng.uniform(size=N) > 0.15
        yield t, frac, alive


def test_fleet_tiers_and_modes_match_jax():
    jf = jfleet.make_fleet_state(N, 3, backend="jax")
    tf = tfleet.make_fleet_state(N, 3, device="cpu")
    assert tf.tiers == jf.tiers and tf.modes == jf.modes
    assert len(tf.tiers) == N and set(tf.tiers) <= {"small", "medium",
                                                     "large"}
    # replace keeps the labels
    assert tf.replace(remaining=tf.remaining * 0.5).tiers == tf.tiers


@pytest.mark.parametrize("budget", [None, "tight"])
@pytest.mark.parametrize("name", ["greedy", "random", "static"])
def test_selector_picks_match_jax(name, budget):
    make_j = {"greedy": jselection.GreedySelector,
              "random": lambda: jselection.RandomSelector(7),
              "static": lambda: jselection.StaticTierSelector(7)}[name]
    make_t = {"greedy": tselection.GreedySelector,
              "random": lambda: tselection.RandomSelector(7),
              "static": lambda: tselection.StaticTierSelector(7)}[name]
    jsel, tsel = make_j(), make_t()
    models_seen = set()
    for t, frac, alive in _round_states(2, 6):
        jf, tf = _fleets(2, frac, alive)
        left = None
        if budget:
            _, _, e_tra, e_com = tfleet.fleet_cost_matrix(tf, SIZES,
                                                          FRACTIONS, 5, 32)
            left = float(torch.quantile((e_tra + e_com).flatten(), 0.4))
        kw = dict(local_epochs=5, batch_size=32, budget_left=left)
        js = jsel.select(jf, t, 4 + t, SIZES, FRACTIONS, **kw)
        ts = tsel.select(tf, t, 4 + t, SIZES, FRACTIONS, **kw)
        assert ts.participants == js.participants
        assert ts.model_choice == js.model_choice
        assert all(alive[i] for i in ts.participants)
        models_seen |= {ts.model_choice[i] for i in ts.participants}
    assert len(models_seen) > 1


def test_greedy_ties_go_to_the_lower_index():
    frac = np.full(N, 0.5)
    alive = np.ones(N, bool)
    jf, tf = _fleets(0, frac, alive)
    tf = tf.replace(remaining=torch.full((N,), 5000.0))
    js = jselection.GreedySelector().select(
        jf.replace(remaining=jnp.full((N,), 5000.0, jnp.float32)), 0, 6,
        SIZES, FRACTIONS)
    ts = tselection.GreedySelector().select(tf, 0, 6, SIZES, FRACTIONS)
    assert ts.participants == js.participants == [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("method,selector,expected", [
    ("drfl", "marl", tselection.MarlSelector),
    ("drfl", "greedy", tselection.GreedySelector),
    ("drfl", "random", tselection.RandomSelector),
    ("drfl", "static", tselection.StaticTierSelector),
    ("heterofl", "marl", tselection.GreedySelector),
    ("scalefl", "random", tselection.GreedySelector)])
def test_make_selector_for_every_arm(method, selector, expected):
    cfg = FLConfig(n_devices=8, method=method, selector=selector)
    check_supported(cfg)
    assert type(_make_selector(cfg, 4, device="cpu")) is expected


def test_unknown_selector_and_unsupported_method_raise():
    with pytest.raises(ValueError, match="unknown selector"):
        check_supported(FLConfig(n_devices=8, selector="oracle"))
    with pytest.raises(ValueError, match="does not support method"):
        check_supported(FLConfig(n_devices=8, method="heterofl",
                                 model_family="transformer"))
