"""The port's energy scenarios (``repro_torch.energy``) and their fleet and
selector hooks against the JAX package's ``repro.energy``, on the CPU:
the registries, ``scenario_from_config``, every profile's device-side
rate and masks (against the reference on numpy float64 and jnp float32
fleets) and host twins on a seeded grid of phases and sim times, the
profile draws of ``init_fleet``, ``apply_charge``, the budget mask of
``fleet_affordability`` and the MARL selector's picks under a budget
(ε = 0).  Floats allclose at 1e-5, masks and draws equal; the host
twins run in float64 numpy in both packages and agree exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import energy as jenergy
from repro.core import fleet as jfleet
from repro.core.selection import MarlSelector as JaxMarlSelector
from repro.energy import profiles as jprofiles
from repro.fl.simulation import FLConfig as JaxFLConfig
from repro_torch import energy as tenergy
from repro_torch.convert import params_from_jax
from repro_torch.core import fleet as tfleet
from repro_torch.core.selection import MarlSelector
from repro_torch.energy import profiles as tprofiles
from repro_torch.fl.simulation import FLConfig
from repro_torch.models.family import get_family

torch.set_num_threads(1)
N = 64
SIZES, FRACS = get_family("cnn").cost_model(10)
PERIOD = 100.0
#: float32 against the reference's float32 (jnp) and float64 (numpy)
#: fleets: the phase 2 pi (t / period + tz) of a few turns carries 2e-6 of
#: float32 rounding, which a rate near a zero of the sine keeps
F32 = dict(rtol=1e-5, atol=1e-5)


def _grid(seed=0):
    """Phases and amplitudes for N devices (float32, as the fleets hold
    them) and sim times over three days, midnights and peaks included."""
    rng = np.random.default_rng(seed)
    tz = rng.uniform(0.0, 1.0, N).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, N).astype(np.float32)
    times = np.concatenate([[0.0, 0.25 * PERIOD, 0.5 * PERIOD, PERIOD],
                            rng.uniform(0.0, 3 * PERIOD, 12)])
    return tz, amp, times


def _fleets(tz, amp, seed=5):
    """The same fleet as a reference numpy (float64), reference jnp
    (float32) and port (float32, CPU) fleet."""
    nf = jfleet.make_fleet_state(N, seed, backend="numpy")
    nf = nf.replace(tz_phase=tz.astype(np.float64),
                    charge_rate=amp.astype(np.float64))
    jf = jfleet.make_fleet_state(N, seed, backend="jax")
    jf = jf.replace(tz_phase=jnp.asarray(tz), charge_rate=jnp.asarray(amp))
    tf = tfleet.make_fleet_state(N, seed, device="cpu")
    tf = tf.replace(tz_phase=torch.tensor(tz), charge_rate=torch.tensor(amp))
    return {"numpy": nf, "jnp": jf}, tf


def test_registries_match_the_reference():
    assert tenergy.known_charge_profiles() \
        == jenergy.known_charge_profiles() \
        == ("carbon_window", "constant", "solar")
    assert tenergy.known_availability_profiles() \
        == jenergy.known_availability_profiles() == ("always", "diurnal")
    for name in tenergy.known_charge_profiles():
        got = tenergy.get_charge_profile(name, period=123.0)
        ref = jenergy.get_charge_profile(name, period=123.0)
        assert (got.name, got.period) == (ref.name, ref.period) == (
            name, 123.0)
    for name in tenergy.known_availability_profiles():
        got = tenergy.get_availability_profile(name, 50.0, duty=0.3)
        ref = jenergy.get_availability_profile(name, 50.0, duty=0.3)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for getter, bad in (("get_charge_profile", "fusion"),
                        ("get_availability_profile", "sometimes")):
        msgs = []
        for mod in (tenergy, jenergy):
            with pytest.raises(ValueError, match="unknown") as e:
                getattr(mod, getter)(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert tprofiles.CARBON_INTENSITY_CUTOFF \
        == jprofiles.CARBON_INTENSITY_CUTOFF
    assert tprofiles._PROFILE_RNG_TAG == jprofiles._PROFILE_RNG_TAG == 0xE67


@pytest.mark.parametrize("kw", [
    dict(),
    dict(charge_profile="solar", charge_rate=2.0, charge_period=3600.0),
    dict(charge_profile="constant", charge_rate=0.5),
    dict(charge_profile="carbon_window", charge_rate=2.0),
    dict(charge_profile="carbon_window"),
    dict(availability_profile="diurnal", availability_duty=0.3,
         charge_period=500.0),
    dict(global_budget_j=150.0, energy_scale=0.05),
    dict(availability_profile="always", availability_duty=0.4),
], ids=["default", "solar", "constant", "carbon", "carbon-rate-0",
        "diurnal", "budget", "always-duty"])
def test_scenario_from_config_matches(kw):
    got = tenergy.scenario_from_config(FLConfig(n_devices=4, **kw))
    ref = jenergy.scenario_from_config(JaxFLConfig(n_devices=4, **kw))
    for part in ("charge", "availability"):
        g, r = getattr(got, part), getattr(ref, part)
        assert type(g).__name__ == type(r).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(r)
    for f in ("charge_rate", "global_budget_j", "energy_scale",
              "trivial_charge", "trivial_availability", "budget_active",
              "is_trivial"):
        assert getattr(got, f) == getattr(ref, f), f


CHARGES = ["constant", "solar", "carbon_window"]


@pytest.mark.parametrize("backend", ["numpy", "jnp"])
@pytest.mark.parametrize("name", CHARGES)
def test_charge_profiles_match_on_a_grid(name, backend):
    tz, amp, times = _grid(1)
    ref_fleets, tf = _fleets(tz, amp)
    rf = ref_fleets[backend]
    got_p = tenergy.get_charge_profile(name, PERIOD)
    ref_p = jenergy.get_charge_profile(name, PERIOD)
    tz64 = tz.astype(np.float64)
    for t in times:
        rate = got_p.rate(tf, t)
        assert rate.dtype == torch.float32
        np.testing.assert_allclose(rate.numpy(), np.asarray(
            ref_p.rate(rf, t), np.float64), **F32)
        assert (rate >= 0).all()
        ok, ok_ref = got_p.participation_ok(tf, t), ref_p.participation_ok(
            rf, t)
        assert (ok is None) == (ok_ref is None)
        if ok is not None:
            np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
        host, host_ref = got_p.ok_host(tz64, t), ref_p.ok_host(tz64, t)
        assert (host is None) == (host_ref is None)
        if host is not None:
            np.testing.assert_array_equal(host, host_ref)
            np.testing.assert_array_equal(host, ok.numpy())
        np.testing.assert_array_equal(got_p.next_ok_host(tz64, t),
                                      ref_p.next_ok_host(tz64, t))


@pytest.mark.parametrize("backend", ["numpy", "jnp"])
@pytest.mark.parametrize("duty", [1.0, 0.5, 0.15])
@pytest.mark.parametrize("name", ["always", "diurnal"])
def test_availability_profiles_match_on_a_grid(name, duty, backend):
    tz, amp, times = _grid(2)
    ref_fleets, tf = _fleets(tz, amp)
    got_p = tenergy.get_availability_profile(name, PERIOD, duty)
    ref_p = jenergy.get_availability_profile(name, PERIOD, duty)
    tz64 = tz.astype(np.float64)
    for t in times:
        av, av_ref = got_p.available(tf, t), ref_p.available(
            ref_fleets[backend], t)
        assert (av is None) == (av_ref is None)
        host = got_p.available_host(tz64, t)
        np.testing.assert_array_equal(
            np.asarray(host), np.asarray(ref_p.available_host(tz64, t)))
        if av is not None:
            np.testing.assert_array_equal(av.numpy(), np.asarray(av_ref))
            np.testing.assert_array_equal(av.numpy(), host)
        nxt = got_p.next_available_host(tz64, t)
        np.testing.assert_array_equal(nxt,
                                      ref_p.next_available_host(tz64, t))
        assert (nxt >= t).all()


@pytest.mark.parametrize("charge,avail,duty", [
    ("carbon_window", "diurnal", 0.6), ("solar", "diurnal", 0.5),
    ("carbon_window", "always", 1.0), ("constant", "always", 1.0)])
def test_scenario_masks_and_wake_times_match(charge, avail, duty):
    tz, amp, times = _grid(3)
    ref_fleets, tf = _fleets(tz, amp)

    def make(mod):
        return mod.EnergyScenario(
            mod.get_charge_profile(charge, PERIOD),
            mod.get_availability_profile(avail, PERIOD, duty),
            charge_rate=1.0)
    got, ref = make(tenergy), make(jenergy)
    assert got.trivial_availability == ref.trivial_availability
    tz64 = tz.astype(np.float64)
    for t in times:
        av, av_ref = got.available(tf, t), ref.available(ref_fleets["jnp"],
                                                          t)
        host, host_ref = got.available_host(tz64, t), ref.available_host(
            tz64, t)
        assert (av is None) == (av_ref is None) == (host is None) \
            == got.trivial_availability
        if av is not None:
            np.testing.assert_array_equal(av.numpy(), np.asarray(av_ref))
            np.testing.assert_array_equal(host, host_ref)
            np.testing.assert_array_equal(host, av.numpy())
        for sub in (slice(None), slice(0, 3), slice(0, 0)):
            assert got.next_available_host(tz64[sub], t) \
                == ref.next_available_host(tz64[sub], t)


@pytest.mark.parametrize("n,seed,rate", [(8, 1, 1.0), (13, 4, 2.0),
                                         (256, 0, 0.0)])
def test_init_fleet_draws_bit_equal(n, seed, rate):
    """tz_phase first, then the amplitude, from the private stream, for
    every device (a hot-plug fleet's joiners included)."""
    got = tenergy.EnergyScenario(
        tenergy.get_charge_profile("solar"),
        tenergy.get_availability_profile("always"),
        charge_rate=rate).init_fleet(
            tfleet.make_fleet_state(n, seed, device="cpu"), seed)
    ref = jenergy.EnergyScenario(
        jenergy.get_charge_profile("solar"),
        jenergy.get_availability_profile("always"),
        charge_rate=rate).init_fleet(
            jfleet.make_fleet_state(n, seed, backend="jax"), seed)
    for f in ("tz_phase", "charge_rate"):
        g, r = getattr(got, f), np.asarray(getattr(ref, f))
        assert g.dtype == torch.float32 and g.shape == (n,)
        np.testing.assert_array_equal(g.numpy(), r)
    assert ((got.tz_phase >= 0) & (got.tz_phase < 1)).all()


def test_fleet_profile_arrays_default_to_zeros_and_are_carried():
    f = tfleet.make_fleet_state(6, 2, device="cpu")
    for name in ("charge_rate", "tz_phase"):
        a = getattr(f, name)
        assert a.dtype == f.remaining.dtype and not a.any()
    tz = torch.linspace(0.0, 0.9, 6)
    f = f.replace(tz_phase=tz, charge_rate=tz * 2)
    for g in (tfleet.fleet_disconnect(f, 4), tfleet.fleet_connect(f, 4),
              tfleet.fleet_kill(f, [1]), tfleet.fleet_set_alive(f, [2],
                                                                False),
              tfleet.fleet_set_busy(f, [3], 5.0),
              tfleet.fleet_charge(f, torch.ones(6),
                                  torch.ones(6, dtype=torch.bool))[0]):
        assert torch.equal(g.tz_phase, tz)
        assert torch.equal(g.charge_rate, tz * 2)


def test_apply_charge_matches_caps_and_never_resurrects():
    tz, amp, _ = _grid(4)
    ref_fleets, tf = _fleets(tz, amp)
    alive = np.arange(N) % 5 != 0
    low = (np.asarray(tf.battery) * 0.01 * np.linspace(0.0, 1.2, N)
           ).astype(np.float32)
    tf = tf.replace(remaining=torch.tensor(low), alive=torch.tensor(alive))
    jf = ref_fleets["jnp"].replace(remaining=jnp.asarray(low),
                                   alive=jnp.asarray(alive))
    for name in CHARGES:
        def make(mod):
            return mod.EnergyScenario(mod.get_charge_profile(name, PERIOD),
                                      mod.get_availability_profile("always"),
                                      charge_rate=1.0, energy_scale=0.01)
        got, ref = make(tenergy), make(jenergy)
        for t0, t1 in ((0.0, 7.5), (10.0, 90.0), (0.0, 1e9)):
            g = got.apply_charge(tf, t0, t1).remaining.numpy()
            r = np.asarray(ref.apply_charge(jf, t0, t1).remaining)
            np.testing.assert_allclose(g, r, **F32)
            cap = np.maximum(np.asarray(tf.battery) * 0.01, low)
            assert (g <= cap * (1 + 1e-6)).all()
            np.testing.assert_array_equal(g[~alive], low[~alive])
        assert got.apply_charge(tf, 5.0, 5.0) is tf
    # an absurdly long interval fills every alive device to its cap
    full = make(tenergy).apply_charge(tf.replace(charge_rate=torch.ones(N)),
                                      0.0, 1e9).remaining.numpy()
    cap = np.maximum(np.asarray(tf.battery) * 0.01, low)
    np.testing.assert_allclose(full[alive], cap[alive], rtol=1e-6)


def _cost_fleets(seed=7):
    rng = np.random.default_rng(seed)
    data = rng.integers(8, 400, N).tolist()
    jf = jfleet.make_fleet_state(N, seed, data_sizes=data, backend="jax")
    tf = tfleet.make_fleet_state(N, seed, data_sizes=data, device="cpu")
    rem = (np.asarray(jf.battery) * rng.uniform(0.0005, 0.02, N)
           ).astype(np.float32)
    alive = rng.uniform(size=N) > 0.1
    jf = jf.replace(remaining=jnp.asarray(rem), alive=jnp.asarray(alive))
    tf = tf.replace(remaining=torch.tensor(rem), alive=torch.tensor(alive))
    return jf, tf


def test_fleet_affordability_budget_matches():
    """The budget mask is inclusive (``<=``, in float32): a budget equal
    to a submodel's cost keeps it; ``None`` adds nothing."""
    jf, tf = _cost_fleets()
    _, _, e_tra, e_com = tfleet.fleet_cost_matrix(tf, SIZES, FRACS, 5, 32)
    need = (e_tra + e_com).numpy()
    at = float(np.sort(need.ravel())[N])       # exactly one device's cost
    budgets = [None, 1e9, float(np.median(need)), at, float(
        np.nextafter(np.float32(at), np.float32(0))), 0.0]
    seen = set()
    for b in budgets:
        got = tfleet.fleet_affordability(tf, SIZES, FRACS, 5, 32,
                                         budget_left=b).numpy()
        ref = np.asarray(jfleet.fleet_affordability(
            jf, SIZES, FRACS, 5, 32, budget_left=b))
        np.testing.assert_array_equal(got, ref)
        assert got[:, -1].all()
        seen.add(int(got[:, :-1].sum()))
    assert len(seen) >= 4
    hit = need == np.float32(at)
    assert tfleet.fleet_affordability(tf, SIZES, FRACS, 5, 32, budget_left=at
                                      ).numpy()[:, :-1][hit].any()


def test_marl_select_under_a_budget_matches():
    """ε = 0 on both sides (``jax.random`` draws cannot be reproduced):
    the picks, model choices and Q values under a shrinking budget, down
    to one that no action fits."""
    T, M = 6, 4
    js = JaxMarlSelector(N, M, T, seed=2)
    ts = MarlSelector(N, M, T, seed=2, device="cpu")
    ts.learner.load_params(params_from_jax(js.learner.params))
    for sel in (js, ts):
        sel.learner.cfg = dataclasses.replace(sel.learner.cfg,
                                              eps_start=0.0, eps_end=0.0)
        sel.reset_episode()
    jf, tf = _cost_fleets(9)
    _, _, e_tra, e_com = tfleet.fleet_cost_matrix(tf, SIZES, FRACS, 5, 32)
    need = (e_tra + e_com).numpy()
    budgets = [None] + [float(np.quantile(need, q))
                        for q in (0.6, 0.3, 0.1)] + [0.0, None]
    picked = []
    for t, b in enumerate(budgets):
        jsel = js.select(jf, t, 8, SIZES, FRACS, 5, 32, budget_left=b)
        tsel = ts.select(tf, t, 8, SIZES, FRACS, 5, 32, budget_left=b)
        assert tsel.participants == jsel.participants
        assert tsel.model_choice == jsel.model_choice
        np.testing.assert_allclose(tsel.q_values, np.asarray(jsel.q_values),
                                   rtol=1e-5, atol=1e-6)
        for i in tsel.participants:
            assert b is None or need[i, tsel.model_choice[i]] <= b
        picked.append(len(tsel.participants))
    assert picked[0] > 0 and picked[4] == 0


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_scenario_hooks_cost_only_their_documented_host_pulls(mode,
                                                              monkeypatch):
    """Every hook is gated on a Python flag: scenarios that leave the run's
    picks unchanged (a budget that never binds, a diurnal wave always
    open, a charge too small to move a float32 battery) add exactly the
    engine's documented host pulls: the sync engine one at setup for an
    availability gate and one per round for a budget; the async engine
    none (the phases ride its setup pull, the costs a tick's first)."""
    from repro_torch.fl import engine as tengine
    from repro_torch.fl import run_simulation
    calls = []
    pull = tengine.to_host

    def counting(*tensors):
        calls.append(len(tensors))
        return pull(*tensors)
    monkeypatch.setattr(tengine, "to_host", counting)
    base = dict(n_devices=8, n_rounds=2, participation=0.5, local_epochs=1,
                batch_size=16, n_train=400, hw=8, width_mult=0.125, seed=1,
                selector="greedy", client_executor="perclient",
                engine_mode=mode)
    runs = {}
    for name, kw in {"default": {}, "budget": dict(global_budget_j=1e9),
                     "gate": dict(availability_profile="diurnal"),
                     "charge": dict(charge_rate=1e-30)}.items():
        calls.clear()
        hist = run_simulation(FLConfig(**base, **kw), device="cpu")
        runs[name] = (len(calls), hist["participants"])
    pulls = {k: v[0] for k, v in runs.items()}
    assert all(v[1] == runs["default"][1] for v in runs.values())
    rounds = len(runs["default"][1])
    extra = dict(budget=rounds, gate=1) if mode == "sync" else {}
    for name in ("budget", "gate", "charge"):
        assert pulls[name] == pulls["default"] + extra.get(name, 0), pulls
