"""The gym-style ``FLEnv`` against the JAX package's, on the CPU: both
reward clocks (sync barrier and async event time), ``for_family`` for
every registered family, the flat and the factored states, a fleet that
dies out, a custom accuracy proxy, and one host pull a step.

Both envs take the same seeded numpy actions.  Observations and ``state``
must be equal (float32 roundings of the same float64 values); dropouts,
alive counts and ``done`` equal; rewards, energies and times at rtol 1e-9
(float64 sums in another order); ``state_factored`` at rtol 1e-6 (float64
features rounded to float32).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fl.environment import FLEnv as JaxFLEnv
from repro.fl.environment import FLEnvConfig as JaxFLEnvConfig
from repro_torch.fl import environment as tenv
from repro_torch.fl.environment import FLEnv, FLEnvConfig

torch.set_num_threads(1)
F64 = dict(rtol=1e-9, atol=0.0)


def _both(mode, family, **kw):
    kw = dict(dict(n_devices=48, n_rounds=25, seed=3, mode=mode), **kw)
    if family is None:
        return JaxFLEnv(JaxFLEnvConfig(**kw)), FLEnv(FLEnvConfig(**kw),
                                                     device="cpu")
    jcfg = JaxFLEnvConfig.for_family(family, **kw)
    tcfg = FLEnvConfig.for_family(family, **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return JaxFLEnv(jcfg), FLEnv(tcfg, device="cpu")


def _run_both(je, te, seed=0, steps=None):
    """Step both envs with the same actions until ``done``; hold every
    step; return the number of steps."""
    np.testing.assert_array_equal(te.reset().numpy(), je.reset())
    rng = np.random.default_rng(seed)
    n, M = je.cfg.n_devices, je.cfg.n_models
    for t in range(steps or je.cfg.n_rounds):
        a = rng.integers(0, M + 1, n)
        jo, jr, jd, ji = je.step(a)
        to, tr, td, ti = te.step(a)
        np.testing.assert_array_equal(to.numpy(), jo)
        np.testing.assert_array_equal(te.state.numpy(), je.state)
        np.testing.assert_allclose(te.state_factored.numpy(),
                                   je.state_factored, rtol=1e-6, atol=0)
        assert (td, ti["alive"], ti["dropouts"]) == \
            (jd, ji["alive"], ji["dropouts"]), t
        np.testing.assert_allclose(tr, jr, **F64)
        for k in ("acc", "energy", "round_time", "sim_time", "idle_time"):
            np.testing.assert_allclose(ti[k], ji[k], **F64, err_msg=k)
        if jd:
            return t + 1
    return t + 1


@pytest.mark.parametrize("family", [None, "cnn", "mlp", "transformer"])
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_env_matches_jax(mode, family):
    je, te = _both(mode, family)
    assert te.fleet.remaining.dtype == torch.float64
    assert _run_both(je, te) == je.cfg.n_rounds
    assert te.sim_time > 0
    if mode == "async":                  # tasks ran on the virtual clocks
        assert float(te.fleet.busy_until.max()) > 0.0


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_fleet_dies_out_as_the_reference(mode):
    """Batteries at 0.2% of capacity: devices that train die, and the
    episode ends early when none is left."""
    je, te = _both(mode, "cnn", n_devices=12, energy_scale=0.002,
                   n_rounds=40)
    steps = _run_both(je, te, seed=2)
    assert steps < 40 and not je.fleet.alive.any()


def test_custom_accuracy_proxy_and_one_pull_a_step(monkeypatch):
    def proxy(p):
        return 0.5 * np.tanh(p)
    kw = dict(n_devices=16, n_rounds=6, seed=1, mode="async")
    je = JaxFLEnv(JaxFLEnvConfig(**kw), accuracy_proxy=proxy)
    te = FLEnv(FLEnvConfig(**kw), accuracy_proxy=proxy, device="cpu")
    pulls = []
    real = tenv.to_host

    def counted(*tensors):
        pulls.append(len(tensors))
        return real(*tensors)
    monkeypatch.setattr(tenv, "to_host", counted)
    _run_both(je, te, seed=5)
    assert pulls == [1] * 6


def test_env_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        FLEnv(FLEnvConfig(n_devices=4))
