"""MARL at fleet scale on live runs of both packages
(``tests/torch_live.py``): 300 devices, above the 256 at which ``"auto"``
takes the factored QMIX state and the set/attention mixer, on both engines
and both executors, with the replay storing every agent or a sampled 64
(``marl_agent_budget``).  ε = 0 from the JAX selector's QMIX params.

Held as the other live tests: picks, model choices, task logs and the
sampled agents (``_ep_idx``) identical; accuracy within one validation
sample; energy, times and the reward's non-accuracy terms at rtol=1e-4
(the reward's energy term at the float32 spacing of the fleet's energy
sums, ``_energy_term_atol``); final weights at rtol=1e-4, atol=1e-5.  The
QMIX learner is held by replaying the JAX episode into the port's
learner (``_assert_qmix_replays_reference``: the episode's observations
and factored states at TOL, actions equal; the losses at TOL, the params
at 2 lr per update, since the set mixer's key bias has a gradient of
float32 noise).

Size: 1500 samples over 300 devices (about 5 each), width 0.125, 8x8
images, k = 6 a round; the async arms stop at 12 tasks (float32 SGD drift
grows with the aggregations, ROADMAP Queue 3).
"""
import numpy as np
import pytest
import torch

from torch_live import (BASE, _assert_final_state_agree, _assert_rows_agree,
                        _energy_term_atol, assert_async_runs_agree, run_both)

torch.set_num_threads(1)

FLEET = dict(BASE, n_devices=300, participation=0.02, n_train=1500)
ASYNC = dict(FLEET, engine_mode="async", async_task_budget=12)
ARMS = {
    "sync-batched": dict(FLEET, client_executor="batched"),
    "sync-sampled-perclient": dict(FLEET, marl_agent_budget=64,
                                   client_executor="perclient"),
    "async-batched": dict(ASYNC, client_executor="batched"),
    "async-sampled-batched": dict(ASYNC, marl_agent_budget=64,
                                  client_executor="batched"),
    "async-sampled-perclient": dict(ASYNC, marl_agent_budget=64,
                                    client_executor="perclient"),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_fleet_scale_live_run_matches_jax(arm):
    kw = ARMS[arm]
    jh, th, jsel, tsel = run_both(kw)
    assert (tsel.state_mode, tsel.mixer_mode) == ("factored", "set")
    assert th["qmix"]["mixer_mode"] == jh["qmix"]["mixer_mode"] == "set"
    budget = kw.get("marl_agent_budget", 4096)
    assert th["qmix"]["replay_agents"] == jh["qmix"]["replay_agents"] == \
        min(300, budget)
    if jsel._ep_idx is None:
        assert budget >= 300 and tsel._ep_idx is None
    else:
        np.testing.assert_array_equal(tsel._ep_idx, jsel._ep_idx)
    executor = kw["client_executor"]
    if kw.get("engine_mode") == "async":
        assert_async_runs_agree(kw, jh, th, jsel, tsel, executor)
        assert 1 <= th["n_aggregations"] <= 12
        return
    assert len(th["participants"]) == kw["n_rounds"]
    _assert_rows_agree(kw, jh, th, executor,
                       ("energy", "round_time", "sim_time", "idle"),
                       reward_atol=_energy_term_atol(kw, th))
    assert th["terminated"] == jh["terminated"]
    _assert_final_state_agree(kw, jh, th, jsel, tsel, replay=True)
