"""The port's MARL stack against the JAX package's, from converted QMIX
weights: the agent step, the flat mixer, one QMIX update from the same
replay batch, and MarlSelector.select with ε = 0 (``jax.random`` draws
cannot be reproduced, so both sides act greedily).

Tolerances: a forward pass rtol=1e-5, atol=1e-6 (float32 matmuls in a
different order); after the QMIX update (backward + AdamW) rtol=1e-4,
atol=1e-5.  Actions and Top-K picks must be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core.marl import networks as jnet
from repro.core.marl.buffer import ReplayBuffer as JaxReplayBuffer
from repro.core.selection import MarlSelector as JaxMarlSelector
from repro_torch.convert import params_from_jax
from repro_torch.core import fleet as tfleet
from repro_torch.core.marl import networks as tnet
from repro_torch.core.marl.buffer import ReplayBuffer
from repro_torch.core.selection import MarlSelector
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
FWD = dict(rtol=1e-5, atol=1e-6)
UPD = dict(rtol=1e-4, atol=1e-5)
N, M, T = 6, 4, 3
SIZES = (609064, 2736424, 11234600, 45204776)
FRACS = (0.2809416240637261, 0.5206277493758174, 0.7603138746879087, 1.0)


def _greedy(selector):
    cfg = dataclasses.replace(selector.learner.cfg, eps_start=0.0,
                              eps_end=0.0)
    selector.learner.cfg = cfg


@pytest.fixture(scope="module")
def pair():
    js = JaxMarlSelector(N, M, T, seed=0)
    ts = MarlSelector(N, M, T, seed=0, device="cpu")
    ts.learner.load_params(params_from_jax(js.learner.params))
    _greedy(js)
    _greedy(ts)
    return js, ts


def test_agent_step_matches(pair):
    js, ts = pair
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(2, N, 5)).astype(np.float32)
    h = rng.normal(size=(2, N, 64)).astype(np.float32)
    jq, jh = jnet.agent_step(js.learner.params["agent"], obs, h)
    tq, th = tnet.agent_step(ts.learner.params["agent"], torch.tensor(obs),
                             torch.tensor(h))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **FWD)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD)


def test_flat_mixer_matches(pair):
    js, ts = pair
    rng = np.random.default_rng(2)
    qs = rng.normal(size=(3, T, N)).astype(np.float32)
    state = rng.normal(size=(3, T, N * 5)).astype(np.float32)
    ref = jnet.mixer_apply(js.learner.params["mixer"], qs, state, N, 32)
    got = tnet.mixer_apply(ts.learner.params["mixer"], torch.tensor(qs),
                           torch.tensor(state), N, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


def _batch(seed):
    rng = np.random.default_rng(seed)
    buf = ReplayBuffer(8, T, N, 5, N * 5, seed)
    for _ in range(3):
        obs = rng.normal(size=(T + 1, N, 5)).astype(np.float32)
        buf.add_episode(obs, obs.reshape(T + 1, -1),
                        rng.integers(0, M + 1, (T, N)),
                        rng.normal(size=T).astype(np.float32) * 10)
    return buf.sample(4)


def test_replay_sampling_is_the_jax_packages():
    rng = np.random.default_rng(5)
    bufs = [ReplayBuffer(4, T, N, 5, N * 5, 7),
            JaxReplayBuffer(4, T, N, 5, N * 5, 7)]
    for _ in range(3):
        obs = rng.normal(size=(T + 1, N, 5)).astype(np.float32)
        acts = rng.integers(0, M + 1, (T, N))
        for b in bufs:
            b.add_episode(obs, obs.reshape(T + 1, -1), acts, np.ones(T))
    a, b = (buf.sample(5) for buf in bufs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_qmix_update_matches():
    js = JaxMarlSelector(N, M, T, seed=4)
    ts = MarlSelector(N, M, T, seed=4, device="cpu")
    ts.learner.load_params(params_from_jax(js.learner.params))
    batch = _batch(9)
    jm = js.learner.update(batch)
    tm = ts.learner.update(batch)
    np.testing.assert_allclose(tm["td_loss"], jm["td_loss"], **UPD)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], **UPD)
    for g, r in zip(tree_leaves(params_from_jax(js.learner.params)),
                    tree_leaves(ts.learner.params)):
        np.testing.assert_allclose(r.numpy(), g.numpy(), **UPD)


def test_select_picks_equal(pair):
    js, ts = pair
    rng = np.random.default_rng(3)
    data = rng.integers(8, 400, N).tolist()
    jf = jfleet.make_fleet_state(N, 11, data_sizes=data, backend="jax")
    tf = tfleet.make_fleet_state(N, 11, data_sizes=data, device="cpu")
    rem = np.asarray(jf.remaining) * rng.uniform(0.0005, 1.0, N)
    alive = np.array([True] * (N - 1) + [False])
    jf = jf.replace(remaining=jnp.asarray(rem.astype(np.float32)),
                    alive=jnp.asarray(alive))
    tf = tf.replace(remaining=torch.tensor(rem.astype(np.float32)),
                    alive=torch.tensor(alive))
    for t in range(T):
        jsel = js.select(jf, t, 3, SIZES, FRACS, 5, 32)
        tsel = ts.select(tf, t, 3, SIZES, FRACS, 5, 32)
        assert tsel.participants == jsel.participants
        assert tsel.model_choice == jsel.model_choice
        np.testing.assert_allclose(tsel.q_values, np.asarray(jsel.q_values),
                                   **FWD)
        assert N - 1 not in tsel.participants          # dead abstains
    jarr = js.episode_arrays(jf, T)
    tarr = ts.episode_arrays(tf, T)
    for a, b in zip(tarr[:3], jarr[:3]):
        np.testing.assert_array_equal(a, b)
