"""MARL at fleet scale against the JAX package: the factored fleet summary,
the Top-K mask, the set/attention mixer, the set-mode QMIX loss,
sampled-agent replay, the fleet-scale ``MarlSelector`` and the
data-parallel ``dual_selection_energy_step``, all on the CPU (the mixer's
attention through its plain version, the reference's ``attention_ref``).

Tolerances: histogram bins, affordability fractions, actions, picks, the
sampled agents and integer columns exact; the summary's float totals
within 1e-6 (float32 sums in another order: the port sums exactly in
float64 and rounds once); a forward pass rtol=1e-5, atol=1e-5; after a
QMIX update (backward + AdamW) rtol=1e-4, atol=1e-5; ε = 0 on both sides
(``jax.random`` draws cannot be reproduced in torch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.core import selection as jselection
from repro.core.marl import networks as jnet
from repro.core.marl.buffer import ReplayBuffer as JaxReplayBuffer
from repro.core.marl.qmix import QmixConfig as JaxQmixConfig
from repro.core.marl.qmix import QmixLearner as JaxQmixLearner
from repro.energy.profiles import SolarCharge as JaxSolarCharge
from repro_torch.convert import params_from_jax
from repro_torch.core import fleet as tfleet
from repro_torch.core import selection as tselection
from repro_torch.core.marl import networks as tnet
from repro_torch.core.marl.buffer import ReplayBuffer
from repro_torch.core.marl.qmix import QmixConfig, QmixLearner
from repro_torch.energy.profiles import SolarCharge
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
FWD = dict(rtol=1e-5, atol=1e-5)
UPD = dict(rtol=1e-4, atol=1e-5)
SUMMARY_FLOAT = dict(rtol=1e-6, atol=1e-6)
SIZES = (609064, 2736424, 11234600, 45204776)
FRACS = (0.2809416240637261, 0.5206277493758174, 0.7603138746879087, 1.0)
M = len(SIZES)
#: the summary's counting columns: both histograms and the affordability
#: fractions (counts times 1/n)
EXACT = 2 * tfleet.SUMMARY_BINS + M


def assert_summary_equal(got, ref, n, bitwise=True):
    """Every count equal (bins and affordable devices) and every value
    within 1e-6; with ``bitwise`` (against float32 JAX) the counting
    columns equal to the bit (a count times float32 1/n in both), where
    the numpy backend computes them in float64 and rounds once."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape == (tfleet.summary_width(M),)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.rint(got[:EXACT] * n),
                                  np.rint(ref[:EXACT] * n))
    if bitwise:
        np.testing.assert_array_equal(got[:EXACT], ref[:EXACT])
    np.testing.assert_allclose(got, ref, **SUMMARY_FLOAT)


def _fleets(n, seed, edges=True):
    """(JAX fleet, port fleet) of the same draws, batteries at seeded
    fractions, a tenth dead; with ``edges`` some batteries sit exactly on
    the battery histogram's bin edges and some capabilities on the
    capability histogram's."""
    rng = np.random.default_rng(seed)
    jf = jfleet.make_fleet_state(n, seed, backend="jax")
    frac = rng.uniform(0.0, 1.0, n)
    if edges:
        frac[:9] = np.arange(9) / 8.0          # 0, 1/8, ..., 1 exactly
    rem = (np.asarray(jf.battery, np.float64) * frac).astype(np.float32)
    compute = np.asarray(jf.compute, np.float32).copy()
    mode = np.asarray(jf.mode_compute, np.float32).copy()
    if edges:
        # eff = compute * mode / 500 on the edges j / 4 of [0, 2) in 8 bins
        compute[16:24] = 125.0 * np.arange(1, 9)
        mode[16:24] = 1.0
    alive = rng.uniform(size=n) > 0.1
    jf = jf.replace(remaining=jnp.asarray(rem), alive=jnp.asarray(alive),
                    compute=jnp.asarray(compute),
                    mode_compute=jnp.asarray(mode))
    tf = tfleet.make_fleet_state(n, seed, device="cpu").replace(
        remaining=torch.tensor(rem), alive=torch.tensor(alive),
        compute=torch.tensor(compute), mode_compute=torch.tensor(mode))
    return jf, tf


def _numpy_fleet(jf):
    """The reference's numpy (float64) backend on the float32 values."""
    conv = {f.name: np.asarray(getattr(jf, f.name))
            for f in dataclasses.fields(jf)
            if isinstance(getattr(jf, f.name), jax.Array)}
    conv = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
            for k, v in conv.items()}
    return jf.replace(**conv)


def test_summary_width_is_the_references():
    for m in (1, 4, 7):
        for bins in (4, 8, 16):
            assert tfleet.summary_width(m, bins) == \
                jfleet.summary_width(m, bins)
    assert tfleet.SUMMARY_BINS == jfleet.SUMMARY_BINS
    assert tfleet.SUMMARY_EXCLUDED_FIELDS == jfleet.SUMMARY_EXCLUDED_FIELDS


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("round_idx", [0, 3, 7])
def test_fleet_summary_matches_jax(seed, round_idx):
    """Bins exact, values on bin edges included, against the jitted and
    the eager JAX summary (float32)."""
    jf, tf = _fleets(300, seed)
    got = tfleet.fleet_summary(tf, SIZES, FRACS, round_idx, 9, 5, 32)
    for fn in (jfleet.fleet_summary, jfleet.fleet_summary_jit):
        ref = fn(jf, SIZES, FRACS, round_idx, 9, 5, 32)
        assert_summary_equal(got.numpy(), ref, 300)
    # some devices of every histogram sit on a bin edge
    assert {float(v) for v in got[:8]} != {0.0}


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_summary_matches_the_numpy_backend(seed):
    """The reference's float64 backend: seeded batteries off the bin
    edges (its float64 ``hi = 1 + 1e-9`` puts an edge value one bin
    lower than float32 does, where both the JAX backend and the port
    keep 1.0), capabilities on them."""
    jf, tf = _fleets(300, seed, edges=False)
    got = tfleet.fleet_summary(tf, SIZES, FRACS, 2, 9, 5, 32)
    ref = jfleet.fleet_summary(_numpy_fleet(jf), SIZES, FRACS, 2, 9, 5, 32)
    assert_summary_equal(got.numpy(), ref, 300, bitwise=False)


def test_fleet_summary_reuses_the_given_mask():
    """``afford=``: the caller's (budget-masked) mask is summarised, as
    the reference's."""
    jf, tf = _fleets(300, 3)
    jaff = jfleet.fleet_affordability(jf, SIZES, FRACS, 5, 32,
                                      budget_left=90.0)
    taff = tfleet.fleet_affordability(tf, SIZES, FRACS, 5, 32,
                                      budget_left=90.0)
    np.testing.assert_array_equal(taff.numpy(), np.asarray(jaff))
    got = tfleet.fleet_summary(tf, SIZES, FRACS, 1, 4, afford=taff)
    ref = jfleet.fleet_summary(jf, SIZES, FRACS, 1, 4, afford=jaff)
    assert_summary_equal(got.numpy(), ref, 300)
    free = tfleet.fleet_summary(tf, SIZES, FRACS, 1, 4)
    assert not torch.equal(free[16:20], got[16:20])


@pytest.mark.parametrize("k", [0, 1, 5, 9, 40])
def test_fleet_topk_mask_ties_go_to_the_lower_index(k):
    scores = np.array([3.0, 1.0, 3.0, -np.inf, 2.0, 3.0, 1.0, -np.inf,
                       2.0, 1.0], np.float32)
    got = tfleet.fleet_topk_mask(torch.tensor(scores), k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfleet.fleet_topk_mask(jnp.asarray(scores), k)))
    np.testing.assert_array_equal(got, jfleet.fleet_topk_mask(scores, k))
    assert not got[[3, 7]].any()


def test_sample_fleet_state_matches_jax():
    for n, seed in ((1000, 0), (4096, 7)):
        jf = jfleet.sample_fleet_state(n, seed=seed, backend="jax")
        tf = tfleet.sample_fleet_state(n, seed=seed, device="cpu")
        for f in ("compute", "p_train", "p_com", "bandwidth", "battery",
                  "remaining", "data_size", "mode_compute", "mode_power",
                  "alive"):
            a, b = getattr(tf, f).numpy(), np.asarray(getattr(jf, f))
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# the set/attention mixer
# ---------------------------------------------------------------------------


def _mixer_inputs(seed, batch=(2, 3), n=7, state_dim=25):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=batch + (n,)).astype(np.float32)
    obs = rng.normal(size=batch + (n, 5)).astype(np.float32)
    state = rng.normal(size=batch + (state_dim,)).astype(np.float32)
    logw = rng.normal(size=(batch[0], 1, n)).astype(np.float32)
    return qs, obs, state, logw


def test_set_mixer_init_has_the_references_tree():
    jp = jnet.set_mixer_init(jax.random.PRNGKey(0), 25, 5, 32, 4)
    tp = tnet.set_mixer_init(torch.Generator().manual_seed(0), 25, 5, 32, 4)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(a.shape) == b.shape


@pytest.mark.parametrize("with_logw", [False, True])
@pytest.mark.parametrize("n", [1, 7, 70])
def test_set_mixer_matches_jax_with_its_gradient(with_logw, n):
    """Forward at rtol 1e-5, atol 1e-5, and the gradient of a seeded
    cotangent against ``jax.grad`` in every parameter and in qs."""
    jp = jnet.set_mixer_init(jax.random.PRNGKey(n), 25, 5)
    qs, obs, state, logw = _mixer_inputs(n, n=n)
    lw = logw if with_logw else None
    ct = np.random.default_rng(9).normal(size=qs.shape[:-1]).astype(
        np.float32)

    def jloss(p, q):
        return jnp.sum(jnet.set_mixer_apply(p, q, obs, state, logw=lw) * ct)
    ref = jnet.set_mixer_apply(jp, qs, obs, state, logw=lw)
    jgp, jgq = jax.grad(jloss, argnums=(0, 1))(jp, qs)

    tp = params_from_jax(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    tq = torch.tensor(qs, requires_grad=True)
    tlw = None if lw is None else torch.tensor(lw)
    got = tnet.set_mixer_apply(tp, tq, torch.tensor(obs), torch.tensor(state),
                               logw=tlw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **FWD)
    grads = torch.autograd.grad((got * torch.tensor(ct)).sum(),
                                leaves + [tq])
    for g, r in zip(grads, jax.tree.leaves(jgp) + [jgq]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FWD)


def test_set_mixer_is_order_invariant_and_reweights_by_logw():
    """Permuting the agents leaves Q_tot unchanged; a log-weight of
    log(2) on an agent equals that agent stored twice (self-normalised
    importance weighting through the seeds' sqrt(d) slot)."""
    tp = tnet.set_mixer_init(torch.Generator().manual_seed(3), 25, 5)
    qs, obs, state, _ = (torch.tensor(a) for a in _mixer_inputs(4))
    perm = torch.randperm(qs.shape[-1], generator=torch.Generator()
                          .manual_seed(1))
    a = tnet.set_mixer_apply(tp, qs, obs, state)
    b = tnet.set_mixer_apply(tp, qs[..., perm], obs[..., perm, :], state)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    logw = torch.zeros(qs.shape)
    logw[..., 0] = float(np.log(2.0))
    twice_q = torch.cat([qs, qs[..., :1]], dim=-1)
    twice_o = torch.cat([obs, obs[..., :1, :]], dim=-2)
    torch.testing.assert_close(
        tnet.set_mixer_apply(tp, qs, obs, state, logw=logw),
        tnet.set_mixer_apply(tp, twice_q, twice_o, state),
        rtol=1e-5, atol=1e-5)


def test_attention_reduce_on_the_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in ((6, 4, 32),
                                                    (6, 300, 32),
                                                    (6, 300, 32)))
    from repro_torch.kernels import LAUNCHES
    before = dict(LAUNCHES)
    got = tnet.attention_reduce(q, k, v)
    assert LAUNCHES == before
    s = torch.einsum("bqd,bkd->bqk", q, k) / np.sqrt(32)
    torch.testing.assert_close(
        got, torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v))
    assert tnet.FLASH_ATTENTION_MIN_AGENTS == \
        jnet.FLASH_ATTENTION_MIN_AGENTS


# ---------------------------------------------------------------------------
# the set-mode QMIX update and sampled-agent replay
# ---------------------------------------------------------------------------


def _budget_buffers(budget=5, n=12, T=4, seed=3):
    """(port, JAX) budgeted buffers filled alike: full-fleet episodes the
    buffer subsamples with its own RNG, and pre-sampled narrow ones with
    their agent_idx and (nonzero) log-weights."""
    rng = np.random.default_rng(seed)
    bufs = [ReplayBuffer(4, T, n, 5, 25, seed, agent_budget=budget),
            JaxReplayBuffer(4, T, n, 5, 25, seed, agent_budget=budget)]
    for ep in range(6):
        t = T - ep % 2
        wide = ep % 3 != 2
        width = n if wide else budget
        obs = rng.normal(size=(t + 1, width, 5)).astype(np.float32)
        state = rng.normal(size=(t + 1, 25)).astype(np.float32)
        acts = rng.integers(0, M + 1, (t, width))
        rew = rng.normal(size=t).astype(np.float32) * 10
        kw = {}
        if not wide:
            kw = dict(agent_idx=np.sort(rng.choice(n, budget, replace=False)),
                      agent_logw=rng.normal(size=budget).astype(np.float32))
        for b in bufs:
            b.add_episode(obs, state, acts, rew, **kw)
    return bufs


def test_budgeted_buffer_add_and_sample_match_jax():
    tb, jb = _budget_buffers()
    for name in ("obs", "state", "actions", "rewards", "mask", "agent_idx",
                 "agent_logw"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name),
                                      err_msg=name)
    assert tb.N == jb.N == 5 and tb.nbytes == jb.nbytes
    assert np.any(tb.agent_logw != 0)
    for _ in range(3):
        a, b = tb.sample(3), jb.sample(3)
        assert set(a) == set(b) and "agent_logw" in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("with_logw", [False, True])
def test_set_mode_td_loss_matches_jax_update(with_logw):
    """One QMIX update from the same sampled-agent batch: the loss (taken
    before the step) and the grad norm at UPD, then every parameter at
    UPD but the key projection's bias.  Its gradient is zero in exact
    arithmetic (it shifts every key's logit by the same q.b, which the
    softmax cancels), so each package's is float32 noise, and AdamW's
    step on noise, lr * m / (sqrt(v) + eps), takes any value in [-lr,
    lr]: that bias is held at an atol of 2 lr."""
    kw = dict(n_agents=12, obs_dim=5, num_actions=M + 1, state_dim=25,
              mixer_mode="set")
    jl = JaxQmixLearner(JaxQmixConfig(**kw), jax.random.PRNGKey(5))
    tl = QmixLearner(QmixConfig(**kw), 0, device="cpu")
    tl.load_params(params_from_jax(jl.params))
    batch = _budget_buffers(seed=11)[0].sample(4)
    if not with_logw:
        batch["agent_logw"] = np.zeros_like(batch["agent_logw"])
    assert batch["obs"].shape[2] == 5 and np.any(batch["agent_logw"]) == \
        with_logw
    jm, tm = jl.update(dict(batch)), tl.update(dict(batch))
    np.testing.assert_allclose(tm["td_loss"], jm["td_loss"], **UPD)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], **UPD)
    ref = params_from_jax(jl.params)
    bias = tl.params["mixer"]["key_proj"].pop("b")
    ref_bias = ref["mixer"]["key_proj"].pop("b")
    np.testing.assert_allclose(bias.numpy(), ref_bias.numpy(), rtol=0,
                               atol=2 * tl.cfg.lr)
    for g, r in zip(tree_leaves(tl.params), tree_leaves(ref)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **UPD)


# ---------------------------------------------------------------------------
# the fleet-scale MarlSelector
# ---------------------------------------------------------------------------


def test_mode_resolution_is_the_references():
    for n in (1, 256, 257, 4096):
        for mode in ("auto", "flat", "factored"):
            assert tselection.resolve_state_mode(mode, n) == \
                jselection.resolve_state_mode(mode, n)
            assert tselection.marl_state_dim(mode, n, M) == \
                jselection.marl_state_dim(mode, n, M)
        for mode in ("auto", "flat", "set"):
            assert tselection.resolve_mixer_mode(mode, n) == \
                jselection.resolve_mixer_mode(mode, n)
    for fn in (tselection.resolve_state_mode, tselection.resolve_mixer_mode):
        with pytest.raises(ValueError, match="unknown"):
            fn("sparse", 10)
    assert tselection.SAMPLE_AGENT_BUDGET == jselection.SAMPLE_AGENT_BUDGET
    assert tselection.STATE_MODES == jselection.STATE_MODES
    assert tselection.MIXER_MODES == jselection.MIXER_MODES


def _greedy(selector):
    selector.learner.cfg = dataclasses.replace(
        selector.learner.cfg, eps_start=0.0, eps_end=0.0)


#: (n, state_mode, mixer_mode, agent_budget): "auto" at 300 (factored and
#: set, the trace sampled to 64 agents); a flat state with a sampled trace
#: (the state keeps the whole fleet); flat and flat
SELECTORS = {"auto-n300": (300, "auto", "auto", 64),
             "flat-state-sampled": (20, "flat", "set", 8),
             "flat-flat": (6, "flat", "flat", 4096)}


@pytest.mark.parametrize("case", list(SELECTORS))
def test_marl_selector_and_episode_arrays_match_jax(case):
    """ε = 0, the JAX selector's QMIX params: every round's picks, model
    choices, Q values, the sampled agents (``_ep_idx``, the reference's
    numpy draws) and the episode arrays in their three branches; one
    round under a global budget, whose mask the factored state sees."""
    n, state_mode, mixer_mode, budget = SELECTORS[case]
    T = 3
    js = jselection.MarlSelector(n, M, T, seed=2, state_mode=state_mode,
                                 mixer_mode=mixer_mode, agent_budget=budget)
    ts = tselection.MarlSelector(n, M, T, seed=2, state_mode=state_mode,
                                 mixer_mode=mixer_mode, agent_budget=budget,
                                 device="cpu")
    ts.learner.load_params(params_from_jax(js.learner.params))
    for s in (js, ts):
        _greedy(s)
    for _ in range(2):          # a draw at construction, one per episode
        if js._ep_idx is None:
            assert ts._ep_idx is None
        else:
            np.testing.assert_array_equal(ts._ep_idx, js._ep_idx)
        for s in (js, ts):
            s.reset_episode()
    assert (ts.state_mode, ts.mixer_mode, ts.n_sampled) == \
        (js.state_mode, js.mixer_mode, js.n_sampled)
    sampled = js._ep_idx is not None
    assert sampled == (case != "flat-flat")
    jf, tf = _fleets(n, 5, edges=n >= 24)
    k = max(1, n // 50)
    for t in range(T):
        budget_left = 300.0 if t == 1 else None
        jsel = js.select(jf, t, k, SIZES, FRACS, 5, 32, budget_left)
        tsel = ts.select(tf, t, k, SIZES, FRACS, 5, 32, budget_left)
        assert tsel.participants == jsel.participants
        assert tsel.model_choice == jsel.model_choice
        np.testing.assert_allclose(tsel.q_values, np.asarray(jsel.q_values),
                                   **FWD)
        np.testing.assert_array_equal(ts.ep_obs[-1], js.ep_obs[-1])
        np.testing.assert_array_equal(ts.ep_actions[-1], js.ep_actions[-1])
        for s in (js, ts):
            s.observe_reward(float(t))
        # the next round sees a drained fleet
        drain = np.float32(0.8)
        jf = jf.replace(remaining=jf.remaining * drain)
        tf = tf.replace(remaining=tf.remaining * drain)
    jarr = js.episode_arrays(jf, T)
    tarr = ts.episode_arrays(tf, T)
    width = js.n_sampled
    assert tarr[0].shape == (T + 1, width, 5)
    np.testing.assert_array_equal(tarr[0], jarr[0])
    np.testing.assert_array_equal(tarr[2], jarr[2])
    np.testing.assert_array_equal(tarr[3], jarr[3])
    if ts.state_mode == "factored":
        assert tarr[1].shape == (T + 1, tfleet.summary_width(M))
        for a, b in zip(tarr[1], jarr[1]):
            assert_summary_equal(a, b, n)
    else:
        assert tarr[1].shape == (T + 1, n * 5)    # the whole fleet's obs
        np.testing.assert_array_equal(tarr[1], jarr[1])


def test_fleet_obs_batch_matches_jax():
    jf, tf = _fleets(300, 8)
    for t in (0, 4):
        np.testing.assert_array_equal(
            tselection.fleet_obs_batch(tf, t, 9).numpy(),
            np.asarray(jselection.fleet_obs_batch(jf, t, 9)))


@pytest.mark.parametrize("charge", [False, True])
def test_dual_selection_energy_step_matches_jax(charge):
    """The step with a solar charge profile, a global budget and an
    availability wave against the reference's jitted program: picks and
    actions exact, the charged fleet at rtol 1e-6 (float32 sin in each
    package), the summary of the charged fleet as above."""
    n, k = 300, 12
    jf, tf = _fleets(n, 6)
    rng = np.random.default_rng(4)
    rate = rng.uniform(0.0, 2.0, n).astype(np.float32)
    phase = rng.uniform(0.0, 1.0, n).astype(np.float32)
    wave = rng.uniform(size=n) > 0.2
    jf = jf.replace(charge_rate=jnp.asarray(rate),
                    tz_phase=jnp.asarray(phase))
    tf = tf.replace(charge_rate=torch.tensor(rate),
                    tz_phase=torch.tensor(phase))
    js = jselection.MarlSelector(n, M, 4, seed=1, state_mode="factored",
                                 mixer_mode="set")
    hidden = rng.normal(size=(n, 64)).astype(np.float32)
    kw = dict(round_idx=2, n_rounds=5, local_epochs=5, batch_size=32,
              budget_left=250.0, sim_time=30.0,
              charge_dt=12.0 if charge else 0.0, energy_scale=0.9)
    jout = jselection.dual_selection_energy_step_jit(
        js.learner.params["agent"], jnp.asarray(hidden), jf, SIZES, FRACS,
        k, charge_profile=JaxSolarCharge(period=100.0) if charge else None,
        avail_mask=jnp.asarray(wave), **kw)
    tout = tselection.dual_selection_energy_step(
        params_from_jax(js.learner.params["agent"]), torch.tensor(hidden),
        tf, SIZES, FRACS, k,
        charge_profile=SolarCharge(period=100.0) if charge else None,
        avail_mask=torch.tensor(wave), **kw)
    (jfl, jh, jpart, jact, jsum), (tfl, th, tpart, tact, tsum) = jout, tout
    np.testing.assert_array_equal(tpart.numpy(), np.asarray(jpart))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    assert 0 < int(tpart.sum()) <= k
    assert not (tpart.numpy() & ~wave).any()
    np.testing.assert_array_equal(tfl.alive.numpy(), np.asarray(jfl.alive))
    np.testing.assert_allclose(tfl.remaining.numpy(),
                               np.asarray(jfl.remaining), rtol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD)
    assert_summary_equal(tsum.numpy(), jsum, n)
    if charge:
        assert float(tfl.remaining.sum()) > float(
            tselection.dual_selection_energy_step(
                params_from_jax(js.learner.params["agent"]),
                torch.tensor(hidden), tf, SIZES, FRACS, k,
                avail_mask=torch.tensor(wave),
                **dict(kw, charge_dt=0.0))[0].remaining.sum())


@pytest.mark.parametrize("mixer_mode", ["set", "flat"])
def test_marl_train_bench_trajectory_matches_jax(mixer_mode):
    """``benchmarks/marl_train_bench.py``'s procedure at n = 256 (the
    factored state; a replay of capacity 8 filled by 3 select episodes of
    4 rounds over sampled fleets; 18 updates of B 3), from the JAX
    selector's QMIX params at ε = 0: every update's td_loss at UPD (the
    two learners see the same batches, and their losses stay together
    over the whole run)."""
    from repro.core.marl.buffer import ReplayBuffer as JaxBuffer
    n, T, k = 256, 4, 2
    sizes, fracs = (2.8e6, 8.4e6, 22.5e6, 44.8e6), (0.11, 0.3, 0.72, 1.0)
    kw = dict(seed=0, state_mode="factored", mixer_mode=mixer_mode)
    js = jselection.MarlSelector(n, 4, T, **kw)
    ts = tselection.MarlSelector(n, 4, T, device="cpu", **kw)
    ts.learner.load_params(params_from_jax(js.learner.params))
    for s in (js, ts):
        _greedy(s)
    budget = 4096 if mixer_mode == "set" else None
    bufs = [JaxBuffer(8, T, n, 5, 25, 0, agent_budget=budget),
            ReplayBuffer(8, T, n, 5, 25, 0, agent_budget=budget)]
    for ep in range(3):
        fleets = (jfleet.sample_fleet_state(n, seed=ep, backend="jax"),
                  tfleet.sample_fleet_state(n, seed=ep, device="cpu"))
        for s, f, b in zip((js, ts), fleets, bufs):
            s.reset_episode()
            for t in range(T):
                s.select(f, t, k, sizes, fracs)
                s.observe_reward(0.1 * (ep + t))
            b.add_episode(*s.episode_arrays(f, T))
    losses = [[s.learner.update(b.sample(16))["td_loss"] for _ in range(18)]
              for s, b in zip((js, ts), bufs)]
    np.testing.assert_allclose(losses[1], losses[0], **UPD)
