"""DR-FL federated simulation — port of ``repro.fl.simulation``.

:class:`FLConfig` keeps every field and default of the JAX config, so a
config carries across packages; :func:`run_simulation` takes it or a
typed :class:`repro_torch.fl.spec.SimulationSpec` and validates either
through :func:`repro_torch.fl.spec.ensure_flat_config` first, with the
reference's messages, before any device work.  The port runs the sync
and async engines (hot-plug on both, seeded fault plans on the async one)
with every arm of the paper's Table 1 and Fig. 5: DR-FL with the
``marl``, ``greedy``, ``random`` or ``static`` selector, and
HeteroFL/ScaleFL (always greedy), on every registered family (``cnn``,
the one with all three methods; ``mlp`` and ``transformer``, DR-FL; and
any family a user registers), with either client executor, under every
energy scenario of the reference (charge and availability profiles, the
global joule budget: the ``charge_*``, ``availability_*`` and
``global_budget_j`` fields, resolved by
:func:`repro_torch.energy.scenario_from_config`), and MARL at every fleet
size (``state_mode`` and ``mixer_mode``: above 256 devices ``"auto"``
takes the factored state and the set mixer, whose replay stores at most
``marl_agent_budget`` agents), with engine checkpoints and resume
(``checkpoint_dir``, ``checkpoint_every``, ``checkpoint_keep``,
``resume``; a sync checkpoint of the JAX package resumes here too).  A
fleet mesh (``fleet_mesh`` > 1) and an async JAX checkpoint raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict

from repro_torch.checkpoint.engine import (JAX_FORMAT, EngineCheckpointer,
                                           config_fingerprint)
from repro_torch.core.marl.buffer import ReplayBuffer
from repro_torch.core.selection import (OBS_DIM, GreedySelector,
                                        MarlSelector, RandomSelector,
                                        SelectorBase, StaticTierSelector,
                                        marl_state_dim, resolve_mixer_mode)
from repro_torch.device import resolve_device
from repro_torch.fl.engine import (RoundEngine, check_supported,
                                   sync_task_budget, uses_marl)
from repro_torch.models.family import get_family


@dataclasses.dataclass
class FLConfig:
    n_devices: int = 40
    n_rounds: int = 30
    participation: float = 0.10         # paper: 10% per round
    local_epochs: int = 5               # paper §5
    batch_size: int = 32                # paper §5
    lr: float = 0.05                    # paper §5
    alpha: float = 0.5                  # Dirichlet non-IID
    num_classes: int = 10
    n_train: int = 4000
    n_val_fraction: float = 0.04        # paper Table 2 optimum
    noise: float = 1.0
    hw: int = 16                        # image size
    width_mult: float = 0.25            # CNN slimming
    seed: int = 0
    model_family: str = "cnn"
    method: str = "drfl"                # drfl | heterofl | scalefl
    selector: str = "marl"              # marl | greedy | random | static
    reward_weights: tuple = (1000.0, 0.01, 1.0)
    marl_train_every: int = 2
    marl_updates_per_round: int = 2
    marl_episodes: int = 1              # selector pre-training episodes (the
                                        # reported run is the LAST episode)
    hotplug_round: int = 0
    hotplug_n: int = 0
    energy_scale: float = 1.0
    # energy scenarios (repro_torch.energy); these defaults are the
    # trivial scenario, which runs no scenario hook at all
    charge_profile: str = "constant"
    charge_rate: float = 0.0
    charge_period: float = 86400.0
    availability_profile: str = "always"
    availability_duty: float = 1.0
    global_budget_j: float = 0.0
    server_lr: float = 0.7              # damps layer-aligned update drift
    engine_mode: str = "sync"           # sync | async
    staleness_decay: float = 0.5
    async_eval_every: int = 1
    async_time_horizon: float = 0.0
    async_task_budget: int = 0
    client_executor: str = "auto"       # auto | perclient | batched
    state_mode: str = "auto"            # auto | flat | factored
    mixer_mode: str = "auto"            # auto | flat | set
    marl_agent_budget: int = 4096
    fleet_mesh: int = 0
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    checkpoint_keep: int = 3
    resume: bool = False
    fault_crashes: int = 0
    fault_timeouts: int = 0
    fault_disconnects: int = 0
    fault_corrupts: int = 0
    fault_horizon: float = 0.0
    fault_seed: int = -1
    task_deadline_factor: float = 4.0


def _make_selector(cfg: FLConfig, n_models: int, *,
                   device="cuda") -> SelectorBase:
    """The config's selector; HeteroFL and ScaleFL always take the greedy
    one, the paper's fair-comparison arm (``simulation.py:129-142``)."""
    if cfg.method in ("heterofl", "scalefl"):
        return GreedySelector()
    return {
        "marl": lambda: MarlSelector(
            cfg.n_devices + cfg.hotplug_n, n_models, cfg.n_rounds, cfg.seed,
            state_mode=cfg.state_mode, mixer_mode=cfg.mixer_mode,
            agent_budget=cfg.marl_agent_budget, device=device),
        "greedy": GreedySelector,
        "random": lambda: RandomSelector(cfg.seed),
        "static": lambda: StaticTierSelector(cfg.seed),
    }[cfg.selector]()


# replay-buffer obs storage budget (float32 elements), as the reference
_BUFFER_OBS_ELEMS = 2 ** 24


def _make_buffer(cfg: FLConfig) -> ReplayBuffer:
    """The replay buffer (``simulation.py:149-189``).  A sync episode has
    one step per round; an async one a step per ``select`` call: at most
    one per task plus one failed dispatch per completion or row boundary.
    Under the set mixer it stores at most ``marl_agent_budget`` agents.
    Capacity degrades below 64 episodes, with a warning, where the obs
    budget would be exceeded."""
    n_agents = cfg.n_devices + cfg.hotplug_n
    if cfg.engine_mode == "async":
        budget = int(cfg.async_task_budget or sync_task_budget(cfg))
        episode_len = 2 * budget + cfg.n_rounds + 8
    else:
        episode_len = cfg.n_rounds
    state_dim = marl_state_dim(cfg.state_mode, n_agents,
                               get_family(cfg.model_family).num_submodels())
    agent_budget = (int(cfg.marl_agent_budget)
                    if resolve_mixer_mode(cfg.mixer_mode, n_agents) == "set"
                    else None)
    stored_agents = (min(n_agents, agent_budget) if agent_budget
                     else n_agents)
    capacity = max(4, min(64, _BUFFER_OBS_ELEMS
                          // ((episode_len + 1) * stored_agents * OBS_DIM)))
    if capacity < 64:
        logging.getLogger(__name__).warning(
            "QMIX replay capacity degraded to %d episodes (episode_len=%d, "
            "stored agents=%d of %d, obs budget=%d elems); consider "
            "mixer_mode='set' / a smaller marl_agent_budget",
            capacity, episode_len, stored_agents, n_agents,
            _BUFFER_OBS_ELEMS)
    return ReplayBuffer(capacity, episode_len, n_agents, OBS_DIM, state_dim,
                        cfg.seed, agent_budget=agent_budget)


def load_resume_state(cfg: FLConfig):
    """The latest checkpoint in ``cfg.checkpoint_dir`` as (resume state,
    meta), or (None, None) where there is none
    (``simulation.py:228-244``): a config whose fingerprint differs from
    the checkpoint's raises ``ValueError`` ("refusing to resume"); a JAX
    package checkpoint is carried into the port's state
    (:func:`repro_torch.checkpoint.from_jax.resume_state_from_jax`)."""
    if not cfg.checkpoint_dir:
        raise ValueError("resume=True needs checkpoint_dir")
    ck = EngineCheckpointer(cfg.checkpoint_dir, keep=cfg.checkpoint_keep)
    latest = ck.latest()
    if latest is None:
        return None, None
    state, meta = ck.load(latest)
    fp = config_fingerprint(cfg)
    got = meta.get("fingerprint")
    if got != fp:
        raise ValueError(
            f"checkpoint fingerprint {got!r} does not match this config "
            f"({fp!r}); refusing to resume a different run")
    if meta["format"] == JAX_FORMAT:
        # imported here: the carrier imports the engine, whose package
        # imports this module
        from repro_torch.checkpoint.from_jax import resume_state_from_jax
        state = resume_state_from_jax(state, cfg)
    return state, meta


def run_simulation(cfg, verbose: bool = False, *,
                   device="cuda", halt_after_saves: int = 0) -> Dict:
    """Run the FL simulation of ``cfg`` (an :class:`FLConfig` or a
    :class:`repro_torch.fl.spec.SimulationSpec`, validated first) on
    ``device`` (the card unless the caller asks for ``"cpu"``; no silent
    fallback).  With DR-FL + MARL and
    ``marl_episodes > 1`` the earlier episodes pre-train the QMIX policy
    (fresh fleet and model each episode, persistent learner and replay)
    and the LAST episode is returned; every other arm runs one episode and
    keeps no replay (``simulation.py:234-262``).

    With ``cfg.checkpoint_dir`` and ``cfg.checkpoint_every`` the engine
    saves the whole run state on that cadence; with ``cfg.resume`` the
    latest checkpoint (this port's, or a sync one of the JAX package) is
    loaded (:func:`load_resume_state`), the episodes before its own are
    skipped, and its episode continues without ``reset_episode``: the
    history and weights equal an uninterrupted run's bit for bit.
    ``halt_after_saves=N`` (> 0) simulates a crash: ``CheckpointHalt``
    right after the N-th save of this call."""
    # imported here: the spec module imports this one for FLConfig
    from repro_torch.fl.spec import ensure_flat_config
    cfg = ensure_flat_config(cfg)
    dev = resolve_device(device)
    check_supported(cfg)
    resume_state = resume_meta = None
    if cfg.resume:
        resume_state, resume_meta = load_resume_state(cfg)
    halt = ({"remaining": int(halt_after_saves)} if halt_after_saves > 0
            else None)
    start_ep = int(resume_meta["episode"]) if resume_meta else 0
    selector = _make_selector(
        cfg, get_family(cfg.model_family).num_submodels(), device=dev)
    marl = uses_marl(cfg)
    buffer = _make_buffer(cfg) if marl else None
    episodes = cfg.marl_episodes if marl else 1
    hist = None
    for ep in range(start_ep, episodes):
        resuming = resume_state is not None and ep == start_ep
        if marl and not resuming:
            # a resumed episode's trace, hidden state and RNG come from the
            # checkpoint: a reset would fork the episode
            selector.reset_episode()
        engine = RoundEngine(cfg, selector, buffer,
                             verbose=verbose and ep == episodes - 1,
                             device=dev, episode=ep,
                             resume_state=resume_state if resuming else None,
                             halt_counter=halt)
        hist = engine.run()
        resume_state = None              # its episode consumed it
    return hist
