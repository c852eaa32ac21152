"""Typed ``SimulationSpec`` layer over the flat :class:`FLConfig` — port
of ``repro.fl.spec``, with the same checks and the same messages.

``SimulationSpec`` groups ``FLConfig``'s knobs into typed sub-specs,
each validated in ``__post_init__`` (a bad knob raises ``ValueError``):

* :class:`ModelSpec`  — which registered family to train
  (:mod:`repro_torch.models.family`) and the local-training knobs;
* :class:`EngineSpec` — sync/async mode, staleness decay, async budgets,
  client-update executor, fleet sharding mesh;
* :class:`MarlSpec`   — dual-selection strategy, QMIX training cadence,
  global-state and mixer modes;
* :class:`EnergySpec` — battery scaling, hot-plug and the energy
  scenarios (:mod:`repro_torch.energy`'s registries);
* :class:`ResilienceSpec` — checkpoint cadence and seeded faults.

``from_flat`` / ``to_flat`` bridge the two forms exactly
(``to_flat(from_flat(cfg)) == cfg`` for every valid flat config), and
:func:`ensure_flat_config` is what ``run_simulation`` validates either
form through, before any device work::

    from repro_torch.fl import (SimulationSpec, ModelSpec, MarlSpec,
                                run_simulation)
    spec = SimulationSpec(n_devices=64, n_rounds=10,
                          model=ModelSpec(family="mlp"),
                          marl=MarlSpec(selector="greedy"))
    hist = run_simulation(spec)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.selection import MIXER_MODES as _CONCRETE_MIXER_MODES
from repro_torch.core.selection import STATE_MODES as _CONCRETE_STATE_MODES
from repro_torch.fl.simulation import FLConfig
from repro_torch.models.family import get_family, known_families

METHODS = ("drfl", "heterofl", "scalefl")
SELECTORS = ("marl", "greedy", "random", "static")
ENGINE_MODES = ("sync", "async")
CLIENT_EXECUTORS = ("auto", "perclient", "batched")
# config level adds "auto" on top of the selector's concrete modes, so a
# mode added in core.selection is accepted here automatically
STATE_MODES = ("auto",) + _CONCRETE_STATE_MODES
MIXER_MODES = ("auto",) + _CONCRETE_MIXER_MODES


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


def _check_choice(value, choices, field):
    _check(value in choices,
           f"{field}={value!r} is not one of {', '.join(choices)}")


@dataclasses.dataclass
class ModelSpec:
    """What each client trains: a registered model family + local knobs."""
    family: str = "cnn"                 # models.family registry key
    width_mult: float = 0.25            # backbone slimming (CPU budget)
    hw: int = 16                        # image size
    num_classes: int = 10
    local_epochs: int = 5               # paper §5
    batch_size: int = 32                # paper §5
    lr: float = 0.05                    # paper §5

    def __post_init__(self):
        _check_choice(self.family, known_families(), "model.family")
        _check(self.width_mult > 0, "model.width_mult must be > 0")
        _check(self.hw >= 1, "model.hw must be >= 1")
        _check(self.num_classes >= 2, "model.num_classes must be >= 2")
        _check(self.local_epochs >= 1, "model.local_epochs must be >= 1")
        _check(self.batch_size >= 1, "model.batch_size must be >= 1")
        _check(self.lr > 0, "model.lr must be > 0")


@dataclasses.dataclass
class EngineSpec:
    """Round scheduling (fl.engine) + client-update executor."""
    mode: str = "sync"                  # sync | async
    client_executor: str = "auto"       # auto | perclient | batched
    staleness_decay: float = 0.5        # FedAsync (1+s)^-decay
    async_eval_every: int = 1
    async_time_horizon: float = 0.0     # sim-seconds (0 = task budget)
    async_task_budget: int = 0          # client tasks (0 = sync-equivalent)
    fleet_mesh: int = 0                 # FleetState shards (0/1 off, -1 all)

    def __post_init__(self):
        _check_choice(self.mode, ENGINE_MODES, "engine.mode")
        _check_choice(self.client_executor, CLIENT_EXECUTORS,
                      "engine.client_executor")
        _check(self.staleness_decay >= 0,
               "engine.staleness_decay must be >= 0")
        _check(self.async_eval_every >= 1,
               "engine.async_eval_every must be >= 1")
        _check(self.async_time_horizon >= 0,
               "engine.async_time_horizon must be >= 0")
        _check(self.async_task_budget >= 0,
               "engine.async_task_budget must be >= 0")
        _check(self.fleet_mesh >= -1,
               "engine.fleet_mesh must be >= -1 (-1 = all local devices)")


@dataclasses.dataclass
class MarlSpec:
    """Dual-selection strategy + QMIX training cadence (paper §4.3)."""
    selector: str = "marl"              # marl | greedy | random | static
    reward_weights: Tuple[float, float, float] = (1000.0, 0.01, 1.0)
    train_every: int = 2
    updates_per_round: int = 2
    episodes: int = 1                   # selector pre-training episodes
    state_mode: str = "auto"            # auto | flat | factored QMIX state
    mixer_mode: str = "auto"            # auto | flat | set QMIX mixer
    agent_budget: int = 4096            # sampled-agent replay cap (set mixer)

    def __post_init__(self):
        _check_choice(self.selector, SELECTORS, "marl.selector")
        _check_choice(self.state_mode, STATE_MODES, "marl.state_mode")
        _check_choice(self.mixer_mode, MIXER_MODES, "marl.mixer_mode")
        _check(len(tuple(self.reward_weights)) == 3,
               "marl.reward_weights must have exactly 3 entries (w1,w2,w3)")
        _check(self.train_every >= 1, "marl.train_every must be >= 1")
        _check(self.updates_per_round >= 0,
               "marl.updates_per_round must be >= 0")
        _check(self.episodes >= 1, "marl.episodes must be >= 1")
        _check(self.agent_budget >= 1, "marl.agent_budget must be >= 1")


@dataclasses.dataclass
class EnergySpec:
    """Battery scaling, the paper's §4.2 hot-plug scenario, and the
    energy scenarios (:mod:`repro_torch.energy`): harvesting charge
    profiles, availability waves, and the fleet-wide joule budget.  The
    profile defaults are the trivial scenario."""
    scale: float = 1.0                  # scales batteries to stress budgets
    hotplug_round: int = 0
    hotplug_n: int = 0
    charge_profile: str = "constant"    # energy charge registry key
    charge_rate: float = 0.0            # fleet-mean harvest amplitude, J/s
    charge_period: float = 86400.0      # profile day length, sim-seconds
    availability_profile: str = "always"  # availability registry key
    availability_duty: float = 1.0      # fraction of the local day online
    global_budget_j: float = 0.0        # fleet-wide joule budget (0 = off)

    def __post_init__(self):
        from repro_torch.energy import (known_availability_profiles,
                                        known_charge_profiles)
        _check(self.scale > 0, "energy.scale must be > 0")
        _check(self.hotplug_round >= 0,
               "energy.hotplug_round must be >= 0")
        _check(self.hotplug_n >= 0, "energy.hotplug_n must be >= 0")
        _check_choice(self.charge_profile, known_charge_profiles(),
                      "energy.charge_profile")
        _check_choice(self.availability_profile,
                      known_availability_profiles(),
                      "energy.availability_profile")
        _check(self.charge_rate >= 0, "energy.charge_rate must be >= 0")
        _check(self.charge_period > 0, "energy.charge_period must be > 0")
        _check(0 < self.availability_duty <= 1,
               "energy.availability_duty must be in (0, 1]")
        _check(self.global_budget_j >= 0,
               "energy.global_budget_j must be >= 0")


@dataclasses.dataclass
class ResilienceSpec:
    """Crash safety: engine checkpoint/resume cadence + seeded fault
    injection (:mod:`repro_torch.checkpoint`, :mod:`repro_torch.fl.faults`)."""
    checkpoint_dir: str = ""            # empty = checkpointing off
    checkpoint_every: int = 0           # save every N (virtual) rounds
    checkpoint_keep: int = 3            # manifests kept before rotation
    resume: bool = False                # resume from latest manifest
    fault_crashes: int = 0              # seeded churn counts (async only)
    fault_timeouts: int = 0
    fault_disconnects: int = 0
    fault_corrupts: int = 0
    fault_horizon: float = 0.0          # event window (0 = async horizon)
    fault_seed: int = -1                # -1 = reuse the run seed
    task_deadline_factor: float = 4.0   # lost-task reap at factor * t_cost

    def n_faults(self) -> int:
        return (self.fault_crashes + self.fault_timeouts
                + self.fault_disconnects + self.fault_corrupts)

    def __post_init__(self):
        _check(self.checkpoint_every >= 0,
               "resilience.checkpoint_every must be >= 0")
        _check(self.checkpoint_keep >= 1,
               "resilience.checkpoint_keep must be >= 1")
        for f in ("fault_crashes", "fault_timeouts", "fault_disconnects",
                  "fault_corrupts"):
            _check(getattr(self, f) >= 0, f"resilience.{f} must be >= 0")
        _check(self.fault_horizon >= 0,
               "resilience.fault_horizon must be >= 0")
        _check(self.task_deadline_factor > 1,
               "resilience.task_deadline_factor must be > 1 (a deadline at "
               "or before the task's own completion would reap live work)")
        _check(not self.resume or self.checkpoint_dir,
               "resilience.resume needs checkpoint_dir")


@dataclasses.dataclass
class SimulationSpec:
    """One cell of the paper's experiment grid, fully typed + validated."""
    n_devices: int = 40
    n_rounds: int = 30
    participation: float = 0.10         # paper: 10% per round
    method: str = "drfl"                # drfl | heterofl | scalefl
    seed: int = 0
    server_lr: float = 0.7
    # data (synthetic CIFAR-like shards)
    n_train: int = 4000
    alpha: float = 0.5                  # Dirichlet non-IID
    n_val_fraction: float = 0.04        # paper Table 2 optimum
    noise: float = 1.0
    # nested sub-specs
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    engine: EngineSpec = dataclasses.field(default_factory=EngineSpec)
    marl: MarlSpec = dataclasses.field(default_factory=MarlSpec)
    energy: EnergySpec = dataclasses.field(default_factory=EnergySpec)
    resilience: ResilienceSpec = dataclasses.field(
        default_factory=ResilienceSpec)

    def __post_init__(self):
        _check(self.n_devices >= 1, "n_devices must be >= 1")
        _check(self.n_rounds >= 1, "n_rounds must be >= 1")
        _check(0 < self.participation <= 1,
               "participation must be in (0, 1]")
        _check_choice(self.method, METHODS, "method")
        _check(self.server_lr > 0, "server_lr must be > 0")
        _check(self.n_train >= 1, "n_train must be >= 1")
        _check(self.alpha > 0, "alpha must be > 0")
        _check(0 < self.n_val_fraction < 1,
               "n_val_fraction must be in (0, 1)")
        _check(self.noise >= 0, "noise must be >= 0")
        family = get_family(self.model.family)
        _check(family.supports(self.method),
               f"model family {family.name!r} does not support "
               f"method {self.method!r} (supported: "
               f"{', '.join(family.supported_methods)})")
        if self.resilience.n_faults():
            _check(self.engine.mode == "async",
                   "fault injection rides the async event timeline: "
                   "fault_* counts need engine.mode='async'")
            _check(self.resilience.fault_horizon > 0
                   or self.engine.async_time_horizon > 0,
                   "fault injection needs a time window: set "
                   "resilience.fault_horizon or engine.async_time_horizon")

    # -- bridges ----------------------------------------------------------
    @classmethod
    def from_flat(cls, cfg: FLConfig) -> "SimulationSpec":
        """Lift a flat :class:`FLConfig` into the typed spec (validating
        it); ``to_flat`` inverts this bit-for-bit."""
        return cls(
            n_devices=cfg.n_devices, n_rounds=cfg.n_rounds,
            participation=cfg.participation, method=cfg.method,
            seed=cfg.seed, server_lr=cfg.server_lr, n_train=cfg.n_train,
            alpha=cfg.alpha, n_val_fraction=cfg.n_val_fraction,
            noise=cfg.noise,
            model=ModelSpec(
                family=cfg.model_family, width_mult=cfg.width_mult,
                hw=cfg.hw, num_classes=cfg.num_classes,
                local_epochs=cfg.local_epochs, batch_size=cfg.batch_size,
                lr=cfg.lr),
            engine=EngineSpec(
                mode=cfg.engine_mode, client_executor=cfg.client_executor,
                staleness_decay=cfg.staleness_decay,
                async_eval_every=cfg.async_eval_every,
                async_time_horizon=cfg.async_time_horizon,
                async_task_budget=cfg.async_task_budget,
                fleet_mesh=cfg.fleet_mesh),
            marl=MarlSpec(
                selector=cfg.selector, reward_weights=cfg.reward_weights,
                train_every=cfg.marl_train_every,
                updates_per_round=cfg.marl_updates_per_round,
                episodes=cfg.marl_episodes,
                state_mode=cfg.state_mode,
                mixer_mode=cfg.mixer_mode,
                agent_budget=cfg.marl_agent_budget),
            energy=EnergySpec(
                scale=cfg.energy_scale, hotplug_round=cfg.hotplug_round,
                hotplug_n=cfg.hotplug_n,
                charge_profile=cfg.charge_profile,
                charge_rate=cfg.charge_rate,
                charge_period=cfg.charge_period,
                availability_profile=cfg.availability_profile,
                availability_duty=cfg.availability_duty,
                global_budget_j=cfg.global_budget_j),
            resilience=ResilienceSpec(
                checkpoint_dir=cfg.checkpoint_dir,
                checkpoint_every=cfg.checkpoint_every,
                checkpoint_keep=cfg.checkpoint_keep,
                resume=cfg.resume,
                fault_crashes=cfg.fault_crashes,
                fault_timeouts=cfg.fault_timeouts,
                fault_disconnects=cfg.fault_disconnects,
                fault_corrupts=cfg.fault_corrupts,
                fault_horizon=cfg.fault_horizon,
                fault_seed=cfg.fault_seed,
                task_deadline_factor=cfg.task_deadline_factor))

    def to_flat(self) -> FLConfig:
        """Lower to the flat compatibility surface consumed by the engine."""
        return FLConfig(
            n_devices=self.n_devices, n_rounds=self.n_rounds,
            participation=self.participation,
            local_epochs=self.model.local_epochs,
            batch_size=self.model.batch_size, lr=self.model.lr,
            alpha=self.alpha, num_classes=self.model.num_classes,
            n_train=self.n_train, n_val_fraction=self.n_val_fraction,
            noise=self.noise, hw=self.model.hw,
            width_mult=self.model.width_mult, seed=self.seed,
            model_family=self.model.family, method=self.method,
            selector=self.marl.selector,
            reward_weights=self.marl.reward_weights,
            marl_train_every=self.marl.train_every,
            marl_updates_per_round=self.marl.updates_per_round,
            marl_episodes=self.marl.episodes,
            hotplug_round=self.energy.hotplug_round,
            hotplug_n=self.energy.hotplug_n,
            energy_scale=self.energy.scale,
            charge_profile=self.energy.charge_profile,
            charge_rate=self.energy.charge_rate,
            charge_period=self.energy.charge_period,
            availability_profile=self.energy.availability_profile,
            availability_duty=self.energy.availability_duty,
            global_budget_j=self.energy.global_budget_j,
            server_lr=self.server_lr,
            engine_mode=self.engine.mode,
            staleness_decay=self.engine.staleness_decay,
            async_eval_every=self.engine.async_eval_every,
            async_time_horizon=self.engine.async_time_horizon,
            async_task_budget=self.engine.async_task_budget,
            client_executor=self.engine.client_executor,
            state_mode=self.marl.state_mode,
            mixer_mode=self.marl.mixer_mode,
            marl_agent_budget=self.marl.agent_budget,
            fleet_mesh=self.engine.fleet_mesh,
            checkpoint_dir=self.resilience.checkpoint_dir,
            checkpoint_every=self.resilience.checkpoint_every,
            checkpoint_keep=self.resilience.checkpoint_keep,
            resume=self.resilience.resume,
            fault_crashes=self.resilience.fault_crashes,
            fault_timeouts=self.resilience.fault_timeouts,
            fault_disconnects=self.resilience.fault_disconnects,
            fault_corrupts=self.resilience.fault_corrupts,
            fault_horizon=self.resilience.fault_horizon,
            fault_seed=self.resilience.fault_seed,
            task_deadline_factor=self.resilience.task_deadline_factor)


def ensure_flat_config(cfg) -> FLConfig:
    """Accept a :class:`SimulationSpec` or :class:`FLConfig`, validate,
    and return the flat config the engine runs on.

    Flat configs round-trip through :meth:`SimulationSpec.from_flat` purely
    for validation — the ORIGINAL object is returned, so the flat path
    stays bit-for-bit (`==` and identity) what the caller built."""
    if isinstance(cfg, SimulationSpec):
        return cfg.to_flat()
    if isinstance(cfg, FLConfig):
        SimulationSpec.from_flat(cfg)      # validation only
        return cfg
    raise TypeError(f"expected SimulationSpec or FLConfig, got "
                    f"{type(cfg).__name__}")
