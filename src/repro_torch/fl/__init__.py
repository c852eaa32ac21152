from repro_torch.fl.simulation import FLConfig, run_simulation  # noqa: F401
from repro_torch.fl.spec import (EnergySpec, EngineSpec,  # noqa: F401
                                 MarlSpec, ModelSpec, ResilienceSpec,
                                 SimulationSpec, ensure_flat_config)
from repro_torch.fl.engine import (RoundEngine, build_world,  # noqa: F401
                                   resolve_client_executor,
                                   sync_task_budget)
from repro_torch.energy import (EnergyScenario,  # noqa: F401
                                known_availability_profiles,
                                known_charge_profiles,
                                register_availability_profile,
                                register_charge_profile,
                                scenario_from_config)
from repro_torch.fl.environment import FLEnv, FLEnvConfig  # noqa: F401
from repro_torch.fl.faults import FaultEvent, FaultPlan  # noqa: F401
from repro_torch.core.fleet import (FleetState, fleet_summary,  # noqa: F401
                                    make_fleet_state, sample_fleet_state,
                                    summary_width)
from repro_torch.core.selection import (marl_state_dim,  # noqa: F401
                                        resolve_state_mode)
from repro_torch.models.family import (ModelFamily,  # noqa: F401
                                       get_family, known_families,
                                       register_family, resolve_family)
