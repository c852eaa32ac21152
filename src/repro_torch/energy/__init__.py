"""Energy scenarios — port of ``repro.energy``: charge (harvesting) and
availability profiles and the fleet-wide joule budget, driving
:class:`repro_torch.core.fleet.FleetState` through time.

* :class:`ChargeProfile` / :class:`AvailabilityProfile`: the profile
  protocols (pure ``[n]`` tensor functions of ``(fleet, sim_time)``, with
  numpy twins for the host).
* ``register_charge_profile`` / ``get_charge_profile`` /
  ``known_charge_profiles``, and the ``*_availability_profile`` trio: the
  registries.
* :class:`EnergyScenario`: one run's resolved scenario, its per-device
  profile arrays, the global budget and the trivial-path predicates that
  keep the default configuration free of any scenario work.
* :func:`scenario_from_config`: the scenario a flat ``FLConfig`` asks for.
"""
from repro_torch.energy.profiles import (AvailabilityProfile, ChargeProfile,
                                         EnergyScenario,
                                         get_availability_profile,
                                         get_charge_profile,
                                         known_availability_profiles,
                                         known_charge_profiles,
                                         register_availability_profile,
                                         register_charge_profile,
                                         scenario_from_config)

__all__ = [
    "AvailabilityProfile", "ChargeProfile", "EnergyScenario",
    "get_availability_profile", "get_charge_profile",
    "known_availability_profiles", "known_charge_profiles",
    "register_availability_profile", "register_charge_profile",
    "scenario_from_config",
]
