from repro_torch.sharding.fleet import (FLEET_AXIS, FLEET_RULES,  # noqa: F401
                                        fleet_mesh, fleet_shardings,
                                        fleet_spec_for, is_sharded,
                                        maybe_shard_fleet, shard_agent_array,
                                        shard_fleet, unshard_fleet)
