"""An async JAX run continued in the port: the JAX package's async engine
is killed right after its first virtual round's checkpoint save, the
manifest is loaded by the port and carried into its resume state
(:func:`repro_torch.checkpoint.from_jax.resume_state_from_jax`: the
in-flight tasks' JAX-layout delta rows and dispatch-time weights
converted), and the port runs the rest on the CPU.  The result is held to
the JAX package's uninterrupted run by ``tests/torch_live.py``'s async
checks: the event record identical (task log, staleness, termination,
hot-plug, fault outcomes), weights, energy and reward at its tolerances.

This file holds the CNN's per-client arms, at the live tests' size
(``torch_live.BASE``: n 8, width 0.125, 8x8), each task's dispatch-time
weights carried in ``params_table``: greedy through the port's own
``run_simulation(resume=True)``; MARL with ε = 0 on both sides (the JAX
act key has no torch counterpart); and hot-plug under a seeded fault
plan, where the checkpoint holds a task lost to a crash whose reap, and
the join, come after the resume.  The bucketed arms are in
``tests/test_torch_checkpoint_async_batched.py`` and the transformer's in
``tests/test_torch_checkpoint_async_transformer.py`` (one file each, as
each pays its own JAX compiles).
"""
import pytest
import torch

from torch_live import BASE, assert_async_jax_checkpoint_resumes

torch.set_num_threads(1)

GREEDY = dict(engine_mode="async", selector="greedy")
ARMS = {
    "perclient-greedy": dict(GREEDY, client_executor="perclient"),
    "marl": dict(engine_mode="async", n_devices=6,
                 client_executor="perclient"),
    # tests/test_torch_async.py's hot-plug arm, 3 rounds, with one crash
    # and one corrupt delta in the first 40 sim-seconds
    "hotplug-faults": dict(GREEDY, n_devices=5, participation=0.6,
                           n_rounds=3, seed=4, hotplug_round=2, hotplug_n=3,
                           energy_scale=0.5, client_executor="perclient",
                           fault_horizon=40.0, fault_crashes=1,
                           fault_corrupts=1),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_async_jax_checkpoint_resumes_in_the_port(arm, tmp_path):
    kw = dict(BASE, **ARMS[arm])
    _, th = assert_async_jax_checkpoint_resumes(
        kw, tmp_path, via_simulation=arm == "perclient-greedy")
    if arm == "hotplug-faults":
        assert th["hotplug"]["vround"] >= 1 and th["faults"]["n_reaped"]
