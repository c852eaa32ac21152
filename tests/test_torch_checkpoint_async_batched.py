"""An async JAX run of the bucketed executor continued in the port
(``tests/test_torch_checkpoint_async_live.py`` says how): each in-flight
task's ``delta1``, its bucket's ``[1, ...]`` row slice in the JAX layout,
is carried with the CNN's convolutions taken from HWIO to OIHW behind the
participant axis, and aggregated after the resume through ``layer_agg``'s
plain version.  A transpose on the wrong axis would give a model that
runs and ends wrong: the final weights are held to the JAX package's
uninterrupted run.
"""
import pytest
import torch

from torch_live import BASE, assert_async_jax_checkpoint_resumes

torch.set_num_threads(1)

GREEDY = dict(engine_mode="async", selector="greedy")
ARMS = {
    "batched-greedy": dict(GREEDY, client_executor="batched"),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_async_jax_checkpoint_resumes_in_the_port(arm, tmp_path):
    kw = dict(BASE, **ARMS[arm])
    _, th = assert_async_jax_checkpoint_resumes(kw, tmp_path,
                                                via_simulation=False)
    assert th["executor"] == "batched"
