"""An async JAX run of the transformer family (width 0.25) continued in
the port, on both executors (``tests/test_torch_checkpoint_async_live.py``
says how): the bucketed arm's ``delta1`` row slices and the per-client
arm's dispatch-time weights carried leaf for leaf, the blocks' ``rmsnorm``
and causal ``flash_attention`` (their plain versions on the CPU) after
the resume.
"""
import pytest
import torch

from torch_live import BASE, assert_async_jax_checkpoint_resumes

torch.set_num_threads(1)

GREEDY = dict(engine_mode="async", selector="greedy")
TRANSFORMER = dict(GREEDY, model_family="transformer", width_mult=0.25)
ARMS = {
    "transformer-perclient": dict(TRANSFORMER, client_executor="perclient"),
    "transformer-batched": dict(TRANSFORMER, client_executor="batched"),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_async_jax_checkpoint_resumes_in_the_port(arm, tmp_path):
    assert_async_jax_checkpoint_resumes(dict(BASE, **ARMS[arm]), tmp_path,
                                        via_simulation=False)
