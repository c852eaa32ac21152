"""The port's LM configs, schedules and model registry against the JAX
package's: every field of all eleven configs, their smoke variants and
``reduced`` with overrides, the registry and input shapes, the train
config's defaults, the learning-rate schedules, ``adapt_for_shape``, and
``build``'s answer for each family (the ported families build; the
one the port has not ported, MoE, raises ``NotImplementedError``; an
unknown one the reference's ``ValueError``).  Pure data, no model runs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.launch.steps import adapt_for_shape as jax_adapt
from repro.models import build as jax_build
from repro.optim.schedules import make_schedule as jax_schedule
import repro_torch.configs as tcfgs
from repro_torch.launch.steps import adapt_for_shape
from repro_torch.models import api
from repro_torch.models.api import build
from repro_torch.optim.schedules import make_schedule

ALL = list(jcfgs.REGISTRY)


def _fields(cfg):
    return dataclasses.asdict(cfg)


def _derived(cfg):
    return (cfg.hd, cfg.is_decoder_only, cfg.param_count(),
            cfg.active_param_count())


@pytest.mark.parametrize("arch", ALL)
def test_config_equals_the_jax_config(arch):
    ours, theirs = tcfgs.get_config(arch), jcfgs.get_config(arch)
    assert _fields(ours) == _fields(theirs)
    assert _derived(ours) == _derived(theirs)
    s_ours, s_theirs = tcfgs.get_smoke_config(arch), \
        jcfgs.get_smoke_config(arch)
    assert _fields(s_ours) == _fields(s_theirs)
    assert _derived(s_ours) == _derived(s_theirs)


@pytest.mark.parametrize("over", [dict(num_kv_heads=2),
                                  dict(window=8, qk_norm=True),
                                  dict(attn_bias=True, mlp_bias=True,
                                       tie_embeddings=True)])
def test_reduced_with_overrides_equals_jax(over):
    for arch in ALL:
        assert _fields(tcfgs.reduced(tcfgs.get_config(arch), **over)) == \
            _fields(jcfgs.reduced(jcfgs.get_config(arch), **over))


def test_registry_shapes_and_train_defaults_equal_jax():
    assert tcfgs.list_archs() == jcfgs.list_archs()
    assert tcfgs.REGISTRY == jcfgs.REGISTRY
    assert {k: _fields(v) for k, v in tcfgs.INPUT_SHAPES.items()} == \
        {k: _fields(v) for k, v in jcfgs.INPUT_SHAPES.items()}
    assert _fields(tcfgs.TrainConfig()) == _fields(jcfgs.TrainConfig())
    with pytest.raises(KeyError) as ours:
        tcfgs.get_config("gpt-5")
    with pytest.raises(KeyError) as theirs:
        jcfgs.get_config("gpt-5")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kind", ["constant", "linear", "cosine"])
def test_schedule_equals_jax(kind):
    """float32 on both sides, rtol 1e-6; plus an absolute base_lr x 2^-23
    for the cosine, whose float32 ``cos`` may round one unit apart in XLA
    and ATen: near the end of the decay, 1 + cos(pi frac) cancels and
    that unit is all that is left."""
    ours, theirs = (make_schedule(kind, 3e-4, 10, 50),
                    jax_schedule(kind, 3e-4, 10, 50))
    steps = list(range(0, 60))
    got = np.array([float(ours(s)) for s in steps], np.float32)
    ref = np.array([float(theirs(jnp.int32(s))) for s in steps], np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=3e-4 * 2.0 ** -23)
    assert ours(0).dtype == torch.float32 and float(ours(0)) > 0


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule("step", 1e-3, 1, 10)


@pytest.mark.parametrize("shape", list(jcfgs.INPUT_SHAPES))
def test_adapt_for_shape_equals_jax(shape):
    for arch in ALL:
        ours = adapt_for_shape(tcfgs.get_config(arch),
                               tcfgs.INPUT_SHAPES[shape])
        theirs = jax_adapt(jcfgs.get_config(arch), jcfgs.INPUT_SHAPES[shape])
        assert _fields(ours) == _fields(theirs)


@pytest.mark.parametrize("arch", ALL)
def test_build_ports_the_dense_family(arch):
    """Every LM family of the reference (dense, moe, ssm, mamba-hybrid,
    vlm, audio) builds in both packages with the same ``sub_quadratic``
    (the moe family, once refused, too: mixtral's window makes it
    sub-quadratic, qwen3-moe is not); a family neither knows (the ResNet
    config's ``cnn``) raises the reference's ``ValueError``."""
    assert not hasattr(api, "UNPORTED_FAMILIES")
    cfg = tcfgs.get_smoke_config(arch)
    if cfg.family in ("dense", "moe", "ssm", "mamba-hybrid", "vlm",
                      "audio"):
        assert build(cfg).sub_quadratic == \
            jax_build(jcfgs.get_smoke_config(arch)).sub_quadratic
        if cfg.family == "moe":
            assert build(cfg).sub_quadratic == (cfg.window > 0)
    else:
        with pytest.raises(ValueError) as ours:
            build(cfg)
        with pytest.raises(ValueError) as theirs:
            jax_build(jcfgs.get_smoke_config(arch))
        assert str(ours.value) == str(theirs.value)
