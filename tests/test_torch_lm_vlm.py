"""The port's Llama-3.2-Vision-style VLM (``models/vlm.py``, the ``vlm``
family) against the JAX package's, at llama-3.2-vision-11b's smoke config
(2 layers = 1 group of 1 self layer and 1 gated cross layer, d 256, 4
heads of 64, 16 stub image tokens): ``group_shape``; the cross layer with
nonzero gates; ``apply`` and ``logits`` under a full and two partial layer
masks; ``apply`` without ``image_embeds``; the prefill step on the kernel
route; the cross K/V cache and 12 decode steps against the JAX decode and
the port's own forward; the remat modes; two train steps; the slot
server's tokens; and ``lm_params_from_jax`` on the bf16 tree, whose gates
stay float32.

The JAX functions run under ``jit`` (its Pallas attention in interpret
mode under ``use_pallas``); the params (the gates drawn nonzero: at the
init's zeros the cross layer adds nothing) and the image embeddings are
numpy draws (``tests/torch_lm.py``), fed to both packages.  Tolerances:
float32 rtol/atol 1e-5, decode and the kernel route atol 2e-4 rtol 1e-3,
losses and grad norms rtol 1e-5, served tokens equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.launch.steps import build_prefill_step as jax_prefill_step
from repro.models import build as jax_build
from repro.models import vlm as jv
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import vlm
from repro_torch.models.api import build
from repro_torch.models.transformer import _unstack
from repro_torch.tree import tree_leaves
from torch_lm import (DECODE, F32, as_jax, as_torch,
                      assert_forward_matches_jax, assert_trained_like_jax,
                      assert_trees_close, bf16_tree, both_params, configs,
                      decode_runs, extras_np, remat_outputs, served_tokens,
                      tokens, train_runs)

torch.set_num_threads(1)
ARCH = "llama-3.2-vision-11b"


@functools.lru_cache(maxsize=None)
def _inputs(seed=2):
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, seed=seed)
    return jcfg, tcfg, jp, tp, extras_np(jcfg, 2)


@pytest.mark.parametrize("over", [{}, {"num_layers": 40,
                                       "cross_attn_every": 5}],
                         ids=["smoke", "full depth"])
def test_group_shape_equals_jax(over):
    jcfg, tcfg = configs(ARCH, **over)
    assert vlm.group_shape(tcfg) == jv.group_shape(jcfg) == (
        (1, 1) if not over else (8, 4))


def test_cross_block_matches_jax():
    """The gated cross layer on the first group's params, its gates
    nonzero, over 16 image tokens."""
    jcfg, tcfg, jp, tp, ex = _inputs()
    jcp = jax.tree.map(lambda a: a[0], jp["cross_blocks"])
    tcp = _unstack(tp["cross_blocks"], 1)[0]
    assert float(tcp["gate_attn"]) != 0.0 and float(tcp["gate_mlp"]) != 0.0
    x = np.random.default_rng(3).normal(size=(2, 32, 256)).astype(np.float32)
    img = ex["image_embeds"]
    ref, _ = jax.jit(lambda p, a, i: jv.cross_block_apply(
        p, jcfg, a, i, jnp.float32(1.0)))(jcp, x, img)
    got = vlm.cross_block_apply(tcp, tcfg, torch.from_numpy(x),
                                torch.from_numpy(img), torch.tensor(1.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    assert not np.allclose(got.numpy(), x, atol=1e-3)


@pytest.mark.parametrize("mask", [[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]],
                         ids=["full", "no cross layer", "no self layer"])
def test_apply_and_logits_match_jax(mask):
    """The mask, read as (groups, self layers + 1), gates the self layer
    and the cross layer of the one group."""
    assert_forward_matches_jax(ARCH, np.array(mask, np.float32))


def test_apply_without_image_embeds_raises_like_jax():
    jcfg, tcfg, jp, tp, _ = _inputs()
    toks = tokens(jcfg, 2, 8)
    with pytest.raises(KeyError, match="image_embeds"):
        jax_build(jcfg).apply(jp, jnp.asarray(toks))
    with pytest.raises(KeyError, match="image_embeds"):
        build(tcfg).apply(tp, torch.from_numpy(toks))


def test_prefill_step_kernel_route_matches_jax():
    """``build_prefill_step``'s last-position logits, B 2 x S 32, with
    ``use_pallas=True``: the JAX Pallas kernel in interpret mode at the
    self layer against the port's kernel wrapper, which takes its plain
    version on CPU tensors; the image embeddings ride the batch."""
    jcfg, tcfg, jp, tp, ex = _inputs()
    toks = tokens(jcfg, 2, 32, seed=6)
    _, jstep = jax_prefill_step(jcfg, JaxTrainConfig(use_pallas=True))
    ref = jax.jit(jstep)(jp, {"tokens": jnp.asarray(toks), **as_jax(ex)})
    _, step = build_prefill_step(tcfg, TrainConfig(use_pallas=True))
    got = step(tp, {"tokens": torch.from_numpy(toks), **as_torch(ex)})
    assert got.shape == (2, 1, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DECODE)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_decode_cache_matches_jax(qk_norm):
    """``decode_init``: the self caches [G, n_self, B, clen, Hkv, hd]
    zero, each group's cross K/V of the image tokens equal the JAX
    package's (``k_norm`` applied under ``qk_norm``); with no image both
    take zeros."""
    jcfg, tcfg = configs(ARCH, qk_norm=qk_norm)
    jp, tp = both_params(jcfg, seed=4)
    ex = extras_np(jcfg, 2)
    jm, m = jax_build(jcfg), build(tcfg)
    for given in (ex, {}):
        jc = jm.decode_init(jp, 2, 16, extras=as_jax(given))
        c = m.decode_init(tp, 2, 16, extras=as_torch(given))
        assert c["cross"]["k"].shape == (1, 2, 16, 4, 64)
        assert c["self"]["k"].shape == (1, 1, 2, 16, 4, 64)
        assert c["self"]["pos"].shape == (1, 1)
        assert_trees_close([c["cross"]["k"], c["cross"]["v"]],
                           [jc["cross"]["k"], jc["cross"]["v"]])


def test_decode_matches_jax_and_the_forward():
    got, jgot, ref, cache = decode_runs(ARCH)
    np.testing.assert_allclose(got, ref, **DECODE)
    np.testing.assert_allclose(got, jgot, **F32)
    assert cache["self"]["pos"].tolist() == [[12]]


def test_remat_modes_give_the_same_numbers():
    """The whole group is recomputed under ``full`` (the reference's
    ``jax.checkpoint`` has no policy, so ``dots`` is ``full``): hidden
    states and gradients equal ``none``'s bit for bit.  The init's zero
    gates still pass gradients to the gates (d tanh(0) = 1)."""
    outs = remat_outputs(ARCH)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.fixture(scope="module")
def trained():
    return train_runs(ARCH)


def test_two_train_steps_match_jax(trained):
    """Also: the gates stay float32 scalars through the in-place AdamW."""
    assert_trained_like_jax(trained)
    tp = trained["params"][1]
    assert tp["cross_blocks"]["gate_attn"].dtype == torch.float32
    assert tp["cross_blocks"]["gate_mlp"].shape == (1,)


def test_slot_server_serves_the_jax_tokens():
    outs = served_tokens(ARCH)
    assert outs["port"] == outs["jax"]


def test_lm_params_from_jax_carries_the_vlm_tree():
    """The VLM's bf16 tree: ``self_blocks`` [G, n_self, ...] and
    ``cross_blocks`` [G, ...] arrive leaf for leaf, the gates float32 and
    the rest bf16; both packages' bf16 forwards then agree at the bf16
    tolerance."""
    jcfg, tcfg = configs(ARCH, dtype="bfloat16")
    jp = bf16_tree(jcfg)
    tp = lm_params_from_jax(jp)
    assert {k for k, v in tp["cross_blocks"].items()
            if not isinstance(v, dict) and v.dtype == torch.float32} == \
        {"gate_attn", "gate_mlp"}
    assert tp["self_blocks"]["attn"]["wq"]["w"].shape == (1, 1, 256, 256)
    assert tp["cross_blocks"]["mlp"]["w_up"]["w"].shape == (1, 256, 512)
    jl = jax.tree_util.tree_leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, t in zip(jl, tree_leaves(tp)):
        assert str(t.dtype) == "torch." + a.dtype.name
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    toks = tokens(jcfg, 2, 16, seed=9)
    ex = extras_np(jcfg, 2)
    jhid, _ = jax.jit(functools.partial(jax_build(jcfg).apply, remat="none"))(
        jp, jnp.asarray(toks), as_jax(ex))
    h, _ = build(tcfg).apply(tp, torch.from_numpy(toks), as_torch(ex),
                             remat="none")
    ref = np.asarray(jhid, np.float32)
    assert np.abs(h.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
