"""The port's Whisper-style encoder-decoder (``models/encdec.py``, the
``audio`` family) against the JAX package's, at whisper-medium's smoke
config (2 encoder and 2 decoder layers, d 256, 4 heads of 64, biases on,
32 stub audio frames): ``encode``; ``apply`` and ``logits`` under a full
and a partial decoder mask; ``apply`` without ``audio_frames``; the
prefill step on the kernel route; the cross K/V cache and 12 decode steps
against the JAX decode and the port's own forward; the remat modes; two
train steps; the slot server's tokens; and ``lm_params_from_jax`` on the
bf16 tree.

The JAX functions run under ``jit`` (its Pallas attention in interpret
mode under ``use_pallas``); the params and the audio frames are numpy
draws (``tests/torch_lm.py``), fed to both packages.  Tolerances:
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
from repro.models import encdec as je
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import encdec
from repro_torch.models.api import build
from repro_torch.tree import tree_leaves
from torch_lm import (DECODE, F32, as_jax, as_torch,
                      assert_forward_matches_jax, assert_trained_like_jax,
                      assert_trees_close, bf16_tree, both_params, configs,
                      decode_runs, extras_np, remat_outputs, served_tokens,
                      tokens, train_runs)

torch.set_num_threads(1)
ARCH = "whisper-medium"


@functools.lru_cache(maxsize=None)
def _inputs(seed=2):
    jcfg, tcfg = configs(ARCH)
    jp, tp = both_params(jcfg, seed=seed)
    return jcfg, tcfg, jp, tp, extras_np(jcfg, 2)


def test_encode_matches_jax():
    """The encoder stack over 32 frames: RoPE over the frame positions,
    non-causal plain attention, the final ``enc_norm``."""
    jcfg, tcfg, jp, tp, ex = _inputs()
    ref = jax.jit(lambda p, a: je.encode(p, jcfg, a, remat="none"))(
        jp, jnp.asarray(ex["audio_frames"]))
    got = encdec.encode(tp, tcfg, torch.from_numpy(ex["audio_frames"]),
                        remat="none")
    assert got.shape == (2, 32, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("mask", [[1.0, 1.0], [1.0, 0.0]],
                         ids=["full", "prefix"])
def test_apply_and_logits_match_jax(mask):
    """The mask covers the decoder; the encoder runs whatever the mask."""
    assert_forward_matches_jax(ARCH, np.array(mask, np.float32))


def test_apply_without_audio_frames_raises_like_jax():
    """No ``audio_frames`` in ``extras``: a ``KeyError`` in both packages,
    never a run with no audio."""
    jcfg, tcfg, jp, tp, _ = _inputs()
    toks = tokens(jcfg, 2, 8)
    with pytest.raises(KeyError, match="audio_frames"):
        jax_build(jcfg).apply(jp, jnp.asarray(toks))
    with pytest.raises(KeyError, match="audio_frames"):
        build(tcfg).apply(tp, torch.from_numpy(toks))


def test_prefill_step_kernel_route_matches_jax():
    """``build_prefill_step``'s last-position logits, B 2 x S 32, with
    ``use_pallas=True``: the JAX Pallas kernel in interpret mode at the
    decoder's self-attention against the port's kernel wrapper, which
    takes its plain version on CPU tensors; the frames ride the batch."""
    jcfg, tcfg, jp, tp, ex = _inputs()
    toks = tokens(jcfg, 2, 32, seed=6)
    _, jstep = jax_prefill_step(jcfg, JaxTrainConfig(use_pallas=True))
    ref = jax.jit(jstep)(jp, {"tokens": jnp.asarray(toks), **as_jax(ex)})
    _, step = build_prefill_step(tcfg, TrainConfig(use_pallas=True))
    got = step(tp, {"tokens": torch.from_numpy(toks), **as_torch(ex)})
    assert got.shape == (2, 1, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DECODE)


def test_decode_cache_matches_jax():
    """``decode_init``: the self caches zero, the cross K/V [L, B, T_a,
    Hkv, hd] equal the JAX package's; with no frames both encode zeros."""
    jcfg, tcfg, jp, tp, ex = _inputs()
    jm, m = jax_build(jcfg), build(tcfg)
    for given in (ex, {}):
        jc = jm.decode_init(jp, 2, 16, extras=as_jax(given))
        c = m.decode_init(tp, 2, 16, extras=as_torch(given))
        assert c["cross"]["k"].shape == (2, 2, 32, 4, 64)
        assert c["self"]["k"].shape == (2, 2, 16, 4, 64)
        assert c["self"]["pos"].dtype == torch.int32
        assert_trees_close([c["cross"]["k"], c["cross"]["v"]],
                           [jc["cross"]["k"], jc["cross"]["v"]])


def test_decode_matches_jax_and_the_forward():
    got, jgot, ref, cache = decode_runs(ARCH)
    np.testing.assert_allclose(got, ref, **DECODE)
    np.testing.assert_allclose(got, jgot, **F32)
    assert cache["self"]["pos"].tolist() == [12, 12]


def test_remat_modes_give_the_same_numbers():
    """Each encoder and decoder layer is recomputed under ``full`` (the
    reference's ``jax.checkpoint`` has no policy, so ``dots`` is
    ``full``): hidden states and gradients equal ``none``'s bit for
    bit."""
    outs = remat_outputs(ARCH)
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


@pytest.fixture(scope="module")
def trained():
    return train_runs(ARCH)


def test_two_train_steps_match_jax(trained):
    assert_trained_like_jax(trained)


def test_slot_server_serves_the_jax_tokens():
    outs = served_tokens(ARCH)
    assert outs["port"] == outs["jax"]


def test_lm_params_from_jax_carries_the_encdec_tree():
    """whisper's bf16 tree: the ``encoder`` and ``decoder`` stacks [L,
    ...] with their LayerNorm ``bias`` and attention biases arrive leaf
    for leaf in bf16; both packages' bf16 forwards then agree at the bf16
    tolerance."""
    jcfg, tcfg = configs(ARCH, dtype="bfloat16")
    jp = bf16_tree(jcfg)
    tp = lm_params_from_jax(jp)
    assert tp["encoder"]["attn_norm"]["bias"].shape == (2, 256)
    assert tp["decoder"]["cross"]["wq"]["b"].shape == (2, 256)
    assert tp["decoder"]["mlp"]["w_in"]["w"].shape == (2, 256, 512)
    jl = jax.tree_util.tree_leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, t in zip(jl, tree_leaves(tp)):
        assert str(t.dtype) == "torch." + a.dtype.name == "torch.bfloat16"
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    toks = tokens(jcfg, 2, 16, seed=9)
    ex = extras_np(jcfg, 2)
    jhid, _ = jax.jit(functools.partial(jax_build(jcfg).apply, remat="none"))(
        jp, jnp.asarray(toks), as_jax(ex))
    h, _ = build(tcfg).apply(tp, torch.from_numpy(toks), as_torch(ex),
                             remat="none")
    ref = np.asarray(jhid, np.float32)
    assert h.dtype == torch.bfloat16
    assert np.abs(h.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()
