"""Shared inputs of the LM parity tests (``tests/test_torch_lm_*.py``):
JAX LM params made from numpy draws in the JAX package's own tree
(``jax.eval_shape`` of its ``init``, so no JAX random draws are compiled),
carried into the port by ``lm_params_from_jax``, the configs both
packages build, and the cross-attention families' stub-frontend inputs
(:func:`extras_np`); and the whole-model checks that the sub-quadratic
and cross-attention families' files share (forward under a layer mask,
decode, remat, train steps, the slot server), each feeding both packages
the same extras."""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.launch.serve import SlotServer as JaxSlotServer
from repro.launch.steps import build_serve_step as jax_build_serve_step
from repro.launch.steps import build_train_step as jax_train_step
from repro.models import build as jax_build
from repro.models import extra_inputs as jax_extra_inputs
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.serve import SlotServer
from repro_torch.launch.steps import build_train_step
from repro_torch.models.api import build
from repro_torch.optim.optimizers import adamw_init
from repro_torch.tree import tree_leaves

#: the dense family's archs
DENSE = ("yi-34b", "phi3-mini-3.8b", "minitron-8b", "command-r-35b")


def configs(arch, **over):
    """(the JAX config, the port's): the arch's smoke variant with
    ``over``."""
    return (jax_reduced(jax_get_config(arch), **over),
            reduced(get_config(arch), **over))


#: the sub-quadratic families' and the MoE FFN's bare matrices ([...,
#: d_in, d_out], or the sLSTM's per-head ``r`` [..., H, P, 4P]), drawn as
#: dense ``w`` are
MATRICES = ("w_up", "wq", "wk", "wv", "w_if", "w_down", "w_in", "w_out",
            "r", "router", "w_gate")
#: their gate biases and per-head constants, and LayerNorm's ``bias``,
#: drawn as biases are
SMALL = ("b_if", "A_log", "dt_bias", "D", "conv_b", "bias")
#: the VLM's tanh gates (float32 scalars, zero at init: drawn nonzero so
#: the cross layers count)
GATES = ("gate_attn", "gate_mlp")


def jax_params(jcfg, seed=0):
    """Numpy params in the JAX model's tree: dense ``w`` and the
    sub-quadratic families' bare matrices ~ N(0, 1/d_in), the Mamba conv
    taps N(0, 0.5^2) (the reference's init scale), the VLM's gates N(0,
    0.5^2), embeddings N(0, 1), norm scales 1 + N(0, 0.1^2), biases
    (LayerNorm's too), gate biases and the per-head SSM constants N(0,
    0.1^2) (nonzero, so every leaf matters)."""
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        bare = name[2:-2]
        x = rng.normal(size=s.shape)
        if "scale" in name:
            x = 1.0 + 0.1 * x
        elif "'b'" in name or bare in SMALL:
            x = 0.1 * x
        elif bare in MATRICES:
            x = x / np.sqrt(s.shape[-2])
        elif bare == "conv_w" or bare in GATES:
            x = 0.5 * x
        elif "'w'" in name:
            x = x / np.sqrt(s.shape[-2])
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both_params(jcfg, seed=0):
    """(JAX numpy params, the port's tensors on the CPU)."""
    jp = jax_params(jcfg, seed)
    return jp, lm_params_from_jax(jp)


# ---------------------------------------------------------------------------
# the whole-model checks shared by the families' files
# ---------------------------------------------------------------------------

F32 = dict(rtol=1e-5, atol=1e-5)
DECODE = dict(atol=2e-4, rtol=1e-3)


def assert_trees_close(got, ref, **tol):
    """Leaf for leaf (arrays, tensors' numpy values, lists of either) at
    ``tol``, float32's by default."""
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   **(tol or F32))


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def extras_np(jcfg, B, seed=11):
    """The family's stub-frontend inputs (``image_embeds``,
    ``audio_frames``) as numpy N(0, 1) float32 draws, B rows; empty for
    the other families."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=shape).astype(np.float32)
            for k, (shape, _) in jax_extra_inputs(jcfg, B, 0).items()}


def as_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def as_torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def jax_forward(jcfg):
    """The JAX model's ``apply`` then ``logits``, jitted once per
    config."""
    m = jax_build(jcfg)

    @jax.jit
    def fwd(params, toks, mask, extras):
        h, aux = m.apply(params, toks, extras, layer_mask=mask, remat="none")
        return h, m.logits(params, h), aux
    return fwd


def assert_forward_matches_jax(arch, mask, seed=1, S=32, tol=F32):
    """``apply`` and ``logits`` under the layer mask ``mask`` against the
    JAX model's at ``tol``, B 2 x S tokens (two chunks of the smoke
    config's 16), and the aux loss too: zero but for the MoE family,
    whose router's loss is held at ``tol``."""
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, seed=seed)
    toks = tokens(jcfg, 2, S)
    ex = extras_np(jcfg, 2)
    jh, jl, jaux = jax_forward(jcfg)(jp, jnp.asarray(toks),
                                     jnp.asarray(mask), as_jax(ex))
    m = build(tcfg)
    h, aux = m.apply(tp, torch.from_numpy(toks), as_torch(ex), remat="none",
                     layer_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(m.logits(tp, h).detach().numpy(),
                               np.asarray(jl), **tol)
    if tcfg.num_experts:
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(jaux), **tol)
    else:
        assert float(aux) == 0.0
    return h


def decode_runs(arch, S=12, seed=3, **over):
    """Decode S tokens one at a time in both packages, B 2: the port's
    logits, the JAX step's and the port's teacher-forced forward's
    (``over`` changes the smoke config)."""
    jcfg, tcfg = configs(arch, **over)
    jp, tp = both_params(jcfg, seed=seed)
    toks = tokens(jcfg, 2, S, seed=seed + 1)
    ex = extras_np(jcfg, 2)
    jm, m = jax_build(jcfg), build(tcfg)
    h, _ = m.apply(tp, torch.from_numpy(toks), as_torch(ex), remat="none")
    cache = m.decode_init(tp, 2, S, extras=as_torch(ex))
    jstep = jax.jit(jm.decode_step)
    jcache = jm.decode_init(jp, 2, S, extras=as_jax(ex))
    got, jgot = [], []
    for t in range(S):
        tok = toks[:, t:t + 1]
        lg, cache = m.decode_step(tp, cache, torch.from_numpy(tok), t)
        jlg, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.int32(t))
        got.append(lg[:, 0].numpy())
        jgot.append(np.asarray(jlg)[:, 0])
    return (np.stack(got, 1), np.stack(jgot, 1),
            m.logits(tp, h).detach().numpy(), cache)


def remat_outputs(arch):
    """The hidden states and every gradient under ``none``, ``full`` and
    ``dots``, from the same init."""
    jcfg, tcfg = configs(arch)
    m = build(tcfg)
    toks = torch.from_numpy(tokens(tcfg, 2, 32, seed=2))
    ex = as_torch(extras_np(jcfg, 2))
    outs = []
    for remat in ("none", "full", "dots"):
        params = m.init(torch.Generator().manual_seed(0))
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        h, _ = m.apply(params, toks, ex, remat=remat)
        loss = m.logits(params, h).square().mean()
        outs.append([h.detach()] + list(torch.autograd.grad(loss, leaves)))
    return outs


def train_runs(arch, steps=2, B=2, S=32, seed=7):
    """``steps`` train steps of the arch's smoke config in both packages
    (full remat, the loss in chunks of 16) from the same params and
    batches, the JAX step (``jax.value_and_grad`` and ``adamw_update``)
    jitted once: (losses and grad norms by package, lrs, params by
    package, and the batches as numpy)."""
    jcfg, tcfg = configs(arch)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              loss_chunk=16)
    jp, tp = both_params(jcfg, seed=seed)
    _, jstep = jax_train_step(jcfg, JaxTrainConfig(**kw))
    jstep = jax.jit(jstep)
    _, step = build_train_step(tcfg, TrainConfig(**kw))
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": jax_adamw_init(jp)}
    state = {"params": tp, "opt": adamw_init(tp)}
    rng = np.random.default_rng(seed + 1)
    out = {"jax": [], "port": [], "lr": [], "batches": []}
    for i in range(steps):
        toks = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 **extras_np(jcfg, B, seed=seed + 2 + i)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        out["jax"].append((float(jm["loss"]), float(jm["grad_norm"])))
        out["port"].append((float(m["loss"]), float(m["grad_norm"])))
        out["lr"].append(float(m["lr"]))
        out["batches"].append(batch)
    out["params"] = (jax.tree.map(np.asarray, jstate["params"]),
                     state["params"])
    return out


def assert_trained_like_jax(runs):
    """Losses and grad norms at rtol 1e-5; params within 2 lr per update
    (a parameter whose gradient sits at AdamW's eps may move by up to lr
    in either package)."""
    np.testing.assert_allclose(np.array(runs["port"]), np.array(runs["jax"]),
                               rtol=1e-5, atol=0)
    jp, tp = runs["params"]
    budget = 2.0 * sum(runs["lr"])
    jl = jax.tree_util.tree_leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, b in zip(tree_leaves(tp), jl):
        assert a.shape == b.shape
        assert np.abs(a.detach().numpy() - b).max() <= budget


def _drawn_init(cfg):
    """``repro.launch.serve.build_serve_step`` with the model's ``init``
    replaced by :func:`jax_params`' draws (seed 10): the JAX server draws
    its params op by op otherwise, which takes seconds at the smoke
    size."""
    model, step = jax_build_serve_step(cfg)
    params = jax.tree.map(jnp.asarray, jax_params(cfg, seed=10))
    return dataclasses.replace(model, init=lambda key: params), step


def served_tokens(arch, max_len=48):
    """The JAX server and the port's, given the JAX server's params (and
    the same stub-frontend inputs, :func:`extras_np`): 2 slots, 3 requests
    of 5 tokens, 4 new each (a slot is refilled and carries on from its
    previous occupant's state)."""
    jcfg, tcfg = configs(arch)
    with mock.patch.object(jax_serve, "build_serve_step", _drawn_init):
        jsrv = JaxSlotServer(jcfg, 2, max_len)
    srv = SlotServer(tcfg, 2, max_len, device="cpu")
    srv.params = lm_params_from_jax(jax.tree.map(np.asarray, jsrv.params))
    ex = extras_np(jcfg, 2)
    if ex:
        jsrv.cache = jsrv.model.decode_init(jsrv.params, 2, max_len,
                                            extras=as_jax(ex))
    srv.cache = srv.model.decode_init(srv.params, srv.slots, srv.max_len,
                                      extras=as_torch(ex))
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tcfg.vocab_size, size=5) for _ in range(3)]
    outs = {}
    for name, s in (("jax", jsrv), ("port", srv)):
        pending, done = list(prompts), []
        while len(done) < 3:
            while pending and s.submit(pending[0], 4) is not None:
                pending.pop(0)
            done += [(slot, a["out"]) for slot, a in s.step()]
        outs[name] = (done, s.pos)
    return outs


def bf16_tree(jcfg, seed=8):
    """The JAX model's params in the dtypes its bf16 ``init`` gives
    (bfloat16, with float32 gate and recurrent leaves), as numpy."""
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, s: np.asarray(jnp.asarray(a, s.dtype)),
                        jax_params(jcfg, seed), shapes)
