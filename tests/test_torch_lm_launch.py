"""The port's LM launchers (``launch/steps.py``, ``launch/serve.py``,
``launch/train.py``) against the JAX package's: the sequence-chunked
cross-entropy (masked labels, lengths the chunk does not divide) and its
gradient, three train steps (losses, grad norms, params), the in-place
AdamW against the port's out-of-place one, the slot server's tokens, and
the two entry points on ``--device cpu --smoke``.

The JAX params are numpy draws carried across by ``lm_params_from_jax``.
Tolerances: the cross-entropy, the losses and the grad norms rtol 1e-5;
params within 2 lr per update (ROADMAP's AdamW caveat: a parameter whose
gradient sits at eps may move by up to lr in either package); the
in-place AdamW bit for bit; served tokens equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.configs import TrainConfig as JaxTrainConfig
from repro.launch.serve import SlotServer as JaxSlotServer
from repro.launch.steps import build_train_step as jax_train_step
from repro.launch.steps import chunked_cross_entropy as jax_ce
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import TrainConfig
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve, train
from repro_torch.launch.serve import SlotServer
from repro_torch.launch.steps import build_train_step, chunked_cross_entropy
from repro_torch.optim import optimizers
from repro_torch.optim.optimizers import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map
from torch_lm import both_params, configs

torch.set_num_threads(1)
RTOL = dict(rtol=1e-5, atol=0)


@pytest.mark.parametrize("S,chunk", [(12, 4), (10, 4), (12, 512)],
                         ids=["three chunks", "odd length", "one chunk"])
def test_chunked_cross_entropy_and_grad_match_jax(S, chunk):
    rng = np.random.default_rng(0)
    B, d, V = 2, 8, 11
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    w = rng.normal(size=(d, V)).astype(np.float32)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    lab[0, :3] = -1                       # masked positions
    lab[1, -1] = -1
    ref, (jgh, jgw) = jax.value_and_grad(
        lambda a, b: jax_ce(a, b, jnp.asarray(lab), chunk), (0, 1))(
            jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = chunked_cross_entropy(th, tw, torch.from_numpy(lab), chunk)
    gh, gw = torch.autograd.grad(got, (th, tw))
    np.testing.assert_allclose(got.item(), float(ref), **RTOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-7)


def test_inplace_adamw_equals_adamw_update_bit_for_bit(monkeypatch):
    """Three steps on float32 and bfloat16 leaves, vectors (no decay) and
    matrices, the clip active on the first step; ``INPLACE_CHUNK`` cut to
    7 elements so every leaf is updated in several slices."""
    monkeypatch.setattr(optimizers, "INPLACE_CHUNK", 7)
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn((5, 6), generator=g),
              "b": {"v": torch.randn((9,), generator=g),
                    "w": torch.randn((4, 3, 5), generator=g).bfloat16()}}
    ours = tree_map(torch.clone, params)
    state_ref, state = adamw_init(params), adamw_init(ours)
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=1.0)
    for step in range(3):
        grads = tree_map(lambda p: (torch.randn(p.shape, generator=g)
                                    * (10.0 if step == 0 else 0.01)
                                    ).to(p.dtype), params)
        lr = torch.tensor(3e-4 * (step + 1), dtype=torch.float32)
        params, state_ref, m_ref = adamw_update(grads, state_ref, params,
                                                lr=lr, **kw)
        m = optimizers.adamw_update_(grads, state, ours, lr=lr, **kw)
        assert torch.equal(m["grad_norm"], m_ref["grad_norm"])
        assert state["step"] == state_ref["step"] == step + 1
        for tree in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(state[tree]), tree_leaves(state_ref[tree])))
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                   zip(tree_leaves(ours), tree_leaves(params)))


STEPS, B, S = 3, 2, 16


@pytest.fixture(scope="module")
def train_runs():
    """Three train steps of the phi3-mini smoke config (4 query heads
    over 2 KV heads, full remat, the loss in chunks of 8) in both
    packages from the same params and batches; the JAX step jitted
    once."""
    jcfg, tcfg = configs("phi3-mini-3.8b", num_kv_heads=2)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              loss_chunk=8)
    jp, tp = both_params(jcfg, seed=7)
    _, jstep = jax_train_step(jcfg, JaxTrainConfig(**kw))
    jstep = jax.jit(jstep)
    _, step = build_train_step(tcfg, TrainConfig(**kw))
    jstate = {"params": jax.tree.map(jnp.asarray, jp),
              "opt": jax_adamw_init(jp)}
    state = {"params": tp, "opt": adamw_init(tp)}
    rng = np.random.default_rng(8)
    out = {"jax": [], "port": [], "lr": []}
    for _ in range(STEPS):
        toks = rng.integers(0, tcfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        out["jax"].append((float(jm["loss"]), float(jm["grad_norm"])))
        out["port"].append((float(m["loss"]), float(m["grad_norm"])))
        out["lr"].append(float(m["lr"]))
    out["params"] = (jax.tree.map(np.asarray, jstate["params"]),
                     state["params"], int(jstate["opt"]["step"]),
                     state["opt"]["step"])
    return out


def test_train_losses_and_grad_norms_match_jax(train_runs):
    np.testing.assert_allclose(np.array(train_runs["port"]),
                               np.array(train_runs["jax"]), **RTOL)


def test_trained_params_match_jax(train_runs):
    jp, tp, jstep, step = train_runs["params"]
    assert jstep == step == STEPS
    budget = 2.0 * sum(train_runs["lr"])
    jl = jax.tree_util.tree_leaves(jp)
    assert len(jl) == len(tree_leaves(tp))
    for a, b in zip(tree_leaves(tp), jl):
        assert np.abs(a.detach().numpy() - b).max() <= budget


def test_slot_server_serves_the_jax_tokens():
    """The minitron smoke config, 2 slots, a cache of 48: the JAX server
    and the port's, given the same params, serve the same tokens for 3
    requests (a slot is refilled)."""
    jcfg, tcfg = configs("minitron-8b")
    jsrv = JaxSlotServer(jcfg, 2, 48)
    jp = jax.tree.map(np.asarray, jsrv.params)
    srv = SlotServer(tcfg, 2, 48, device="cpu")
    srv.params = lm_params_from_jax(jp)
    srv.cache = srv.model.decode_init(srv.params, srv.slots, srv.max_len)
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
    assert outs["port"] == outs["jax"]


def test_serve_main_runs_on_cpu(capsys):
    out = serve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device",
                      "cpu", "--slots", "2", "--requests", "3",
                      "--prompt-len", "4", "--max-new", "3"])
    assert len(out["outputs"]) == 3
    assert all(len(o) == 3 for o in out["outputs"])
    assert "served 3/3 requests" in capsys.readouterr().out


def test_train_main_runs_on_cpu_and_resumes(tmp_path):
    """Two steps with a checkpoint after each, then a resumed run to
    three; the reference's loader reads the port's checkpoint."""
    ck = str(tmp_path / "ck")
    args = ["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", ck]
    first = train.main(args + ["--steps", "2", "--ckpt-every", "1"])
    assert sorted(os.listdir(ck)) == ["step_00000001.ckpt",
                                      "step_00000002.ckpt"]
    assert len(first["losses"]) == 2
    resumed = train.main(args + ["--steps", "3"])
    assert len(resumed["losses"]) == 1 and resumed["state"]["opt"]["step"] == 3
    template = jax.tree.map(
        lambda t: np.zeros(t.shape, np.float32) if isinstance(t, torch.Tensor)
        else t, train._on_disk(resumed["state"]))
    loaded = jax_load_pytree(os.path.join(ck, "step_00000003.ckpt"),
                             template)
    assert int(loaded["opt"]["step"]) == 3
    np.testing.assert_array_equal(
        loaded["params"]["embed"]["emb"],
        resumed["state"]["params"]["embed"]["emb"].detach().numpy())


def test_train_mesh_waits_for_the_sharding_slice(tmp_path):
    """``--mesh`` is no longer refused (the sharding slice is in): it
    builds the production mesh, so with no process group, and in a group
    of one rank, it raises ``ValueError`` naming the 256 ranks the
    single-pod mesh needs."""
    args = ["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
            "--mesh", "single", "--steps", "1"]
    with pytest.raises(ValueError, match="needs 256 ranks.*has 1"):
        train.main(args)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 256 ranks.*has 1"):
            train.main(args)
    finally:
        dist.destroy_process_group()
