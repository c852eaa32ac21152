"""The rank program of ``tests/test_torch_mesh.py``: it runs on every rank
of a 4-rank gloo group (``torch_shard_ranks.launch``) on the ``(2, 2)``
debug mesh, holds the meshed steps (``launch/train.py::meshed_step``) to
the one-process steps it computes itself, and raises on a mismatch (the
spawning test re-raises it).  No jax here: the spawned ranks import only
torch and the port."""
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.checkpoint import latest_step, load_pytree
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.core.layerwise import layer_mask
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import (build_fl_train_step, build_train_step,
                                      make_train_state)
from repro_torch.sharding.rules import set_sharding_policy
from repro_torch.tree import tree_leaves

STEP = dict(rtol=1e-5, atol=1e-6)          # tests/test_shard.py's
ARCH = "phi3-mini-3.8b"
#: a MoE config: its load-balance loss is a product of token means, which
#: the meshed step must take over the whole batch
MOE_ARCH = "mixtral-8x22b"
TCFG = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                   loss_chunk=8, remat="full")
#: the policies the meshed train step runs under (zero1 on replicated
#: weights, as the reference pairs them)
POLICIES = {"default": {}, "fsdp=False": {"fsdp": False},
            "zero1": {"fsdp": False, "zero1": True}, "dp2d": {"dp2d": True}}
#: the checkpoint run: two meshed steps of the train main's loop at its
#: ``--smoke --batch 4 --seq 16 --steps 3`` settings; the spawning test
#: resumes it to step 3 in one process
CKPT_ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
             "--seq", "16", "--steps", "3"]
CKPT_TCFG = TrainConfig(learning_rate=3e-4, warmup_steps=10, total_steps=3,
                        remat="full", loss_chunk=16)


def _batches(cfg, n, B=4, S=16, seed=1, fl=False):
    """``n`` batches from numpy draws; with ``fl``, four clients, one row
    each, on the smoke config's submodels 0, 1, 0, 1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int64))
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if fl:
            gates = torch.stack([layer_mask(cfg, i % 2, device="cpu")
                                 for i in range(B)], dim=1)
            b.update(layer_gates=gates, layer_counts=gates.sum(dim=1),
                     n_clients=float(B))
        out.append(b)
    return out


def _close(got, ref, what, **tol):
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   err_msg=what, **(tol or STEP))


def _same_state(meshed, one, lrs, what):
    """The gathered meshed state against the one-process state: the
    moments (the averaged gradients) at the step tolerances, the params
    within 2 lr per update (a param whose gradient sits at AdamW's eps
    moves by up to lr either way on a rounding of its gradient, as in
    ``tests/torch_lm.py::assert_trained_like_jax``) and all but a few of
    each param's elements at the step tolerances (an update that was
    never written back moves every element by about lr), the step
    equal."""
    whole = T.gather_state(meshed)
    _close(whole["opt"]["mu"], one["opt"]["mu"], what)
    _close(whole["opt"]["nu"], one["opt"]["nu"], what)
    _close(whole["params"], one["params"], what, rtol=0,
           atol=2.0 * sum(lrs))
    for a, b in zip(tree_leaves(whole["params"]),
                    tree_leaves(one["params"])):
        a, b = a.detach().numpy(), b.detach().numpy()
        assert np.mean(~np.isclose(a, b, **STEP)) < 1e-4, what
    assert whole["opt"]["step"] == one["opt"]["step"] == len(lrs)


def _check_shards(state, mesh, what):
    """Every ``DTensor`` of the state holds the slice its placements name
    (``distribute_tensor``'s own slicing of the gathered tensor)."""
    whole = T.gather_state(state)
    for t, w in zip(tree_leaves(state), tree_leaves(whole)):
        if isinstance(t, DTensor):
            ref = distribute_tensor(w, mesh, t.placements).to_local()
            assert torch.equal(t.to_local(), ref), what


def _data_sharded(tree):
    """Leaves placed on the ``data`` mesh dim (dim 0 of the debug mesh)."""
    return sum(isinstance(t.placements[0], Shard) for t in tree_leaves(tree))


def _run(build, cfg, mesh, batches):
    """Two steps one process and two meshed, from the same init: (the
    one-process state, metrics; the meshed state, metrics)."""
    model, step = build(cfg, TCFG)
    one = make_train_state(model, torch.Generator().manual_seed(0), TCFG)
    meshed = T.place_state(
        make_train_state(model, torch.Generator().manual_seed(0), TCFG), mesh)
    run = T.meshed_step(step, mesh)
    m1, m2 = [], []
    for b in batches:
        one, m = step(one, b)
        m1.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
        meshed, m = run(meshed, b)
        m2.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    return one, m1, meshed, m2


def mesh_steps(rank, ckpt_dir):
    """The builders' refusals; the meshed train step under each policy,
    the meshed FL step, and a MoE config's meshed train and FL steps
    against the one-process steps, the shards against their placements;
    the checkpoint run."""
    for build, need in ((lambda: make_production_mesh(), 256),
                        (lambda: make_production_mesh(multi_pod=True), 512),
                        (lambda: make_debug_mesh(multi_pod=True), 8)):
        try:
            build()
        except ValueError as e:
            assert f"needs {need} ranks" in str(e) and "has 4" in str(e)
        else:
            raise AssertionError(f"a {need}-rank mesh built on 4 ranks")
    mesh = make_debug_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    cfg = get_smoke_config(ARCH)
    for name, pol in POLICIES.items():
        set_sharding_policy(**pol)
        try:
            one, m1, meshed, m2 = _run(build_train_step, cfg, mesh,
                                       _batches(cfg, 2))
            np.testing.assert_allclose(m2, m1, rtol=1e-5, err_msg=name)
            _same_state(meshed, one, [m[2] for m in m1], name)
            _check_shards(meshed, mesh, name)
            fsdp = _data_sharded(meshed["params"])
            moments = _data_sharded(meshed["opt"]["mu"])
            if name == "default":
                assert fsdp and moments == fsdp, name
            elif name != "dp2d":
                assert fsdp == 0 and bool(moments) == (name == "zero1"), name
        finally:
            set_sharding_policy(fsdp=True, zero1=False, dp2d=False)
    for arch in (ARCH, MOE_ARCH):
        cfg = get_smoke_config(arch)
        for fl in (False, True) if arch == MOE_ARCH else (True,):
            what = f"{arch} {'fl' if fl else 'train'}"
            one, m1, meshed, m2 = _run(
                build_fl_train_step if fl else build_train_step, cfg, mesh,
                _batches(cfg, 2, seed=3, fl=fl))
            np.testing.assert_allclose(m2, m1, rtol=1e-5, err_msg=what)
            _same_state(meshed, one, [m[2] for m in m1], what)
            _check_shards(meshed, mesh, what)
    cfg = get_smoke_config(ARCH)

    out = T.train(cfg, CKPT_TCFG, batch=4, seq=16, steps=2,
                  device=torch.device("cpu"), mesh=mesh, ckpt_dir=ckpt_dir)
    whole = T.gather_state(out["state"])
    saved = load_pytree(latest_step(ckpt_dir), T._on_disk(whole))
    for a, b in zip(tree_leaves(saved["params"]),
                    tree_leaves(whole["params"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(saved["opt"]["step"]) == 2
    dist.barrier()
