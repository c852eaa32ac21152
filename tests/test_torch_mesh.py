"""The production mesh on ``torch.distributed``: ``repro_torch.sharding.
rules``, ``launch/{mesh,specs}.py`` and ``launch/train.py``'s meshed step,
against the JAX package.

In one process: the spec functions read only a mesh's axis names and
sizes, so both packages get one stand-in per mesh shape (the single- and
multi-pod production and debug meshes), with no devices behind it.  Every
arch's parameter specs (full and smoke shapes) under the policies
default, ``fsdp=False``, ``zero1`` and ``dp2d``; the cases of
``tests/test_dryrun_small.py``'s rule check; every family's decode-cache
specs; ``batch_axes``; the train-input, cache and state placements (the
moments under ``zero1``); the ``repeat_kv`` branch of ``gqa_attend``
against the default branch and against the JAX one under the same
policy; the policy knobs and the activation hooks' specs against the
reference's hooks (their ``with_sharding_constraint`` patched to hand
back the spec); each rank's state bytes on the production mesh against
the reference's shard shapes; the mesh builders' refusals; and the
meshed step on a one-rank ``(1, 1)`` mesh, bit for bit the one-device
step; the vocab-parallel logsumexp on a one-rank group, bit for bit
``torch.logsumexp``; every LM family's meshed prefill and decode on a
one-rank mesh, bit for bit the one-device steps; the vocab-parallel
argmax against ``torch.argmax`` on planted ties; and the 4-rank decode
cases' cache layouts against the reference's ``cache_specs``.

Then, on 4 gloo ranks (one spawn, ``tests/torch_mesh_ranks.py``, through
``torch_shard_ranks.launch``): the tensor-parallel train and masked FL
steps of phi3-mini's and mixtral's smoke configs on the ``(2, 2)`` debug
mesh under eight policies against the one-process steps (each rank's
shards, its local sizes, and no collective that gathers a model-sharded
param whole), xLSTM's train step under the same policies and with heads
that do not divide the model axis, the Mamba2 hybrid's, whisper's and
the VLM's under four, the collectives of an xLSTM step equal at two
lengths (none in the sLSTM loop), the bucketed FL step, the
leaf-by-leaf state build and its peak, every LM family's meshed prefill
and decode in each of the reference's cache layouts against the
one-process steps (``torch_mesh_ranks.DECODE``), the meshed steps from
the JAX package's params against the JAX package's live steps (six
families) and the meshed decode against the JAX package's decode
(phi3-mini, xLSTM), and a ``--ckpt-dir`` run on the mesh that one
process resumes.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

import torch_lm
import torch_mesh_ranks as mesh_ranks
import torch_shard_ranks as ranks
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import specs as jspecs
from repro.models import build as jax_build
from repro.models.layers import gqa_attend as jax_gqa_attend
from repro.sharding import rules as jrules
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs, \
    reduced
from repro_torch.launch import specs, train
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import (build_fl_train_step, build_train_step,
                                      make_train_state)
from repro_torch.models.api import build
from repro_torch.models.layers import gqa_attend
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves

#: the reference's four meshes, as axis names and sizes
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16)),
          "debug": (("data", "model"), (2, 2)),
          "debug-multi": (("pod", "data", "model"), (2, 2, 2))}
POLICIES = {"default": {}, "fsdp=False": {"fsdp": False},
            "zero1": {"fsdp": False, "zero1": True}, "dp2d": {"dp2d": True}}
DEFAULTS = dict(fsdp=True, act_model=True, repeat_kv=False, zero1=False,
                attn_seq=False, attn_heads=False, act_seq=False,
                block_gather=False, dp2d=False)


def stand_in(name):
    """One mesh's axis names and a ``shape`` mapping, which both
    packages' spec functions read."""
    names, sizes = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


@pytest.fixture
def policy():
    """Sets both packages' sharding policies; restores the defaults."""
    def put(**kw):
        jrules.set_sharding_policy(**kw)
        rules.set_sharding_policy(**kw)
    yield put
    put(**DEFAULTS)


def _spec(p, ndim):
    """A reference ``PartitionSpec`` as the port's tuple, one entry a
    dim."""
    t = tuple(p)
    return t + (None,) * (ndim - len(t))


def _jax_by_path(specs_tree, shapes_tree):
    """{path: (spec tuple)} of a reference spec tree over its shapes."""
    pairs = jax.tree_util.tree_flatten_with_path(
        specs_tree, is_leaf=lambda x: isinstance(x, P))[0]
    shapes = jax.tree_util.tree_flatten_with_path(shapes_tree)[0]
    assert len(pairs) == len(shapes)
    return {jrules._path_str(kp): _spec(p, len(s.shape))
            for (kp, p), (_, s) in zip(pairs, shapes)}


def _port_by_path(tree, path=""):
    """{path: leaf} of a spec or placements tree (dicts and lists; its
    tuples are leaves)."""
    items = (tree.items() if isinstance(tree, dict) else
             enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_port_by_path(v, f"{path}/{k}" if path else str(k)))
    return out


def _configs(arch):
    return {"full": (jax_get_config(arch), get_config(arch)),
            "smoke": (jax_reduced(jax_get_config(arch)),
                      reduced(get_config(arch)))}


def _small_shape(B, S, jax_side=False):
    """A decode shape of B x S in either package."""
    from repro.configs.base import ShapeConfig as JaxShape
    from repro_torch.configs.base import ShapeConfig
    return (JaxShape if jax_side else ShapeConfig)("small", S, B, "decode")


# ---------------------------------------------------------------------------
# specs, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch, policy):
    """Every leaf of the full and smoke params (meta tensors here, the
    reference's ``eval_shape``) on the four meshes under the four
    policies, and with ``force_fsdp``."""
    for size, (jcfg, cfg) in _configs(arch).items():
        jshapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
        shapes = specs._params_shape(build(cfg))
        assert all(t.is_meta for t in tree_leaves(shapes))
        for pol in POLICIES.values():
            policy(**DEFAULTS)
            policy(**pol)
            for name in MESHES:
                mesh = stand_in(name)
                for force in (False, True):
                    got = _port_by_path(rules.param_specs(shapes, mesh, force))
                    ref = _jax_by_path(
                        jrules.param_specs(jshapes, mesh, force), jshapes)
                    assert got == ref, (arch, size, pol, name, force)


def test_spec_for_the_reference_rule_cases():
    """``tests/test_dryrun_small.py``'s cases on the debug mesh, in both
    packages."""
    mesh = stand_in("debug")
    cases = [("blocks/attn/wq/w", (4, 64, 64), (None, "data", "model")),
             ("blocks/moe/w_gate", (4, 8, 64, 64),
              (None, "model", "data", None)),
             ("blocks/moe/w_gate", (4, 3, 64, 64),
              (None, None, "data", "model")),
             ("blocks/attn_norm/scale", (64,), (None,)),
             ("blocks/mlp/w_up/w", (4, 63, 65), (None, None, None))]
    for path, shape, want in cases:
        assert rules.spec_for(path, shape, mesh) == want
        assert _spec(jrules.spec_for(path, shape, mesh), len(shape)) == want


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_the_reference(arch, policy):
    """Every family's decode cache (``decode_inputs``: the port's
    ``decode_init`` on meta params) at the full config's ``decode_32k``
    and the smoke config's B 4 x S 64, under the default and ``dp2d``."""
    for size, (jcfg, cfg) in _configs(arch).items():
        shape = (INPUT_SHAPES["decode_32k"] if size == "full" else
                 _small_shape(4, 64))
        jshape = (JAX_SHAPES["decode_32k"] if size == "full" else
                  _small_shape(4, 64, jax_side=True))
        cache, tokens, pos = specs.decode_inputs(build(cfg), cfg, shape)
        jcache, jtok, jpos = jspecs.decode_inputs(jax_build(jcfg), jcfg,
                                                  jshape)
        assert tokens == ((shape.global_batch, 1), torch.int32)
        assert pos == ((), torch.int32)
        assert _port_by_path(rules.map_with_path(
            lambda p, t: tuple(t.shape), cache)) == {
            jrules._path_str(kp): tuple(s.shape) for kp, s in
            jax.tree_util.tree_flatten_with_path(jcache)[0]}
        for pol in ({}, {"dp2d": True}):
            policy(**DEFAULTS)
            policy(**pol)
            for name in MESHES:
                mesh = stand_in(name)
                got = _port_by_path(rules.cache_specs(cache, mesh))
                ref = _jax_by_path(jrules.cache_specs(jcache, mesh), jcache)
                assert got == ref, (arch, size, pol, name)
                placed = _port_by_path(specs.decode_cache_shardings(cache,
                                                                    mesh))
                assert placed == {k: rules.placements(v, mesh)
                                  for k, v in ref.items()}


def test_batch_axes_and_placements(policy):
    """``batch_axes``, ``batch_spec`` and ``activation_spec`` on each mesh
    under the default and ``dp2d``; the train inputs' placements; a spec
    as placements."""
    for pol in ({}, {"dp2d": True}):
        policy(**DEFAULTS)
        policy(**pol)
        for name in MESHES:
            mesh = stand_in(name)
            assert rules.batch_axes(mesh) == jrules.batch_axes(mesh)
            assert specs.batch_spec(mesh) == tuple(jspecs.batch_spec(mesh))
            for ndim in (2, 3):
                for ok in (True, False):
                    assert rules.activation_spec(mesh, ndim, ok) == _spec(
                        jrules.activation_spec(mesh, ndim, ok), ndim)
            for arch in ("phi3-mini-3.8b", "whisper-medium"):
                jcfg, cfg = _configs(arch)["full"]
                got = specs.train_input_shardings(
                    cfg, INPUT_SHAPES["train_4k"], mesh)
                ref = jspecs.train_input_shardings(
                    jcfg, JAX_SHAPES["train_4k"], AbstractMesh(
                        MESHES[name][1], MESHES[name][0]))
                assert set(got) == set(ref)
                for k, s in ref.items():
                    nd = 3 if k in ("image_embeds", "audio_frames") else 2
                    assert got[k] == rules.placements(_spec(s.spec, nd), mesh)
        assert specs.train_inputs(cfg, INPUT_SHAPES["train_4k"]) == {
            k: (tuple(s.shape), getattr(torch, str(s.dtype))) for k, s in
            jspecs.train_inputs(jcfg, JAX_SHAPES["train_4k"]).items()}
    mesh = stand_in("debug-multi")
    assert rules.placements((None, ("pod", "data"), "model"), mesh) == (
        Shard(1), Shard(1), Shard(2))
    assert rules.placements((None, None), mesh) == (Replicate(),) * 3


@pytest.mark.parametrize("knob", rules.HOOK_KNOBS)
def test_hook_knobs_take_their_values(knob, policy):
    """Each knob that steers the activation hooks takes the value off its
    default, with another knob beside it, and the policy then equals the
    reference's under the same calls; the default is taken back."""
    policy(**{knob: not DEFAULTS[knob]}, fsdp=False)
    got = rules.get_sharding_policy()
    assert got == jrules.get_sharding_policy()
    assert got[knob] is (not DEFAULTS[knob]) and got["fsdp"] is False
    policy(**DEFAULTS)
    assert rules.get_sharding_policy() == jrules.get_sharding_policy() == \
        DEFAULTS


class _Constrained:
    """What the patched ``with_sharding_constraint`` hands back: the
    input's shape and the spec it was constrained to."""

    def __init__(self, x, spec):
        self.shape, self.ndim, self.spec = x.shape, len(x.shape), spec


@pytest.fixture
def hooks(monkeypatch):
    """The reference's hooks handing back the spec they would constrain
    to: ``with_sharding_constraint`` and ``NamedSharding`` patched, so a
    stand-in mesh serves.  Yields ``install(mesh, model_axis_ok)`` for
    both packages; uninstalls both."""
    monkeypatch.setattr(jrules, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jrules.jax.lax, "with_sharding_constraint",
                        _Constrained)

    def install(mesh, ok=True):
        jrules.set_activation_mesh(mesh, model_axis_ok=ok)
        rules.set_activation_mesh(mesh, model_axis_ok=ok)
    yield install
    install(None)


def _ref_spec(x, ndim):
    """A reference hook's result as the port's spec tuple (an input that
    no spec constrained, as None)."""
    return _spec(x.spec, ndim) if isinstance(x, _Constrained) else None


def _shape(*dims):
    return jax.ShapeDtypeStruct(dims, jnp.float32)


#: [B, S, d] shapes: everything divisible, and d, S or B not (the
#: reference's fallbacks, rules.py:344-352), on the debug meshes (model
#: 2, batch 2 or 4) and the production meshes (model 16)
RESIDUALS = ((8, 64, 256), (8, 64, 255), (8, 63, 256), (3, 64, 256),
             (3, 63, 255), (32, 4096, 4096), (32, 4096, 4100),
             (32, 4100, 4096), (30, 4096, 4096))


@pytest.mark.parametrize("pol", ["default", "act_seq", "dp2d",
                                 "act_model=False"])
def test_activation_specs_equal_the_reference(pol, policy, hooks):
    """``activation_spec`` and the residual stream's ``constrain`` spec
    (``rules.residual_spec``) against the reference's on the four
    stand-in meshes, at shapes whose feature, sequence or batch dims do
    not divide (its fallbacks), with ``model_axis_ok`` on and off; the
    block input's (``block_gather``) and the attention hooks' specs
    (``attn_heads`` with and without ``repeat_kv``, ``attn_seq``) too."""
    base = {"default": {}, "act_seq": {"act_seq": True},
            "dp2d": {"dp2d": True},
            "act_model=False": {"act_model": False}}[pol]
    policy(**base)
    for name in MESHES:
        mesh = stand_in(name)
        for ndim in (2, 3, 4):
            for ok in (True, False):
                assert rules.activation_spec(mesh, ndim, ok) == _spec(
                    jrules.activation_spec(mesh, ndim, ok), ndim)
        for ok in (True, False):
            hooks(mesh, ok)
            for shape in RESIDUALS + ((8, 64),):
                assert rules.residual_spec(mesh, shape) == _ref_spec(
                    jrules.constrain(_shape(*shape)), len(shape)), \
                    (name, ok, shape)
        for gather in (False, True):
            policy(block_gather=gather)
            for shape in ((8, 64, 256), (8, 64)):
                assert rules.block_input_spec(mesh, len(shape)) == \
                    _ref_spec(jrules.gather_block_input(_shape(*shape)),
                              len(shape))
        policy(block_gather=False)
        for heads, rep_kv, seq in ((True, False, False), (True, True, False),
                                   (False, False, True)):
            policy(attn_heads=heads, repeat_kv=rep_kv, attn_seq=seq)
            for q, k in (((4, 64, 32, 96), (4, 64, 32, 96)),
                         ((4, 64, 56, 128), (4, 64, 8, 128)),
                         ((4, 63, 8, 64), (4, 63, 2, 64)),
                         ((4, 1, 8, 64), (4, 1, 2, 64))):
                ref = jrules.attn_head_shard(_shape(*q), _shape(*k),
                                             _shape(*k))
                want = (_ref_spec(ref[0], 4), _ref_spec(ref[1], 4)) \
                    if isinstance(ref[0], _Constrained) else None
                assert rules.attn_head_specs(mesh, q, k) == want, \
                    (name, heads, rep_kv, q, k)
                ref = jrules.attn_seq_shard(_shape(*q), _shape(*k),
                                            _shape(*k))
                want = (_ref_spec(ref[0], 4), _ref_spec(ref[1], 4)) \
                    if isinstance(ref[0], _Constrained) else None
                assert rules.attn_seq_specs(mesh, q) == want, (name, seq, q)
        policy(attn_heads=False, repeat_kv=False, attn_seq=False)


def test_model_axis_ok_is_read(policy, hooks):
    """``set_activation_mesh(model_axis_ok=False)`` is taken and read:
    the residual stream's spec loses its model axis, as the reference's
    does; without a mesh, and on a plain tensor under one, every hook is
    the identity."""
    mesh = stand_in("single")
    hooks(mesh, False)
    assert not rules.model_axis_ok()
    assert rules.activation_mesh() is mesh
    for shape in RESIDUALS:
        got = rules.residual_spec(mesh, shape)
        assert got == _ref_spec(jrules.constrain(_shape(*shape)), 3)
        assert got[1:] == (None, None)
    hooks(mesh, True)
    assert rules.model_axis_ok()
    assert rules.residual_spec(mesh, (32, 4096, 4096)) == \
        ("data", None, "model")
    x = torch.ones(2, 4, 8)
    q = torch.ones(2, 32, 16, 8)
    policy(block_gather=True, attn_seq=True, attn_heads=True)
    for m in (None, mesh):
        hooks(m)
        assert rules.constrain(x) is x
        assert rules.gather_block_input(x) is x
        assert rules.constrain_spec(x, ("data", None, "model")) is x
        assert all(a is q for a in rules.attn_seq_shard(q, q, q))
        assert all(a is q for a in rules.attn_head_shard(q, q, q))


#: each rank's share of the whole state on the (16, 16) mesh is under
#: 1 / this: xLSTM's sLSTM FFN width (2728) and whisper's vocabulary
#: (51865) do not divide the model axis, so those leaves shard over data
#: only
STATE_SHARE = {"phi3-mini-3.8b": 200, "yi-34b": 200, "mixtral-8x22b": 200,
               "qwen3-moe-235b-a22b": 200, "xlstm-1.3b": 8,
               "zamba2-1.2b": 200, "whisper-medium": 50,
               "llama-3.2-vision-11b": 200}


@pytest.mark.parametrize("arch", list(STATE_SHARE))
def test_per_rank_state_bytes_equal_the_reference(arch):
    """``specs.state_bytes`` on the single-pod production mesh: each
    rank's params, grads and float32 moments from the meta device's
    shapes and the port's placements, against the reference's
    ``NamedSharding.shard_shape`` of its state's specs; and under
    :data:`STATE_SHARE`'s share of the whole state."""
    jcfg, cfg = _configs(arch)["full"]
    names, sizes = MESHES["single"]
    got = specs.state_bytes(cfg, stand_in("single"))
    jp = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": {
        "step": jax.ShapeDtypeStruct((), jnp.int32), "mu": jp, "nu": jp}}
    ref = jspecs.state_shardings(jstate, AbstractMesh(sizes, names))

    def local_bytes(tree, item=None):
        return sum(int(np.prod(sh.shard_shape(s.shape))) *
                   (item or s.dtype.itemsize) for sh, s in
                   zip(jax.tree.leaves(tree), jax.tree.leaves(jp)))
    assert got["params"] == got["grads"] == local_bytes(ref["params"])
    assert got["moments"] == 2 * local_bytes(ref["opt"]["mu"], 4)
    whole = sum(int(np.prod(s.shape)) * s.dtype.itemsize
                for s in jax.tree.leaves(jp))
    assert got["whole_params"] == got["whole_grads"] == whole
    assert got["whole_moments"] == 2 * 4 * sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(jp))
    assert got["params"] * STATE_SHARE[arch] < whole


@pytest.mark.parametrize("pol", ["default", "zero1"])
def test_state_shardings_equal_the_reference(pol, policy):
    """The train state's placements against the reference's
    ``NamedSharding``s on an ``AbstractMesh``: moments follow their
    params, or under ``zero1`` the forced FSDP specs; the step
    replicated."""
    policy(**POLICIES[pol])
    for arch in ("phi3-mini-3.8b", "mixtral-8x22b", "xlstm-1.3b",
                 "llama-3.2-vision-11b"):
        jcfg, cfg = _configs(arch)["full"]
        jp = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
        jstate = {"params": jp, "opt": {
            "step": jax.ShapeDtypeStruct((), jnp.int32), "mu": jp, "nu": jp}}
        shapes = specs._params_shape(build(cfg))
        for name in ("single", "multi"):
            names, sizes = MESHES[name]
            ref = jspecs.state_shardings(jstate, AbstractMesh(sizes, names))
            mesh = stand_in(name)
            got = specs.state_shardings(
                {"params": shapes, "opt": {"step": 0}}, mesh)
            assert got["opt"]["step"] == (Replicate(),) * len(names)
            for part, tree in (("params", got["params"]),
                               ("mu", got["opt"]["mu"]),
                               ("nu", got["opt"]["nu"])):
                jtree = ref["params"] if part == "params" else \
                    ref["opt"][part]
                want = {k: rules.placements(v, mesh) for k, v in
                        _jax_by_path(jax.tree.map(lambda s: s.spec, jtree),
                                     jp).items()}
                assert _port_by_path(tree) == want, (arch, name, part)
            if pol == "zero1":
                assert got["opt"]["mu"] != got["params"]
            assert specs.params_shardings(shapes, mesh) == got["params"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_repeat_kv_branch(dtype, policy):
    """``repeat_kv`` materialises the repeated KV heads; the output equals
    the grouped einsum's and the JAX branch's under the same policy
    (causal, a window, a cache length)."""
    rng = np.random.default_rng(5)
    B, Sq, Sk, Hq, Hkv, D = 2, 6, 9, 8, 2, 16
    q, k, v = (rng.normal(size=(B, s, h, D)).astype(np.float32)
               for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    for kw in (dict(causal=True), dict(causal=True, window=3, q_offset=3),
               dict(causal=False, kv_len=7)):
        grouped = gqa_attend(tq, tk, tv, **kw).float().numpy()
        policy(repeat_kv=True)
        got = gqa_attend(tq, tk, tv, **kw).float().numpy()
        ref = np.asarray(jax_gqa_attend(jq, jk, jv, **kw), np.float32)
        policy(repeat_kv=False)
        np.testing.assert_allclose(got, grouped, **tol)
        np.testing.assert_allclose(got, ref, **tol)


# ---------------------------------------------------------------------------
# the mesh builders and the train main, in one process
# ---------------------------------------------------------------------------


def test_mesh_builders_refuse_other_world_sizes(tmp_path):
    for build_mesh, need in ((make_production_mesh, 256),
                             (make_debug_mesh, 4)):
        with pytest.raises(ValueError, match=f"needs {need} ranks.*has 1"):
            build_mesh()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 512 ranks.*has 1"):
            make_production_mesh(multi_pod=True)
        with pytest.raises(ValueError, match="needs 8 ranks.*has 1"):
            make_debug_mesh(multi_pod=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch, fl", [
    (mesh_ranks.ARCH, False), (mesh_ranks.ARCH, True),
    (mesh_ranks.XLSTM_ARCH, False)] + [
        (arch, False) for arch, _, _ in mesh_ranks.FAMILIES],
    # "gathered": xLSTM, whose meshed step gathered the params whole
    # before its blocks split over the model axis
    ids=["False", "True", "gathered", "zamba2", "whisper", "vlm"])
def test_meshed_step_on_one_rank_is_the_one_device_step(arch, fl, tmp_path):
    """On a ``(1, 1)`` mesh of a one-rank group (``[lm mesh]``'s layout
    on the card), 2 meshed steps equal 2 one-device steps bit for bit:
    losses, grad norms and every param and moment; phi3-mini's train and
    FL steps, and the train steps of xLSTM, the Mamba2 hybrid, whisper
    and the VLM (with their stub inputs), each on the tensor-parallel
    path from a state built leaf by leaf."""
    cfg = reduced(get_config(arch))
    tcfg = mesh_ranks.TCFG
    model, step = (build_fl_train_step if fl else build_train_step)(cfg, tcfg)
    one = make_train_state(model, torch.Generator().manual_seed(0), tcfg)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        meshed = train.sharded_train_state(model, torch.device("cpu"), mesh)
        run = train.meshed_step(step, mesh)
        for b in mesh_ranks._batches(cfg, 2, fl=fl):
            one, m1 = step(one, b)
            meshed, m2 = run(meshed, b)
            assert (float(m1["loss"]), float(m1["grad_norm"])) == \
                (float(m2["loss"]), float(m2["grad_norm"]))
        whole = train.gather_state(meshed)
    finally:
        dist.destroy_process_group()
    for a, b in zip(tree_leaves(whole), tree_leaves(one)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 8, 512), (4, 16, 128), (1, 3, 7)])
def test_vocab_parallel_logsumexp_is_torch_logsumexp(shape, tmp_path):
    """``launch/steps.py::_LogSumExp`` (the vocab-parallel cross-entropy's
    logsumexp) on a one-rank group, forward and backward, bit for bit
    ``torch.logsumexp``'s, rows of -inf and +inf included."""
    from repro_torch.launch.steps import _LogSumExp
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 8)
    x[0, 0] = -float("inf")
    x[-1, -1, 0] = float("inf")
    g = torch.from_numpy(rng.standard_normal(shape[:-1]).astype(np.float32))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        a = x.clone().requires_grad_(True)
        got = _LogSumExp.apply(a, dist.group.WORLD)
        (ga,) = torch.autograd.grad(got, a, g)
    finally:
        dist.destroy_process_group()
    b = x.clone().requires_grad_(True)
    ref = torch.logsumexp(b, dim=-1)
    (gb,) = torch.autograd.grad(ref, b, g)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # the infinite rows' gradients are NaN in both
    torch.testing.assert_close(ga, gb, rtol=0, atol=0, equal_nan=True)


#: the one-rank decode cases: each LM family's smoke config (phi3-mini's
#: and the VLM's with two KV heads, mixtral's with :data:`mesh_ranks.
#: OVER`)
SERVE_ONE_RANK = (mesh_ranks.ARCH, mesh_ranks.MOE_ARCH,
                  mesh_ranks.XLSTM_ARCH, "zamba2-1.2b", "whisper-medium",
                  "llama-3.2-vision-11b")


@pytest.mark.parametrize("arch", SERVE_ONE_RANK)
def test_meshed_serve_on_one_rank_is_the_one_device_serve(arch, tmp_path):
    """On a ``(1, 1)`` mesh of a one-rank group (``[lm mesh serve]``'s
    layout on the card), the meshed prefill (B 4 x S 8) and 4 meshed
    decode steps (from the prefill's greedy token, over a cache of 6
    that the steps' positions 4-7 wrap) equal the one-device
    ``build_prefill_step`` / ``build_serve_step`` bit for bit: the
    prefill's logits, every step's tokens and logits, and the cache, built
    sharded (``launch/train.py::sharded_decode_cache``) equal to
    ``decode_init``'s, every leaf in its own storage and placements
    after the steps."""
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    over = {} if arch in (mesh_ranks.XLSTM_ARCH, "zamba2-1.2b",
                          "whisper-medium") else mesh_ranks.OVER
    cfg = reduced(get_config(arch), **over)
    model, prefill = build_prefill_step(cfg)
    _, serve = build_serve_step(cfg)
    B, S, clen = 4, 8, 6
    batch = mesh_ranks._batches(cfg, 1, B=B, S=S, seed=9)[0]
    batch.pop("labels")
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    params = model.init(torch.Generator().manual_seed(0))
    one = prefill(params, batch)
    cache1 = model.decode_init(params, B, clen, extras=extras)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        mp = train.sharded_train_state(model, torch.device("cpu"),
                                       mesh)["params"]
        assert torch.equal(train.meshed_prefill_step(prefill, mesh)(
            mp, batch), one)
        cache = train.sharded_decode_cache(model, mp, B, clen, mesh,
                                           extras=extras)
        for a, b in zip(tree_leaves(cache), tree_leaves(cache1)):
            assert torch.equal(a.to_local(), b)
        kept = [(t.placements, t.to_local().data_ptr())
                for t in tree_leaves(cache)]
        run = train.meshed_serve_step(serve, mesh)
        tok = torch.argmax(one[:, -1], dim=-1).to(torch.int32)[:, None]
        for pos in range(4, 8):
            t1, cache1, l1 = serve(params, cache1, tok, pos, logits=True)
            t2, cache, l2 = run(mp, cache, tok, pos, logits=True)
            assert torch.equal(t2, t1) and torch.equal(l2.full_tensor(), l1)
            tok = t1
    finally:
        dist.destroy_process_group()
    assert kept == [(t.placements, t.to_local().data_ptr())
                    for t in tree_leaves(cache)]
    for a, b in zip(tree_leaves(cache), tree_leaves(cache1)):
        assert torch.equal(a.to_local(), b)


@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_vocab_parallel_argmax_is_torch_argmax(shards, tmp_path):
    """``launch/steps.py``'s vocab-parallel argmax: the vocab cut into
    ``shards`` even shards, each shard's (local max, global index)
    merged by ``argmax_merge``, equals ``torch.argmax`` over the whole
    vocab, with ties planted within a shard and across shards (the
    smallest index wins), rows of -inf, of +inf and with NaN (which
    wins, its first index); and ``vocab_argmax`` on a one-rank group is
    ``torch.argmax`` itself."""
    from repro_torch.launch.steps import argmax_merge, vocab_argmax
    rng = np.random.default_rng(shards)
    V = 60
    x = torch.from_numpy(rng.standard_normal((7, 3, V)).astype(np.float32))
    x[0, 0, [5, 41, 59]] = 9.0           # a tie across shards
    x[0, 1, [12, 13]] = 9.0              # a tie within one shard
    x[0, 2, [30, 2]] = 9.0               # the later shard's first
    x[1, 0] = -float("inf")
    x[1, 1, [7, 50]] = float("inf")
    x[1, 2, 44] = float("nan")
    x[1, 2, 9] = float("inf")
    x[2, :, ::7] = 3.0                   # every shard holds the max
    x[2, :, 1::7] = 4.0
    n = V // shards
    vals, idx = [], []
    for r in range(shards):
        part = x[..., r * n:(r + 1) * n]
        i = torch.argmax(part, dim=-1)
        vals.append(torch.gather(part, -1, i[..., None])[..., 0])
        idx.append(i + r * n)
    got = argmax_merge(torch.stack(vals), torch.stack(idx))
    assert torch.equal(got, torch.argmax(x, dim=-1))
    assert got.dtype == torch.argmax(x, dim=-1).dtype
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        one = vocab_argmax(x, 0, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    assert torch.equal(one, torch.argmax(x, dim=-1))
    assert torch.equal(vocab_argmax(x, 0, None), torch.argmax(x, dim=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_cache_attention_is_the_one_device_attention(dtype, tmp_path):
    """Attention over a decode cache whose rows ``model`` shards
    (``layers._attend_cache_rows``), on a one-rank group's ``(1, 1)``
    mesh where the rank holds every row, equals the one-device
    ``gqa_attend``: in bf16 bit for bit, as the one-device softmax's
    probabilities are rounded to v's dtype before ``p @ v`` (an
    unrounded ``p`` differs in about 40% of the outputs), in float32
    within its rounding.  The 4-rank rows case holds the merge over
    several ranks."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.layers import _attend_cache_rows
    rng = np.random.default_rng(3)
    B, Hq, Hkv, D, clen, pos = 4, 8, 2, 64, 56, 39
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(getattr(torch, dtype))
               for s in ((B, 1, Hq, D), (B, clen, Hkv, D), (B, clen, Hkv, D)))
    kv_len = torch.tensor(pos + 1)
    one = gqa_attend(q, k, v, causal=False, q_offset=torch.tensor(pos),
                     kv_len=kv_len)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules.set_activation_mesh(mesh, model_axis_ok=False)
        K, V = (DTensor.from_local(t, mesh, [Replicate(), Shard(1)])
                for t in (k, v))
        got = _attend_cache_rows(q, K, V, kv_len).to_local()
    finally:
        rules.set_activation_mesh(None)
        dist.destroy_process_group()
    assert got.dtype == one.dtype
    if dtype == "bfloat16":
        assert torch.equal(got, one)
    else:   # e / sum(e) against torch.softmax: float32 rounding apart
        torch.testing.assert_close(got, one, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", [c[0] for c in mesh_ranks.DECODE])
def test_decode_cases_take_the_reference_layouts(case):
    """Each 4-rank decode case's cache (``torch_mesh_ranks.DECODE``: the
    smoke config with its overrides at B 4 and its cache length) has the
    reference's ``cache_specs`` on the ``(2, 2)`` debug mesh, and they
    shard the dims the case names over ``model`` (the layout it holds)."""
    label, arch, over, clen, layout, _ = next(
        c for c in mesh_ranks.DECODE if c[0] == case)
    jcfg, cfg = torch_lm.configs(arch, **over)
    B = mesh_ranks.DECODE_SHAPE[0]
    cache = specs.decode_inputs(build(cfg), cfg, _small_shape(B, clen))[0]
    jcache = jspecs.decode_inputs(jax_build(jcfg), jcfg,
                                  _small_shape(B, clen, jax_side=True))[0]
    mesh = stand_in("debug")
    ref = _jax_by_path(jrules.cache_specs(jcache, mesh), jcache)
    assert _port_by_path(rules.cache_specs(cache, mesh)) == ref
    for path, dim in layout.items():
        where = [d for d, e in enumerate(ref[path]) if e == "model"]
        assert where == ([] if dim is None else [dim]), (path, ref[path])


def test_meshed_state_is_freed_after_its_steps(tmp_path):
    """A tensor-parallel meshed state lives no longer than its last
    reference: after 2 steps and ``del``, no param or moment storage is
    left (a region's local view of a param must not become the param's
    own tensor with a grad_fn, which would tie the param and its graph
    in a cycle the collector cannot see)."""
    import gc
    import weakref
    cfg = reduced(get_config("phi3-mini-3.8b"))
    model, step = build_train_step(cfg, mesh_ranks.TCFG)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        state = train.sharded_train_state(model, torch.device("cpu"), mesh)
        run = train.meshed_step(step, mesh)
        for b in mesh_ranks._batches(cfg, 2):
            state, _ = run(state, b)
        refs = [weakref.ref(t) for t in tree_leaves(state)
                if not isinstance(t, int)]
        del state
        gc.collect()
        assert refs and all(r() is None for r in refs)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------


def _decode_inputs(jax_dir, arch, over):
    """``torch_lm.decode_runs``' JAX decode of ``arch`` (B 2 x S 12, with
    ``over``): its inputs (the converted params, the tokens, the stub
    inputs) written for the ranks; returns the JAX logits [B, S, V]."""
    _, jgot = torch_lm.decode_runs(arch, **over)[:2]
    jcfg, _ = torch_lm.configs(arch, **over)
    toks = torch_lm.tokens(jcfg, 2, jgot.shape[1], seed=4)
    part = jax_dir / f"{arch}-decode.part"
    torch.save({"params": torch_lm.both_params(jcfg, seed=3)[1],
                "tokens": torch.from_numpy(toks),
                "extras": torch_lm.as_torch(torch_lm.extras_np(jcfg, 2))},
               part)
    part.rename(jax_dir / f"{arch}-decode.pt")
    return jgot


def test_meshed_steps_under_four_ranks(tmp_path):
    """The rank program's checks (``torch_mesh_ranks.mesh_steps``); its
    meshed steps from the JAX package's params (``torch_lm.train_runs``'
    inputs, under the default policy and ``dp2d``) against the JAX
    package's live steps, and its meshed decode of phi3-mini's and
    xLSTM's smoke configs (``torch_lm.decode_runs``' inputs) against the
    JAX package's decode (logits at 1e-5, tokens equal); then its
    ``--ckpt-dir`` run, saved on the mesh
    after 2 steps and resumed to step 3 by the train main in this
    process, against the same run saved by one process and resumed so
    (the data stream restarts on a resume, as in the reference): the
    resumed step's loss and params at the step tolerances."""
    ck, jax_dir = tmp_path / "ck", tmp_path / "jax"
    jax_dir.mkdir()
    jax_losses, jax_decoded = {}, {}
    # the ranks run their step checks while this process runs the JAX
    # package's steps; they read each arch's inputs once its file is in
    ctx = ranks.start(mesh_ranks.mesh_steps, tmp_path, str(ck), str(jax_dir))
    try:
        for arch, _ in mesh_ranks.JAX_ARCHS:
            runs = torch_lm.train_runs(arch, steps=2, B=4, S=32, seed=7)
            jcfg, _ = torch_lm.configs(arch)
            part = jax_dir / f"{arch}.part"
            torch.save({"params": torch_lm.both_params(jcfg, seed=7)[1],
                        "batches": [{k: torch.from_numpy(v)
                                     for k, v in b.items()}
                                    for b in runs["batches"]]}, part)
            part.rename(jax_dir / f"{arch}.pt")
            jax_losses[arch] = runs["jax"]
        for arch, over in mesh_ranks.JAX_DECODE:
            jax_decoded[arch] = _decode_inputs(jax_dir, arch, over)
    except BaseException:
        ranks.kill(ctx)
        raise
    ranks.wait(ctx, "mesh_steps", timeout=360.0)
    meshed = json.loads((jax_dir / "meshed.json").read_text())
    assert len(meshed) == sum(len(p) for _, p in mesh_ranks.JAX_ARCHS)
    for key, rows in meshed.items():
        # losses and grad norms at the LM tests' rtol
        np.testing.assert_allclose(rows, jax_losses[key.split()[0]],
                                   rtol=1e-5, atol=0, err_msg=key)
    decoded = torch.load(jax_dir / "meshed-decode.pt")
    assert set(decoded) == set(jax_decoded)
    for arch, (logits, nxt) in decoded.items():
        ref = jax_decoded[arch]
        np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-5,
                                   atol=1e-5, err_msg=arch)
        np.testing.assert_array_equal(nxt.numpy(), ref.argmax(-1),
                                      err_msg=arch)
    one = tmp_path / "one"
    train.train(reduced(get_config(mesh_ranks.ARCH)), mesh_ranks.CKPT_TCFG,
                batch=4, seq=16, steps=2, device=torch.device("cpu"),
                ckpt_dir=str(one))
    runs = [train.main(mesh_ranks.CKPT_ARGS + ["--ckpt-dir", str(d)])
            for d in (ck, one)]
    for r in runs:
        assert len(r["losses"]) == 1 and r["state"]["opt"]["step"] == 3
    np.testing.assert_allclose(runs[0]["losses"], runs[1]["losses"],
                               rtol=1e-5)
    for a, b in zip(tree_leaves(runs[0]["state"]["params"]),
                    tree_leaves(runs[1]["state"]["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=2.0 * 3 * 3e-4)
