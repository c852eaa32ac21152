"""The port's transformer family against the JAX package's: the token
corpus (bit for bit), the parameter tree, the cost model, every exit's
logits, the DR-FL loss and its gradients, the written-out bucket program
against the JAX ``fl.batch.run_bucket``, and the slice as a whole: an
n=8 sync DR-FL + QMIX run against a live JAX ``RoundEngine`` run.

The port starts from JAX-made weights, converted leaf for leaf
(``params_from_jax``: the tree has no convolution kernels).  On the CPU
both sides run their oracles: the JAX family ``rmsnorm_ref`` and
``attention_ref``, the port the plain versions.

Tolerances: logits and the loss rtol=1e-5, atol=1e-5 (float32 reductions
in another order through four blocks, on logits of magnitude up to ~5);
gradients, bucket deltas and losses rtol=1e-4, atol=1e-5 (a backward pass
through four blocks, then SGD steps); the slice as in
``tests/test_torch_slice.py``: picks and model choices identical, accuracy
within one validation sample, energy, reward and final weights rtol=1e-4,
atol=1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.fl import batch as jbatch
from repro.fl import simulation as jsim
from repro.fl.engine import RoundEngine as JaxRoundEngine
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import params_from_jax
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import batch as tbatch
from repro_torch.fl import simulation as tsim
from repro_torch.fl.engine import RoundEngine
from repro_torch.models.family import get_family
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
FWD = dict(rtol=1e-5, atol=1e-5)
SGD = dict(rtol=1e-4, atol=1e-5)
WIDTH, HW = 0.25, 8


def _jax_params(width=WIDTH, seed=0, scale=0.5, lead=()):
    """A JAX transformer tree of numpy draws, shaped by the JAX family's
    init (``lead``: extra leading axes, e.g. a participant axis)."""
    shapes = jax.eval_shape(
        lambda k: jax_get_family("transformer").init(k, 10, width_mult=width,
                                                     hw=HW),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.normal(size=lead + s.shape) * scale
                                   ).astype(np.float32), shapes)


@pytest.mark.parametrize("n,vocab,seq,noise,seed", [
    (200, 10, 8, 1.0, 0), (64, 17, 32, 0.0, 3), (50, 10, 16, 4.0, 1)])
def test_token_corpus_is_the_jax_packages(n, vocab, seq, noise, seed):
    np.testing.assert_array_equal(
        tsyn.synthetic_lm_dataset(n, vocab, seed=seed),
        jsyn.synthetic_lm_dataset(n, vocab, seed=seed))
    tx, ty = tsyn.synthetic_token_dataset(n, vocab, seq, noise, seed)
    jx, jy = jsyn.synthetic_token_dataset(n, vocab, seq, noise, seed)
    assert tx.dtype == jx.dtype == np.int32
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    # the family hook serves the same corpus
    fx, fy = get_family("transformer").make_dataset(n, vocab, hw=seq,
                                                    noise=noise, seed=seed)
    np.testing.assert_array_equal(fx, jx)
    np.testing.assert_array_equal(fy, jy)


@pytest.mark.parametrize("width", [0.25, 1.0])
def test_init_tree_and_param_shapes_equal_jax(width):
    jfam, tfam = jax_get_family("transformer"), get_family("transformer")
    jp = jax.eval_shape(lambda k: jfam.init(k, 10, width_mult=width, hw=32),
                        jax.random.PRNGKey(0))
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(jp)]
    tp = tfam.init(torch.Generator().manual_seed(0), 10, width_mult=width)
    meta = tfam.param_shapes(10, width_mult=width)
    for tree in (tp, meta):
        assert [tuple(l.shape) for l in tree_leaves(tree)] == \
            [tuple(l.shape) for l in jax.tree.leaves(jp)], paths
    assert all(l.is_meta for l in tree_leaves(meta))
    if width == 1.0:     # the full width the slice runs on the card
        assert sum(l.numel() for l in tree_leaves(meta)) == 796968
        assert tfam.stack_template(tp).n_rows == 782


def test_cost_model_and_flops_equal_jax():
    jfam, tfam = jax_get_family("transformer"), get_family("transformer")
    assert tfam.cost_model(10) == jfam.cost_model(10)
    for m in range(4):
        for hw, width in ((32, 1.0), (8, 0.25), (16, 0.5)):
            assert tfam.flops_per_sample(m, hw, width) == \
                jfam.flops_per_sample(m, hw, width)


@pytest.fixture(scope="module")
def fwd_setup():
    jp = _jax_params()
    rng = np.random.default_rng(5)
    x = rng.integers(0, 10, size=(6, HW)).astype(np.int32)
    y = rng.integers(0, 10, size=(6,)).astype(np.int32)
    return jp, x, y


def test_apply_all_exits_matches_jax(fwd_setup):
    jp, x, _ = fwd_setup
    jouts = jax_get_family("transformer").apply_all_exits(jp, jnp.asarray(x))
    touts = get_family("transformer").apply_all_exits(params_from_jax(jp),
                                                      torch.tensor(x))
    assert len(touts) == len(jouts) == 4
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **FWD)


@pytest.mark.parametrize("model_idx", [0, 1, 3])
def test_drfl_loss_and_grads_match_jax(fwd_setup, model_idx):
    jp, x, y = fwd_setup
    jfam, tfam = jax_get_family("transformer"), get_family("transformer")
    jsub = jfam.submodel_params("drfl", jp, model_idx)
    jl, jg = jax.value_and_grad(jfam.loss_fn("drfl"))(
        jsub, jnp.asarray(x), jnp.asarray(y))
    tsub = tfam.submodel_params("drfl", params_from_jax(jp), model_idx)
    leaves = [l.requires_grad_() for l in tree_leaves(tsub)]
    tl = tfam.loss_fn("drfl")(tsub, torch.tensor(x), torch.tensor(y).long())
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), **FWD)
    for g, r in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SGD)


def test_stacked_forward_and_conversion_match_per_participant_jax():
    """Participant-stacked weights convert leaf for leaf; the written-out
    forward gives each participant its own JAX forward and loss."""
    P = 3
    jp = _jax_params(seed=7, lead=(P,))
    rng = np.random.default_rng(8)
    x = rng.integers(0, 10, size=(P, 4, HW)).astype(np.int32)
    y = rng.integers(0, 10, size=(P, 4)).astype(np.int32)
    tp = params_from_jax(jp)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.numpy(), j)
    tfam, jfam = get_family("transformer"), jax_get_family("transformer")
    touts = tfam.apply_all_exits_stacked(tp, torch.tensor(x))
    tloss = tfam.stacked_loss_fn(tp, torch.tensor(x), torch.tensor(y))
    for p in range(P):
        jpp = jax.tree.map(lambda a: a[p], jp)
        jouts = jfam.apply_all_exits(jpp, jnp.asarray(x[p]))
        for t, j in zip(touts, jouts):
            np.testing.assert_allclose(t[p].detach().numpy(), np.asarray(j),
                                       **FWD)
        jl = jfam.loss_fn("drfl")(jpp, jnp.asarray(x[p]), jnp.asarray(y[p]))
        np.testing.assert_allclose(tloss[p].item(), float(jl), **FWD)


def test_written_out_bucket_program_matches_jax_run_bucket():
    jfam = jax_get_family("transformer")
    gp = _jax_params(seed=1, scale=0.2)
    x, y = jsyn.synthetic_token_dataset(200, 10, HW, seed=2)
    # 2 steps, 1 step and 1 wrap-around step: T pads to 2, P to 4
    parts = [np.arange(0, 17), np.arange(17, 30), np.arange(30, 35)]
    bucket = jbatch.bucket_cohort([0, 1, 2], [2, 2, 2], parts, [5, 6, 7],
                                  [17.0, 13.0, 5.0], epochs=1, batch=8)[0]
    assert bucket.gather.shape == (4, 2, 8)
    jres = jbatch.run_bucket("drfl", gp, x, y, bucket, lr=0.05, family=jfam)
    tres = tbatch.run_bucket("drfl", params_from_jax(gp),
                             torch.tensor(x).long(), torch.tensor(y).long(),
                             bucket, lr=0.05, family="transformer")
    assert tres.weights == jres.weights == [17.0, 13.0, 5.0, 0.0]
    np.testing.assert_allclose(tres.losses, jres.losses, **SGD)
    got = tree_leaves(tres.stacked_delta)
    ref = jax.tree.leaves(jres.stacked_delta)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[:3].numpy(), np.asarray(r)[:3], **SGD)


# the slice as a whole: with seed 1 the second round trains submodels 0
# and 1, two buckets (3 clients padded to 4, and 1)
KW = dict(n_devices=8, n_rounds=3, participation=0.5, local_epochs=1,
          batch_size=16, n_train=400, hw=HW, width_mult=WIDTH, seed=1,
          model_family="transformer", client_executor="batched")


def _greedy(selector):
    selector.learner.cfg = dataclasses.replace(
        selector.learner.cfg, eps_start=0.0, eps_end=0.0)


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = jsim.FLConfig(**KW), tsim.FLConfig(**KW)
    jsel, jbuf = jsim._make_selector(jcfg, 4), jsim._make_buffer(jcfg)
    tsel = tsim._make_selector(tcfg, 4, device="cpu")
    tbuf = tsim._make_buffer(tcfg)
    tsel.learner.load_params(params_from_jax(jsel.learner.params))
    jp = jax_get_family("transformer").init(
        jax.random.PRNGKey(jcfg.seed), jcfg.num_classes,
        width_mult=jcfg.width_mult, hw=jcfg.hw)
    for sel in (jsel, tsel):
        _greedy(sel)
        sel.reset_episode()
    jhist = JaxRoundEngine(jcfg, jsel, jbuf).run()
    thist = RoundEngine(tcfg, tsel, tbuf, device="cpu",
                        global_params=params_from_jax(jp)).run()
    return jhist, thist, jsel, tsel


def test_slice_picks_and_models_identical(runs):
    jh, th, _, _ = runs
    assert len(th["participants"]) == 3
    assert th["participants"] == jh["participants"]
    assert th["model_choices"] == jh["model_choices"]
    assert sorted(set(th["model_choices"][1])) == [0, 1]
    assert th["n_aggregations"] == jh["n_aggregations"] == 3
    assert th["executor"] == "batched"


def test_slice_accuracy_within_one_validation_sample(runs):
    jh, th, _, _ = runs
    n_val = max(64, int(0.04 * KW["n_train"]))
    for a, b in zip(th["acc"], jh["acc"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1.0 / n_val + 1e-6)


def test_slice_energy_and_reward_allclose(runs):
    jh, th, _, _ = runs
    for key in ("energy", "reward", "round_time", "sim_time", "idle"):
        np.testing.assert_allclose(th[key], jh[key], **SGD, err_msg=key)
    assert th["alive"] == jh["alive"]


def test_slice_final_params_allclose(runs):
    jh, th, jsel, tsel = runs
    for g, r in zip(tree_leaves(th["params"]), jax.tree.leaves(jh["params"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **SGD)
    assert tsel.learner.updates == jsel.learner.updates == 2
    for g, r in zip(tree_leaves(tsel.learner.params),
                    tree_leaves(params_from_jax(jsel.learner.params))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **SGD)
