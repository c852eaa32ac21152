"""The LM examples' twins on the port (``examples/train_lm_torch.py``,
``examples/serve_lm_torch.py``) against the JAX package's
(``examples/train_lm.py``, ``examples/serve_lm.py``), on the CPU at the
examples' default size (width 0.25, seq 8):

* ``--local`` from one JAX init, converted: each round's per-client
  losses at rtol 1e-4, each exit's accuracy within one validation sample,
  the final weights at rtol 1e-4, atol 1e-5;
* a ``--ckpt`` written by the JAX ``train_lm`` decodes in
  ``serve_lm_torch`` to the JAX ``serve_lm``'s tokens at every exit, and
  so does the warm-up that runs without ``--ckpt`` (from one init);
* a ``--ckpt`` written by ``train_lm_torch`` loads in the JAX
  ``load_pytree``, leaf for leaf, and decodes alike in both.
"""
import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.fl import server as jserver
from repro.models.family import get_family as jax_get_family
from repro_torch.convert import params_from_jax
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
ROUNDS = 3
N_VAL = max(64, 1200 // 10)             # train_lm's validation split


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtrain, jserve = _example("train_lm"), _example("serve_lm")
ttrain, tserve = _example("train_lm_torch"), _example("serve_lm_torch")


def _jax_init():
    return jax_get_family("transformer").init(jax.random.PRNGKey(0), 10,
                                              width_mult=0.25, hw=8)


def _run_jax_local(monkeypatch, argv):
    """The JAX ``train_lm --local``, recording each round's losses and
    exit accuracies (it prints them rounded)."""
    fam = jax_get_family("transformer")
    losses, accs = [], []
    update = fam.client_update

    def client_update(*a, **kw):
        d, loss = update(*a, **kw)
        losses.append(float(loss))
        return d, loss

    def evaluate(*a, **kw):
        out = jserver.evaluate(*a, **kw)
        accs.append(np.asarray(out))
        return out
    monkeypatch.setattr(fam, "client_update", client_update)
    monkeypatch.setattr(jtrain, "fl_server", types.SimpleNamespace(
        aggregate_drfl=jserver.aggregate_drfl, evaluate=evaluate))
    jtrain.main(argv)
    monkeypatch.undo()
    return np.reshape(losses, (ROUNDS, -1)), np.stack(accs)


def test_local_rounds_match_jax(monkeypatch, tmp_path):
    ck = str(tmp_path / "jax.msgpack")
    jl, ja = _run_jax_local(monkeypatch, ["--local", "--rounds", str(ROUNDS),
                                          "--ckpt", ck])
    gp, rounds = ttrain.main(["--local", "--rounds", str(ROUNDS), "--device",
                              "cpu"], params=params_from_jax(_jax_init()))
    np.testing.assert_allclose([r["losses"] for r in rounds], jl, rtol=1e-4)
    np.testing.assert_allclose([r["accs"] for r in rounds], ja, rtol=0,
                               atol=1.0 / N_VAL + 1e-6)
    ref = jax.tree.leaves(jax_load_pytree(ck, _jax_init()))
    got = tree_leaves(gp)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def _jax_tokens(monkeypatch, argv):
    """The JAX ``serve_lm``'s tokens by exit."""
    out = {}
    decode = jserve.greedy_decode

    def recording(fam, params, prompt, gen, exit_idx, seq):
        out[exit_idx] = decode(fam, params, prompt, gen, exit_idx, seq)
        return out[exit_idx]
    monkeypatch.setattr(jserve, "greedy_decode", recording)
    jserve.main(argv)
    monkeypatch.undo()
    return out


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A ``--ckpt`` of the JAX ``train_lm --local`` after 2 rounds, written
    once for every case that decodes it."""
    ck = str(tmp_path_factory.mktemp("jax_ckpt") / "jax.msgpack")
    jtrain.main(["--local", "--rounds", "2", "--ckpt", ck])
    return ck


@pytest.mark.parametrize("exit_idx", [1, 2])
def test_jax_checkpoint_decodes_alike(monkeypatch, jax_checkpoint,
                                      exit_idx):
    """Exits {0, 1, 3} and {0, 2, 3}: every exit of the model."""
    argv = ["--ckpt", jax_checkpoint, "--exit", str(exit_idx)]
    ref = _jax_tokens(monkeypatch, argv)
    got = tserve.main(argv + ["--device", "cpu"])
    assert sorted(got) == sorted(ref) == sorted({0, exit_idx, 3})
    for m in ref:
        assert got[m][0] == ref[m], m


def test_warmup_decodes_alike(monkeypatch):
    """No ``--ckpt``: both run their warm-up rounds from one init."""
    argv = ["--train-rounds", "2"]
    ref = _jax_tokens(monkeypatch, argv)
    got = tserve.main(argv + ["--device", "cpu"],
                      params=params_from_jax(_jax_init()))
    assert {m: t for m, (t, _) in got.items()} == ref


def test_port_checkpoint_loads_in_jax(monkeypatch, tmp_path):
    ck = str(tmp_path / "port.msgpack")
    gp, _ = ttrain.main(["--local", "--rounds", "1", "--device", "cpu",
                         "--ckpt", ck])
    loaded = jax.tree.leaves(jax_load_pytree(ck, _jax_init()))
    got = tree_leaves(gp)
    assert len(got) == len(loaded)
    for g, r in zip(got, loaded):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ref = _jax_tokens(monkeypatch, ["--ckpt", ck])
    got = tserve.main(["--ckpt", ck, "--device", "cpu"])
    assert {m: t for m, (t, _) in got.items()} == ref
