"""The LM half of the port's ``models/layers.py`` against the JAX
package's: ``gqa_attend`` (causal, windowed, non-causal, a decode row with
an offset and a cache length, per-row offsets and lengths, bfloat16),
``gqa_attend_chunked`` (and its fallback for lengths the chunk does not
divide), ``attention_apply`` (full, windowed, the kernel route, with QK
norms and biases, and cached decode with and without the ring buffer
wrapping), ``rmsnorm_apply`` and ``swiglu_apply``; and the initialisers
``layernorm_init`` and ``gelu_mlp_init`` that the enc-dec family stacks.

GQA is exercised: the inputs have 4 query heads over 2 KV heads
(``reduced(cfg, num_kv_heads=2)``; the smoke configs have Hkv = Hq).
Inputs are numpy draws from a seed given to both packages.  Tolerances:
float32 rtol 1e-5, atol 1e-5 (sums over the head dimension and the keys
in another order); bfloat16 2e-2 of the largest magnitude, the kernels'
bf16 tolerance (either side may round an output to the other side of a
bfloat16 step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers as TL
from torch_lm import configs

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
B, Hq, Hkv, D = 2, 4, 2, 16
# the JAX functions jitted: one compile a case in place of one an op
jax_attend = jax.jit(JL.gqa_attend, static_argnames=("causal", "window"))
jax_chunked = jax.jit(JL.gqa_attend_chunked,
                      static_argnames=("causal", "window", "chunk"))
jax_attention = jax.jit(JL.attention_apply, static_argnums=(1,),
                        static_argnames=("causal", "window", "use_pallas",
                                         "attn_chunk"))


def _draw(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _close(got, ref, dtype="float32"):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **F32)
    else:
        assert np.abs(got - ref).max() <= 2e-2 * max(np.abs(ref).max(), 1.0)


def _qkv(Sq, Sk, seed=0):
    return (_draw((B, Sq, Hq, D), seed), _draw((B, Sk, Hkv, D), seed + 1),
            _draw((B, Sk, Hkv, D), seed + 2))


def _both(arrays, dtype):
    """(jnp arrays, torch tensors) of numpy arrays in ``dtype``."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


ATTEND = {
    "causal": dict(Sq=12, Sk=12, causal=True),
    "window": dict(Sq=12, Sk=12, causal=True, window=5),
    "non-causal": dict(Sq=12, Sk=9, causal=False),
    "decode row": dict(Sq=1, Sk=16, causal=False, q_offset=7, kv_len=9),
    "per-row offsets": dict(Sq=3, Sk=16, causal=True, q_offset=[2, 9],
                            kv_len=[5, 12]),
    "window rows with no key": dict(Sq=6, Sk=6, causal=True, window=2,
                                    q_offset=[0, 4], kv_len=[3, 6]),
    "bf16": dict(Sq=12, Sk=12, causal=True, dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(ATTEND))
def test_gqa_attend_matches_jax(case):
    kw = dict(ATTEND[case])
    Sq, Sk, dtype = kw.pop("Sq"), kw.pop("Sk"), kw.pop("dtype", "float32")
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(Sq, Sk), dtype)
    jkw = {k: (jnp.asarray(v) if isinstance(v, list) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if isinstance(v, list) else v)
           for k, v in kw.items()}
    ref = jax_attend(jq, jk, jv, **jkw)
    got = TL.gqa_attend(tq, tk, tv, **tkw)
    assert got.dtype == getattr(torch, dtype)
    _close(got, ref, dtype)


@pytest.mark.parametrize("causal,window,S", [(True, 0, 64), (True, 24, 64),
                                             (False, 0, 64), (True, 0, 60)])
def test_gqa_attend_chunked_matches_jax(causal, window, S):
    """S 60 is no multiple of the chunk: both fall back to gqa_attend."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S, S, seed=3), "float32")
    ref = jax_chunked(jq, jk, jv, causal=causal, window=window, chunk=16)
    got = TL.gqa_attend_chunked(tq, tk, tv, causal=causal, window=window,
                                chunk=16)
    _close(got, ref)
    # the reference's own check (tests/test_models.py): chunked == plain
    np.testing.assert_allclose(
        got.numpy(), TL.gqa_attend(tq, tk, tv, causal=causal,
                                   window=window).numpy(),
        atol=1e-5, rtol=1e-4)


def _attention_params(jcfg, seed):
    shapes = jax.eval_shape(lambda k: JL.attention_init(k, jcfg, jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda s: (rng.normal(size=s.shape) / np.sqrt(
        s.shape[0])).astype(np.float32), shapes)
    return jp, lm_params_from_jax(jp)


APPLY = {
    "full": dict(),
    "window": dict(window=5),
    "kernel route": dict(use_pallas=True),
    "chunked": dict(attn_chunk=4),
    "qk norm and bias": dict(over=dict(qk_norm=True, attn_bias=True)),
}


@pytest.mark.parametrize("case", list(APPLY))
def test_attention_apply_matches_jax(case):
    """Self-attention without a cache, S 12; the kernel route runs the
    JAX Pallas kernel in interpret mode and the port's plain version."""
    kw = dict(APPLY[case])
    jcfg, tcfg = configs("minitron-8b", num_kv_heads=2,
                         **kw.pop("over", {}))
    jp, tp = _attention_params(jcfg, seed=4)
    x = _draw((B, 12, jcfg.d_model), 5)
    ref, _ = jax_attention(jp, jcfg, jnp.asarray(x), jnp.arange(12), **kw)
    got, cache = TL.attention_apply(tp, tcfg, torch.from_numpy(x),
                                    torch.arange(12), **kw)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **(dict(atol=2e-4, rtol=1e-3)
                                  if kw.get("use_pallas") else F32))


@pytest.mark.parametrize("clen,pos", [(16, 3), (8, 11), (8, 8)],
                         ids=["no wrap", "ring wrap", "ring wraps to 0"])
def test_decode_attention_matches_jax(clen, pos):
    """One token into a cache of ``clen`` rows (random entries) at ``pos``:
    the port writes its cache in place at ``pos % clen`` and advances
    ``pos``; the output, the cache and the new ``pos`` equal the JAX
    step's."""
    jcfg, tcfg = configs("minitron-8b", num_kv_heads=2)
    jp, tp = _attention_params(jcfg, seed=6)
    hd = jcfg.hd
    x = _draw((B, 1, jcfg.d_model), 7)
    ck, cv = _draw((B, clen, 2, hd), 8), _draw((B, clen, 2, hd), 9)
    jcache = {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
              "pos": jnp.int32(pos)}
    ref, jnew = jax_attention(jp, jcfg, jnp.asarray(x),
                              jnp.int32(pos)[None], cache=jcache)
    tcache = {"k": torch.from_numpy(ck.copy()),
              "v": torch.from_numpy(cv.copy()),
              "pos": torch.tensor(pos, dtype=torch.int32)}
    got, tnew = TL.attention_apply(tp, tcfg, torch.from_numpy(x),
                                   torch.tensor([pos]), cache=tcache)
    assert tnew is tcache
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jnew[k]),
                                   **F32)
    assert int(tcache["pos"]) == int(jnew["pos"]) == pos + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_swiglu_match_jax(dtype):
    jcfg, _ = configs("phi3-mini-3.8b")
    d, f = jcfg.d_model, jcfg.d_ff
    x = _draw((B, 5, d), 10)
    scale = 1.0 + 0.1 * _draw((d,), 11)
    mlp = {"w_gate": {"w": _draw((d, f), 12) / np.sqrt(d)},
           "w_up": {"w": _draw((d, f), 13) / np.sqrt(d)},
           "w_down": {"w": _draw((f, d), 14) / np.sqrt(f)}}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    ref = JL.rmsnorm_apply({"scale": jnp.asarray(scale).astype(jd)}, jx)
    got = TL.rmsnorm_apply({"scale": torch.from_numpy(scale).to(td)}, tx)
    assert got.dtype == td
    _close(got, ref, dtype)
    jm = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), mlp)
    tm = {k: {"w": torch.from_numpy(v["w"]).to(td)} for k, v in mlp.items()}
    _close(TL.swiglu_apply(tm, tx), JL.swiglu_apply(jm, jx), dtype)


def test_layernorm_and_gelu_mlp_init_keep_their_old_tensors():
    """The keywords the enc-dec stacks need (``dtype``, ``device``,
    ``lead``, ``bias``) default to what the old signatures made, bit for
    bit (the FL families' and the LM examples' params do not move): float32
    ones and zeros on the CPU, and the same generator draws with zero
    biases, in the JAX package's keys and shapes; ``lead`` stacks,
    ``dtype`` casts the same draws, ``bias=False`` drops the biases."""
    ln = TL.layernorm_init(8)
    assert torch.equal(ln["scale"], torch.ones((8,)))
    assert torch.equal(ln["bias"], torch.zeros((8,)))
    assert {k: v.shape for k, v in JL.layernorm_init(8, jnp.float32).items()} \
        == {k: tuple(v.shape) for k, v in ln.items()}
    stacked = TL.layernorm_init(8, dtype=torch.bfloat16, lead=(3,))
    assert stacked["bias"].shape == (3, 8)
    assert stacked["scale"].dtype == torch.bfloat16

    def gen():
        return torch.Generator().manual_seed(5)
    g = gen()
    old = {"w_in": TL.dense_bias_init(g, 8, 16),
           "w_out": TL.dense_bias_init(g, 16, 8, scale=0.25)}
    new = TL.gelu_mlp_init(gen(), 8, 16)
    ref = JL.gelu_mlp_init(jax.random.PRNGKey(0), 8, 16, jnp.float32)
    for k in ("w_in", "w_out"):
        assert sorted(new[k]) == sorted(old[k]) == sorted(ref[k]) == ["b", "w"]
        for leaf in ("w", "b"):
            assert new[k][leaf].dtype == torch.float32
            assert torch.equal(new[k][leaf], old[k][leaf])
            assert tuple(new[k][leaf].shape) == ref[k][leaf].shape
    half = TL.gelu_mlp_init(gen(), 8, 16, dtype=torch.bfloat16, bias=False)
    assert sorted(half["w_in"]) == ["w"]
    assert torch.equal(half["w_in"]["w"], old["w_in"]["w"].bfloat16())
    assert TL.gelu_mlp_init(gen(), 8, 16, lead=(2,))["w_out"]["b"].shape == \
        (2, 8)
