"""The port's dense decoder against ``repro.models``: the same params
(carried across by ``repro_torch.convert``) and the same inputs (numpy,
seeded) through both packages' layers, ``prefill`` and ``decode_step``.

Tolerances: float32 1e-5 relative and absolute, element by element (the
two frameworks sum in different orders); bfloat16 2e-2 relative error in
the 2-norm of each compared tensor (XLA and PyTorch round bf16
intermediates at different places, and one bf16 ulp in the residual
stream — 0.8% — can move a single logit by a few ulps, so an
element-wise bound would be set by the rare outlier rather than by the
agreement of the whole).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.tree import flatten_with_paths

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_NORM_RTOL = 2e-2


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= BF16_NORM_RTOL, err


def _np(x):
    return np.asarray(jax.device_get(x), np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    jcfg = get_smoke_config("phi4-mini-3.8b").replace(dtype=dtype)
    tcfg = t_smoke_config("phi4-mini-3.8b").replace(dtype=dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return dtype, jcfg, tcfg, jparams, tparams


@pytest.fixture(params=["float32", "bfloat16"])
def pair(request):
    return _pair(request.param)


def test_param_paths_shapes_and_dtypes_match(pair):
    dtype, jcfg, tcfg, jparams, tparams = pair
    jleaves = {jax.tree_util.keystr(p): v for p, v in
               jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tleaves = dict(flatten_with_paths(tparams))
    assert list(jleaves) == list(tleaves)
    for path, v in jleaves.items():
        t = tleaves[path]
        assert tuple(t.shape) == tuple(v.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(v.dtype), path
        np.testing.assert_array_equal(
            convert.tree_to_numpy(t).view(np.uint8),
            np.asarray(v).view(np.uint8), err_msg=path)


def test_template_and_init_follow_the_reference():
    jcfg = get_smoke_config("phi4-mini-3.8b")
    tcfg = t_smoke_config("phi4-mini-3.8b")
    ab = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(JM.init_abstract(jcfg))[0]}
    params = TM.init_params(tcfg, seed=0, device="cpu")
    got = {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for p, v in flatten_with_paths(params)}
    assert got == {p: (tuple(v.shape), str(v.dtype)) for p, v in ab.items()}
    again = TM.init_params(tcfg, seed=0, device="cpu")
    other = TM.init_params(tcfg, seed=1, device="cpu")
    assert torch.equal(params["tok_emb"], again["tok_emb"])
    assert not torch.equal(params["tok_emb"], other["tok_emb"])
    assert TM.param_count(tcfg) == JM.param_count(jcfg)


def test_cache_spec_and_empty_cache_match():
    jcfg = get_smoke_config("phi4-mini-3.8b")
    tcfg = t_smoke_config("phi4-mini-3.8b")
    jc = JM.init_cache(jcfg, 3, 40)
    tc = TM.init_cache(tcfg, 3, 40, device="cpu")
    for name in ("k", "v", "pos"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        np.testing.assert_array_equal(convert.tree_to_numpy(tc[name]),
                                      np.asarray(jc[name]).view(
                                          np.uint16 if name != "pos"
                                          else np.int32))
    assert (tc["pos"] == -1).all()


@pytest.mark.parametrize("arch", ["recurrentgemma-9b"])
def test_other_families_wait_for_roadmap_a8(arch):
    """The hybrid family serves, but does not train (ROADMAP A8, hybrid
    training)."""
    cfg = t_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        TM.forward_train(cfg, TM.init_params(cfg, 0, "cpu"),
                         {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_match():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64).astype(np.float32)
    s = rng.randn(64).astype(np.float32) * 0.1
    b = rng.randn(64).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        TL.rmsnorm(_t(x), _t(s), 1e-6).numpy(),
        _np(JL.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6)), **F32)
    np.testing.assert_allclose(
        TL.layernorm(_t(x), _t(s), _t(b), 1e-5).numpy(),
        _np(JL.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                         1e-5)), **F32)


def test_rope_matches():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    pos = rng.randint(0, 900, size=(2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        TL.rope_apply(_t(x), _t(pos), 10_000.0).numpy(),
        _np(JL.rope_apply(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        **F32)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 5, 0.0), (True, 0, 30.0)])
@pytest.mark.parametrize("fn", ["dense_attention", "chunked_attention"])
def test_position_masked_attention_matches(fn, causal, window, softcap):
    """Including empty slots (pos == -1) and out-of-order kv positions,
    as a ring cache holds them."""
    rng = np.random.RandomState(2)
    B, Sq, Skv, Hkv, G, hd = 2, 3, 12, 2, 2, 16
    q = rng.randn(B, Sq, Hkv, G, hd).astype(np.float32)
    k = rng.randn(B, Skv, Hkv, hd).astype(np.float32)
    v = rng.randn(B, Skv, Hkv, hd).astype(np.float32)
    q_pos = np.array([[7, 8, 9], [3, 4, 5]], np.int32)
    kv_pos = rng.permutation(Skv).astype(np.int32)[None].repeat(B, 0)
    kv_pos[0, [1, 4]] = -1
    kv_pos[1, 7:] = -1
    kw = dict(causal=causal, window=window, softcap=softcap)
    if fn == "chunked_attention":
        kw["chunk"] = 5     # a ragged last chunk
    got = getattr(TL, fn)(_t(q), _t(k), _t(v), _t(q_pos), _t(kv_pos), **kw)
    want = getattr(JL, fn)(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                           **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_mlp_matches(pair):
    dtype, jcfg, tcfg, jparams, tparams = pair
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, jcfg.d_model).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ffn"])
    tp = {k: v[0] for k, v in tparams["layers"]["ffn"].items()}
    got = TL.mlp_forward(tcfg, tp, _t(x).to(tp["w_up"].dtype))
    want = JL.mlp_forward(jcfg, jp, jnp.asarray(x).astype(jp["w_up"].dtype))
    _close(got.float().numpy(), _np(want), dtype)


# ---------------------------------------------------------------------------
# the model: prefill + decode with a cache
# ---------------------------------------------------------------------------

def _cache_np(c):
    out = {}
    for k in ("k", "v", "pos"):
        v = c[k]
        if isinstance(v, torch.Tensor):
            out[k] = v.float().numpy() if k != "pos" else v.numpy()
        else:
            out[k] = _np(v) if k != "pos" else np.asarray(v)
    return out


def test_prefill_and_decode_match(pair):
    dtype, jcfg, tcfg, jparams, tparams = pair
    rng = np.random.RandomState(4)
    B, S, max_seq = 2, 9, 24
    toks = rng.randint(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)

    jl, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                        JM.init_cache(jcfg, B, max_seq))
    tl, tc = TM.prefill(tcfg, tparams, _t(toks),
                        TM.init_cache(tcfg, B, max_seq, device="cpu"))
    assert tuple(tl.shape) == (B, jcfg.vocab_size)
    _close(tl.float().numpy(), _np(jl), dtype)
    for k, want in _cache_np(jc).items():
        got = _cache_np(tc)[k]
        if k == "pos":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, dtype)

    for step in range(3):
        nxt = rng.randint(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = np.full(B, S + step, np.int32)
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        tl, tc2 = TM.decode_step(tcfg, tparams, tc, _t(nxt), _t(pos))
        assert tc2 is tc        # updated in place, not reallocated
        _close(tl.float().numpy(), _np(jl), dtype)
        got, want = _cache_np(tc), _cache_np(jc)
        np.testing.assert_array_equal(got["pos"], want["pos"])
        _close(got["k"], want["k"], dtype)
        _close(got["v"], want["v"], dtype)


def test_greedy_decode_agrees_in_float32():
    """Eight greedy steps from one prompt: the same tokens in both
    packages (float32, so the comparison is of the algorithm)."""
    dtype, jcfg, tcfg, jparams, tparams = _pair("float32")
    toks = np.array([[3, 5, 7, 11, 13]], np.int32)
    jl, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                        JM.init_cache(jcfg, 1, 32))
    tl, tc = TM.prefill(tcfg, tparams, _t(toks),
                        TM.init_cache(tcfg, 1, 32, device="cpu"))
    jt, tt = [int(jnp.argmax(jl[0]))], [int(torch.argmax(tl[0]))]
    for i in range(7):
        pos = np.array([5 + i], np.int32)
        jl, jc = JM.decode_step(jcfg, jparams, jc,
                                jnp.asarray([[jt[-1]]], jnp.int32),
                                jnp.asarray(pos))
        tl, tc = TM.decode_step(tcfg, tparams, tc,
                                torch.tensor([[tt[-1]]], dtype=torch.int32),
                                _t(pos))
        jt.append(int(jnp.argmax(jl[0])))
        tt.append(int(torch.argmax(tl[0])))
    assert tt == jt


def test_decode_from_the_jax_cache_carried_across(pair):
    """A KV cache the JAX package prefilled, carried across with
    ``convert.cache_from_numpy``, decodes in the port like in JAX."""
    dtype, jcfg, tcfg, jparams, tparams = pair
    rng = np.random.RandomState(6)
    toks = rng.randint(0, jcfg.vocab_size, size=(2, 7)).astype(np.int32)
    _, jc = JM.prefill(jcfg, jparams, jnp.asarray(toks),
                       JM.init_cache(jcfg, 2, 16))
    tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(
            convert.tree_to_numpy(tc[name]).view(np.uint8),
            np.asarray(jc[name]).view(np.uint8))
    nxt = rng.randint(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    pos = np.array([7, 7], np.int32)
    jl, _ = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt),
                           jnp.asarray(pos))
    tl, _ = TM.decode_step(tcfg, tparams, tc, _t(nxt), _t(pos))
    _close(tl.float().numpy(), _np(jl), dtype)
