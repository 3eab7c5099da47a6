"""Port vs reference: K11's log-sum-exp and the merge of partial softmaxes
over disjoint slot ranges (context parallelism).

A decode step over a cache whose sequence is sharded over ranks runs K11
on each rank's range of slots and merges the partial results by their
log-sum-exps (``kernels/decode_attention.py:merge_partials`` on one rank,
``sharding/collectives.py:lse_merge`` over a group).  Here the plain
version of K11 (what the wrapper runs on CPU tensors) over 2 and 4 equal
slot shards, merged, is held against the plain version over the whole
cache and against the reference's oracle
``repro.kernels.ref.decode_attention_int8_ref`` (softcapped cases: the
reference's ``models.attention.decode_attention`` on the dequantized
cache, what its int8 decode branch runs).  Prefix, windowed, softcapped and
ring caches; a shard with no valid slot (it weighs 0); a row with no valid
slot anywhere (every shard weighs 1: the mean of V over all slots).

Tolerance: float32 q, rtol = atol = 1e-5 against the whole-cache plain
version (the merge adds one float32 rounding a shard) and the file's 2e-4
of ``test_torch_decode_attention.py`` against the reference; bfloat16 q,
one bfloat16 ulp (``bf16_close``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref as R_ref
from repro.models.attention import decode_attention as R_decode
from repro_torch.kernels import decode_attention as K11
from test_torch_decode_attention import TOL, bf16_close, f32

MERGE_TOL = dict(rtol=1e-5, atol=1e-5)
B, S, KV, G, Dh = 3, 64, 2, 3, 32

#: name -> (window, softcap, how key_pos is laid out)
CASES = {
    "prefix": (None, 0.0, "prefix"),
    "windowed": (24, 0.0, "prefix"),
    "softcap": (None, 30.0, "prefix"),
    "windowed_softcap": (16, 20.0, "ring"),
    "ring": (None, 0.0, "ring"),
    "empty_shard": (None, 0.0, "short"),
    "masked_row": (None, 0.0, "masked"),
}


def case_inputs(layout, seed=0):
    """Random codes and scales; ``key_pos`` by layout: ``prefix`` each
    row filled to a random length; ``ring`` a ring of ``S`` slots past
    its first lap (slot ``j`` holds the last position ``p`` with
    ``p % S == j``); ``short`` each row filled to under ``S / 4`` (so the
    last shards hold no valid slot); ``masked`` as ``prefix`` with row 1
    empty."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, Dh)).astype(np.float32)
    k_q = rng.integers(-127, 128, (B, S, KV, Dh)).astype(np.int8)
    v_q = rng.integers(-127, 128, (B, S, KV, Dh)).astype(np.int8)
    k_s = (rng.random((B, S, KV)) * 0.05).astype(np.float32)
    v_s = (rng.random((B, S, KV)) * 0.02).astype(np.float32)
    idx = np.arange(S)[None, :]
    if layout == "ring":
        q_pos = rng.integers(S, 3 * S, size=B).astype(np.int32)
        key_pos = q_pos[:, None] - ((q_pos[:, None] - idx) % S)
    else:
        hi = S // 4 if layout == "short" else S
        lens = rng.integers(2, hi, size=B)
        key_pos = np.where(idx < lens[:, None], idx, -1)
        q_pos = (lens - 1).astype(np.int32)
        if layout == "masked":
            key_pos[1] = -1
    return q, k_q, k_s, v_q, v_s, key_pos.astype(np.int32), \
        q_pos.astype(np.int32)


def as_port(arrays, q_dtype):
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = (torch.from_numpy(a)
                                             for a in arrays)
    return (q.to(q_dtype), k_q, k_s.to(torch.bfloat16), v_q,
            v_s.to(torch.bfloat16), key_pos, q_pos)


def sharded(args, shards, **kw):
    """The plain K11's ``(out, lse)`` on each of ``shards`` equal slot
    ranges."""
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = args
    n = S // shards
    return [K11.decode_attention_int8_plain(
        q, *(t[:, i * n:(i + 1) * n].contiguous()
             for t in (k_q, k_s, v_q, v_s, key_pos)), q_pos,
        return_lse=True, **kw) for i in range(shards)]


def reference(args, window, softcap):
    """The reference's result on the same (bfloat16-scaled) cache."""
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = (
        jnp.asarray(t.float().numpy()) if t.is_floating_point()
        else jnp.asarray(t.numpy()) for t in args)
    if softcap == 0.0:
        return R_ref.decode_attention_int8_ref(q, k_q, k_s, v_q, v_s,
                                               key_pos, q_pos, window=window)
    kf = k_q.astype(jnp.float32) * k_s[..., None]
    vf = v_q.astype(jnp.float32) * v_s[..., None]
    return R_decode(q[:, None], kf, vf, key_pos, q_pos, window=window,
                    softcap=softcap)[:, 0]


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_merged_shards_are_the_whole_cache(name, shards):
    """float32 q: the merged shards against the whole cache's plain K11 and
    the reference."""
    window, softcap, layout = CASES[name]
    args = as_port(case_inputs(layout), torch.float32)
    kw = dict(window=window, softcap=softcap)
    whole, lse = K11.decode_attention_int8_plain(*args, return_lse=True,
                                                 **kw)
    parts = sharded(args, shards, **kw)
    got = K11.merge_partials([o for o, _ in parts], [l for _, l in parts])
    assert got.dtype == torch.float32 and got.shape == whole.shape
    np.testing.assert_allclose(f32(got), f32(whole), **MERGE_TOL)
    np.testing.assert_allclose(f32(got), f32(reference(args, window,
                                                       softcap)), **TOL)
    assert torch.equal(whole, K11.decode_attention_int8_plain(*args, **kw))
    assert lse.shape == (B, KV, G) and lse.dtype == torch.float32
    if layout == "short":       # the last shards hold no valid slot
        assert (parts[-1][1] == K11.NEG_INF).all()
    if layout == "masked":      # a row with no valid slot anywhere
        assert (lse[1] == K11.NEG_INF).all()
        assert all((l[1] == K11.NEG_INF).all() for _, l in parts)
        mean_v = (args[3].float() * args[4].float()[..., None])[1].mean(0)
        np.testing.assert_allclose(f32(got[1]), f32(
            mean_v[:, None, :].expand(KV, G, Dh)), **MERGE_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lse_is_the_log_sum_exp_of_the_scores(name):
    """The plain version's LSE against ``torch.logsumexp`` of the masked,
    capped scores in float64 (``NEG_INF`` for a row with none valid)."""
    window, softcap, layout = CASES[name]
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = args = as_port(
        case_inputs(layout, seed=1), torch.float32)
    _, lse = K11.decode_attention_int8_plain(*args, window=window,
                                             softcap=softcap,
                                             return_lse=True)
    kf = k_q.double() * k_s.double()[..., None]
    s = torch.einsum("bkgd,bskd->bkgs", q.double() / np.sqrt(Dh), kf)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    if window is not None:
        valid &= key_pos > (q_pos[:, None] - window)
    want = torch.logsumexp(s.masked_fill(~valid[:, None, None, :],
                                         float("-inf")), dim=-1)
    want = torch.where(torch.isinf(want), torch.full_like(want, -1e30),
                       want)
    np.testing.assert_allclose(lse.double().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["prefix", "softcap", "masked_row"])
def test_bf16_merged_shards_within_one_ulp(name, shards):
    """bfloat16 q, as the attention's context-parallel branch runs it: each
    shard's K11 on q widened to float32 (the same scores; its output left
    in float32), merged in float32 and rounded to bfloat16 once — within
    one bfloat16 ulp of the whole cache's bfloat16 result, K11's rule.
    (Rounding each shard's output to bfloat16 before the merge would round
    twice.)"""
    window, softcap, layout = CASES[name]
    args = as_port(case_inputs(layout, seed=2), torch.bfloat16)
    kw = dict(window=window, softcap=softcap)
    whole = K11.decode_attention_int8_plain(*args, **kw)
    parts = sharded((args[0].float(),) + args[1:], shards, **kw)
    got = K11.merge_partials([o for o, _ in parts],
                             [l for _, l in parts]).to(torch.bfloat16)
    assert bf16_close(f32(got), f32(whole))


def test_the_wrapper_returns_the_lse_only_when_asked():
    args = as_port(case_inputs("prefix"), torch.float32)
    out = K11.decode_attention_int8(*args)
    pair = K11.decode_attention_int8(*args, return_lse=True)
    assert isinstance(out, torch.Tensor) and len(pair) == 2
    assert torch.equal(out, pair[0])
    assert torch.equal(pair[1], K11.decode_attention_int8_plain(
        *args, return_lse=True)[1])
