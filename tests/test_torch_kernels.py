"""Port kernels' plain versions (what the CPU runs in the kernels'
place) against the JAX kernels, run through ``repro.kernels.ops`` in
interpret mode, on the reference tests' shapes and edge cases."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (assert_close, BF16, FP32, normal,  # noqa: E402
                           to_torch)

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention as decode_kernel)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as flash_kernel)
from repro_torch.kernels.tiered_gather import (  # noqa: E402
    paged_decode_attention as paged_kernel)

BF16_NP = jnp.bfloat16


def _both(a):
    return jnp.asarray(a), to_torch(a)


# ------------------------- flash attention ---------------------------- #
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (1, 128, 128, 4, 4, 64),      # MHA square
    (2, 256, 256, 8, 2, 64),      # GQA
    (1, 384, 128, 4, 1, 32),      # MQA, Sq > Sk
    (2, 130, 259, 4, 4, 64),      # ragged (padding path)
])
def test_flash_attention_sweep(B, Sq, Sk, H, KV, hd):
    rs = np.random.RandomState(0)
    q = normal(rs, (B, Sq, H, hd), 0.5)
    k = normal(rs, (B, Sk, KV, hd), 0.5)
    v = normal(rs, (B, Sk, KV, hd), 0.5)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    got = ops.flash_attention(*map(to_torch, (q, k, v)), causal=True)
    assert got.shape == (B, Sq, H, hd)
    assert_close(got, want, FP32)


def test_flash_attention_bf16():
    rs = np.random.RandomState(1)
    q, k, v = (normal(rs, (1, 128, 4, 64), 0.5).astype(BF16_NP)
               for _ in range(3))
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    got = ops.flash_attention(*map(to_torch, (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, BF16)


def test_flash_matches_chunked_attention():
    """The plain flash version and the port's chunked attention compute
    the same function as the reference's chunked attention."""
    from repro.models.modules import chunked_attention as jchunked
    from repro_torch.models.modules import chunked_attention
    rs = np.random.RandomState(2)
    q = normal(rs, (2, 256, 8, 64), 0.3)
    k = normal(rs, (2, 256, 4, 64), 0.3)
    v = normal(rs, (2, 256, 4, 64), 0.3)
    want = jchunked(*map(jnp.asarray, (q, k, v)), causal=True,
                    chunk_q=64, chunk_kv=64)
    tq, tk, tv = map(to_torch, (q, k, v))
    assert_close(ops.flash_attention(tq, tk, tv, causal=True), want, FP32)
    assert_close(chunked_attention(tq, tk, tv, causal=True, chunk_q=64,
                                   chunk_kv=64), want, FP32)


def test_flash_noncausal_ragged_raises_like_reference():
    rs = np.random.RandomState(3)
    q = normal(rs, (1, 8, 2, 32))
    k = normal(rs, (1, 130, 2, 32))
    with pytest.raises(ValueError, match="non-causal"):
        jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(k), causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(to_torch(q), to_torch(k), to_torch(k),
                            causal=False)


# ------------------------- decode attention --------------------------- #
@pytest.mark.parametrize("B,S,H,KV,hd,blk", [
    (1, 256, 4, 4, 64, 128),
    (4, 512, 8, 2, 64, 256),
    (2, 1024, 16, 1, 128, 256),
])
def test_decode_attention_sweep(B, S, H, KV, hd, blk):
    rs = np.random.RandomState(4)
    q = normal(rs, (B, H, hd))
    kc = normal(rs, (B, S, KV, hd))
    vc = normal(rs, (B, S, KV, hd))
    kv_len = (np.arange(1, B + 1) * (S // (B + 1)) + 1).astype(np.int32)
    want = jops.decode_attention(*map(jnp.asarray, (q, kc, vc, kv_len)),
                                 block_k=blk)
    got = ops.decode_attention(*map(to_torch, (q, kc, vc, kv_len)))
    assert_close(got, want, FP32)


@pytest.mark.parametrize("kv_len", [0, 1, 15, 16, 17, 128])
def test_decode_attention_ragged_edges(kv_len):
    """Block edges, one live position, and kv_len = 0 (the reference
    then averages V over the whole padded cache)."""
    rs = np.random.RandomState(5)
    B, S, H, KV, hd = 2, 128, 8, 2, 32
    q = normal(rs, (B, H, hd))
    kc, vc = normal(rs, (B, S, KV, hd)), normal(rs, (B, S, KV, hd))
    lens = np.full((B,), kv_len, np.int32)
    want = jops.decode_attention(*map(jnp.asarray, (q, kc, vc, lens)),
                                 block_k=16)
    got = ops.decode_attention(*map(to_torch, (q, kc, vc, lens)))
    assert_close(got, want, FP32)


# ---------------------- paged decode attention ------------------------ #
def _paged_inputs(seed, B, H, KV, hd, bt, nb, num_blocks,
                  dtype=np.float32):
    rs = np.random.RandomState(seed)
    q = normal(rs, (B, H, hd), 0.3, dtype)
    kp = normal(rs, (num_blocks, bt, KV, hd), 0.3, dtype)
    vp = normal(rs, (num_blocks, bt, KV, hd), 0.3, dtype)
    tbl = rs.randint(0, num_blocks, (B, nb)).astype(np.int32)
    kn = normal(rs, (B, KV, hd), 0.3, dtype)
    vn = normal(rs, (B, KV, hd), 0.3, dtype)
    return q, kp, vp, tbl, kn, vn


def _paged_both(q, kp, vp, tbl, lens, kn, vn, bt):
    want = jops.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, tbl, lens, kn, vn)), block_tokens=bt)
    got = ops.paged_decode_attention(
        *map(to_torch, (q, kp, vp, tbl, lens, kn, vn)), block_tokens=bt)
    return got, want


@pytest.mark.parametrize("B,H,KV,hd,bt,nb,num_blocks", [
    (1, 4, 4, 64, 16, 2, 8),       # MHA, tiny pool
    (4, 8, 2, 64, 32, 4, 16),      # GQA
    (2, 16, 1, 32, 64, 3, 32),     # MQA, odd block count
])
def test_paged_decode_attention_sweep(B, H, KV, hd, bt, nb, num_blocks):
    q, kp, vp, tbl, kn, vn = _paged_inputs(0, B, H, KV, hd, bt, nb,
                                           num_blocks)
    lens = np.asarray([(i * 7 + 3) % (nb * bt) for i in range(B)],
                      np.int32)
    got, want = _paged_both(q, kp, vp, tbl, lens, kn, vn, bt)
    assert got.shape == (B, H, hd)
    assert_close(got, want, FP32)


@pytest.mark.parametrize("kv_len", [0, 31, 32, 33, 127])
def test_paged_decode_attention_block_boundaries(kv_len):
    B, H, KV, hd, bt, nb = 2, 4, 2, 32, 32, 4
    q, kp, vp, tbl, kn, vn = _paged_inputs(1, B, H, KV, hd, bt, nb, 8)
    lens = np.full((B,), kv_len, np.int32)
    got, want = _paged_both(q, kp, vp, tbl, lens, kn, vn, bt)
    assert_close(got, want, FP32)


def test_paged_decode_attention_shared_blocks_and_bf16():
    B, H, KV, hd, bt, nb = 3, 8, 2, 64, 16, 3
    q, kp, vp, _, kn, vn = _paged_inputs(2, B, H, KV, hd, bt, nb, 4,
                                         dtype=BF16_NP)
    tbl = np.asarray([[0, 1, 2], [2, 1, 0], [1, 1, 3]], np.int32)
    lens = np.asarray([40, 17, 5], np.int32)
    got, want = _paged_both(q, kp, vp, tbl, lens, kn, vn, bt)
    assert_close(got, want, BF16)


# ---------------------------- dispatch --------------------------------- #
def test_cpu_tensors_never_touch_launch_counters():
    before = dict(build.LAUNCHES)
    q, kp, vp, tbl, kn, vn = _paged_inputs(3, 2, 8, 2, 64, 16, 2, 4,
                                           dtype=BF16_NP)
    tq, tkp, tvp, ttbl, tkn, tvn = map(to_torch, (q, kp, vp, tbl, kn, vn))
    lens = torch.tensor([5, 20], dtype=torch.int32)
    ops.paged_decode_attention(tq, tkp, tvp, ttbl, lens, tkn, tvn,
                               block_tokens=16)
    cache = tkp.reshape(2, 32, 2, 64)
    ops.decode_attention(tq, cache, cache, lens)
    ops.flash_attention(cache[:, :, None, 0].repeat(1, 1, 4, 1), cache,
                        cache, causal=True)
    assert build.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    cache = torch.zeros(2, 32, 2, 64, dtype=torch.bfloat16)
    lens = torch.tensor([3, 4], dtype=torch.int32)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel(q, cache, cache, lens)
    pool = torch.zeros(4, 16, 2, 64, dtype=torch.bfloat16)
    tbl = torch.zeros(2, 2, dtype=torch.int32)
    new = torch.zeros(2, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel(q, pool, pool, tbl, lens, new, new, block_tokens=16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel(cache.repeat(1, 1, 4, 1), cache, cache)
    assert build.LAUNCHES == before


def test_plain_decode_takes_per_row_lengths():
    """ref.decode_attention applies a (B,) kv_len row by row (the JAX
    oracle broadcasts it; the reference test loops over rows)."""
    rs = np.random.RandomState(6)
    q = normal(rs, (3, 4, 16))
    kc, vc = normal(rs, (3, 32, 2, 16)), normal(rs, (3, 32, 2, 16))
    lens = np.asarray([3, 17, 32], np.int32)
    got = ref.decode_attention(*map(to_torch, (q, kc, vc, lens)))
    for i in range(3):
        row = ref.decode_attention(*map(to_torch, (q[i:i + 1], kc[i:i + 1],
                                                   vc[i:i + 1])), int(lens[i]))
        assert_close(got[i:i + 1], row, FP32)
