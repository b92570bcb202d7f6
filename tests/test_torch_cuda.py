"""Port kernels on the card: each CUDA kernel against its plain version.

Marked ``cuda``; every test skips where no NVIDIA GPU is present (the
check runs inside the fixture, never at import).  On a GPU machine,
without ``tests/conftest.py``, which imports JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.tiered_gather import (  # noqa: E402
    paged_decode_attention)

pytestmark = pytest.mark.cuda
# q and k of std 1.5 peak the softmax, so outputs are O(1); the
# tolerance is at least two bf16 ulps of them, and a kernel that drops
# keys or mis-scales its running sums fails it
QK_STD = 1.5
TOL = dict(rtol=1.6e-2, atol=2e-3)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rnd(g, *shape, std=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * std).to(
        torch.bfloat16)


@pytest.mark.parametrize("H,KV,hd", [(32, 8, 128), (8, 8, 64), (16, 2, 64)])
def test_decode_attention_kernel(gen, H, KV, hd):
    B, S = 4, 96
    q, kc = _rnd(gen, B, H, hd, std=QK_STD), _rnd(gen, B, S, KV, hd,
                                                  std=QK_STD)
    vc = _rnd(gen, B, S, KV, hd)
    kv_len = torch.tensor([0, 1, 17, 96], dtype=torch.int32, device="cuda")
    n = build.LAUNCHES["decode_attention"]
    got = decode_attention(q, kc, vc, kv_len)
    torch.testing.assert_close(got, ref.decode_attention(q, kc, vc, kv_len),
                               **TOL)
    assert build.LAUNCHES["decode_attention"] == n + 1


def test_paged_decode_attention_kernel(gen):
    B, H, KV, hd, bt, nb = 3, 32, 8, 128, 16, 4
    q = _rnd(gen, B, H, hd, std=QK_STD)
    kp, vp = _rnd(gen, 10, bt, KV, hd, std=QK_STD), _rnd(gen, 10, bt, KV, hd)
    kn, vn = _rnd(gen, B, KV, hd, std=QK_STD), _rnd(gen, B, KV, hd)
    tbl = torch.tensor([[3, 1, 0, 0], [1, 1, 9, 2], [0, 0, 0, 0]],
                       dtype=torch.int32, device="cuda")
    lens = torch.tensor([20, 63, 0], dtype=torch.int32, device="cuda")
    got = paged_decode_attention(q, kp, vp, tbl, lens, kn, vn,
                                 block_tokens=bt)
    torch.testing.assert_close(
        got, ref.paged_decode_attention(q, kp, vp, tbl, lens, kn, vn), **TOL)


@pytest.mark.parametrize("Sq,Sk,H,KV,hd", [(512, 512, 32, 8, 128),
                                           (130, 259, 4, 4, 64),
                                           (96, 40, 8, 1, 128)])
def test_flash_attention_kernel(gen, Sq, Sk, H, KV, hd):
    q, k = _rnd(gen, 2, Sq, H, hd, std=QK_STD), _rnd(gen, 2, Sk, KV, hd,
                                                     std=QK_STD)
    v = _rnd(gen, 2, Sk, KV, hd)
    torch.testing.assert_close(flash_attention(q, k, v, causal=True),
                               ref.flash_attention(q, k, v, causal=True),
                               **TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rnd(gen, 2, 8, 32)                  # head_dim 32: not compiled
    cache = _rnd(gen, 2, 16, 2, 32)
    lens = torch.tensor([3, 4], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        decode_attention(q, cache, cache, lens)
    with pytest.raises(ValueError, match="dtype"):
        decode_attention(q.float(), cache, cache, lens)
