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
from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
from repro_torch.kernels.tiered_gather import (  # noqa: E402
    fused_expert_ffn, paged_decode_attention)

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


def test_fused_expert_ffn_kernel(gen):
    """qwen3-moe-30b-a3b's decode shapes: top-8 of a router softmax, one
    row with a duplicated expert, one padded row that repeats row 0; x
    of std 1 and weights at their init scales."""
    B, D, F, E, K = 4, 2048, 768, 128, 8
    x = _rnd(gen, B, D)
    x[3] = x[0]
    wg, wu = _rnd(gen, E, D, F, std=D ** -0.5), _rnd(gen, E, D, F,
                                                     std=D ** -0.5)
    wd = _rnd(gen, E, F, D, std=F ** -0.5)
    router = torch.randn(D, E, generator=gen, device="cuda") * D ** -0.5
    wts, ids = torch.topk(torch.softmax(x.float() @ router, -1), K)
    wts = wts / wts.sum(-1, keepdim=True)
    ids = ids.to(torch.int32)
    ids[1, K - 1] = ids[1, 0]
    n = build.LAUNCHES["fused_expert_ffn"]
    got = fused_expert_ffn(x, wg, wu, wd, ids, wts)
    assert build.LAUNCHES["fused_expert_ffn"] == n + 1
    torch.testing.assert_close(got, ref.expert_ffn(x, wg, wu, wd, ids, wts),
                               **TOL)
    assert torch.equal(got[3], got[0])


# fused_adam against its plain version, as chip_smoke.py holds it: the
# update master' - master (about lr = 3e-4 against masters of about
# 0.02, so a tolerance on master' alone would pass a kernel that skipped
# it) to 1e-6 of itself plus two fp32 ulps of the master (master' may
# round one ulp apart: PyTorch divides by a scalar through its
# reciprocal); m' and v' to 1e-6 of themselves plus 1e-6 of their rms
ADAM_KW = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
               b1c=1.0 - 0.9 ** 3, b2c=1.0 - 0.95 ** 3)


@pytest.mark.parametrize("shape,gdtype,offset", [
    ((48, 1600, 6400), torch.bfloat16, 0),   # gpt2-xl-offload mlp.w_up
    ((70001,), torch.float32, 0),            # vector loop and its tail
    ((70001,), torch.float32, 1),            # misaligned: scalar loop
    ((3, 5), torch.float16, 0),
])
def test_fused_adam_kernel(gen, shape, gdtype, offset):
    n = 1
    for d in shape:
        n *= d

    def draw(std, dtype=torch.float32):
        t = torch.randn(n + offset, generator=gen, device="cuda") * std
        return t.to(dtype)[offset:].view(shape)

    master, m, g = draw(0.02), draw(3e-4), draw(1e-3, gdtype)
    v = draw(1.0).square_().mul_(1.5e-7)
    # NaN in the blocks the outputs will reuse: an unwritten element fails
    poison = [torch.full((n,), float("nan"), device="cuda")
              for _ in range(3)]
    del poison
    before = build.LAUNCHES["fused_adam"]
    got = fused_adam(master, m, v, g, **ADAM_KW)
    assert build.LAUNCHES["fused_adam"] == before + 1
    want = ref.fused_adam(master, m, v, g, **ADAM_KW)
    eps32 = torch.finfo(torch.float32).eps
    for a, b, extra in ((got[0] - master, want[0] - master,
                         2 * eps32 * master.abs()),
                        (got[1], want[1], None), (got[2], want[2], None)):
        assert torch.isfinite(a).all()
        tol = 1e-6 * b.abs() + (extra if extra is not None
                                else 1e-6 * b.square().mean().sqrt())
        assert ((a - b).abs() <= tol).all()


def test_fused_adam_refuses_what_it_does_not_take(gen):
    x = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        fused_adam(x, x, x, x.double(), **ADAM_KW)
    with pytest.raises(ValueError, match="dtype"):
        fused_adam(x.half(), x, x, x, **ADAM_KW)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(8, 2, device="cuda")[:, 0]
        fused_adam(y, y, y, y, **ADAM_KW)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rnd(gen, 2, 8, 32)                  # head_dim 32: not compiled
    cache = _rnd(gen, 2, 16, 2, 32)
    lens = torch.tensor([3, 4], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        decode_attention(q, cache, cache, lens)
    with pytest.raises(ValueError, match="dtype"):
        decode_attention(q.float(), cache, cache, lens)
    w = _rnd(gen, 2, 20, 12)                  # D = 20: not a multiple of 8
    ids = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_expert_ffn(_rnd(gen, 2, 20), w, w, w.transpose(1, 2)
                         .contiguous(), ids, ids.float())
