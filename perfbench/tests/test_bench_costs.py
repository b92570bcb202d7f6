"""The frozen cost formulas against counts made by hand."""
import torch

from perfbench import devtrace
from perfbench.costs import kernels as k
from perfbench.costs import model, peaks
from perfbench.drivers import serve_continuous as sc


def test_expert_bytes_count_distinct_experts_once():
    D, F = 8, 4
    flops, nbytes = k.fused_expert_ffn(3, B=2, K=2, D=D, F=F)
    assert flops == 2 * 2 * 2 * 3 * D * F
    assert nbytes == 3 * (3 * D * F * 2) + 2 * 2 * D * 2 + 2 * 2 * 8


def test_recorded_expert_calls_count_distinct_ids():
    calls = sc.Calls.__new__(sc.Calls)
    calls.expert = [torch.tensor([[0, 1], [1, 0]]), torch.tensor([[2, 3],
                                                                   [4, 5]])]
    calls.expert_shape = (2, 2, 8, 4)
    calls.paged, calls.flash = [], []
    got = calls.bounds()["fused_expert_ffn"]
    want = (peaks.bound_s(*k.fused_expert_ffn(2, 2, 2, 8, 4))
            + peaks.bound_s(*k.fused_expert_ffn(4, 2, 2, 8, 4)))
    assert abs(got - want) < 1e-18


def test_causal_flash_counts_the_lower_triangle():
    flops, nbytes = k.flash_attention(1, 4, 4, H=2, KV=1, hd=8, causal=True)
    assert flops == 4 * 2 * 8 * (1 + 2 + 3 + 4)
    assert nbytes == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2
    full, _ = k.flash_attention(1, 4, 4, H=2, KV=1, hd=8, causal=False)
    assert full == 4 * 2 * 8 * 16


def test_paged_decode_reads_the_blocks_up_to_kv_len():
    flops, nbytes = k.paged_decode_attention([17, 0], 16, H=4, KV=2, hd=8)
    # row 0: 2 blocks of 16 tokens; row 1: none
    kv = 2 * 2 * 16 * 2 * 8 * 2
    per_row = 2 * 4 * 8 * 2 + 2 * 2 * 8 * 2 + 4
    assert nbytes == kv + 2 * 4 + 2 * per_row
    assert flops == 4 * 4 * 8 * (18 + 1)


def test_model_flops():
    m = {"d_model": 4, "n_heads": 2, "n_kv": 1, "head_dim": 2, "d_ff": 3,
         "act": "silu", "n_experts": 5, "top_k": 2, "n_layers": 3, "vocab": 7}
    per = 4 * 4 + 2 * 4 * 2 + 4 * 4 + 4 * 5 + 2 * 3 * 4 * 3
    assert model.layer_params(m) == per
    assert model.serve_flops(m, 10, 20, 2) == (2 * 3 * per * 10
                                               + 4 * 3 * 2 * 2 * 20
                                               + 2 * 4 * 7 * 2)


def test_bound_is_the_larger_of_compute_and_memory():
    assert peaks.bound_s(989e12, 0) == 1.0
    assert peaks.bound_s(0, 3.35e12) == 1.0


def test_kernel_names_map_to_entry_points():
    assert devtrace.kernel_of("void paged_decode_split_kernel<128>(...)") \
        == "paged_decode_attention"
    assert devtrace.kernel_of("decode_merge_kernel") == "decode_attention"
    assert devtrace.kernel_of("expert_down_kernel") == "fused_expert_ffn"
    assert devtrace.kernel_of("ampere_bf16_gemm") is None
