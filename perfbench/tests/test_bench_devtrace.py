"""Busy time is the union of device intervals: two streams that overlap
count once."""
from perfbench import devtrace


def test_union_of_two_overlapping_streams():
    # stream A: [0, 10), [20, 30); stream B (a copy): [5, 25)
    iv = [(0, 10), (20, 30), (5, 25)]
    assert devtrace.union_length(iv) == 30
    assert devtrace.union_length([(0, 10), (10, 12), (40, 41)]) == 13
    assert devtrace.gaps(iv + [(40, 50)], 0, 60) == [(30, 40), (50, 60)]


def test_summary_of_a_synthetic_trace():
    device = [("expert_up_kernel", 100, 200), ("Memcpy HtoD", 150, 300),
              ("flash_attention_kernel", 500, 600),
              ("expert_down_kernel", 900, 1200)]
    host = [("perfbench.decode", 0, 1000), ("aten::item", 300, 480),
            ("perfbench.prefill", 480, 700)]
    s = devtrace.summarize(device, host, (0, 1000))
    # busy: [100, 300) + [500, 600) + [900, 1000) inside the window
    assert abs(s["busy_s"] - 400e-9) < 1e-15
    assert abs(s["window_s"] - 1000e-9) < 1e-15
    assert abs(s["kernel_s"]["fused_expert_ffn"] - 200e-9) < 1e-15
    assert abs(s["kernel_s"]["flash_attention"] - 100e-9) < 1e-15
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps == {"perfbench.decode / python": 100e-9,
                    "perfbench.decode / aten::item": 200e-9,
                    "perfbench.prefill / python": 300e-9}
    assert s["breakdown"]["device_ops"][0] == ["Memcpy HtoD", 150e-9]
