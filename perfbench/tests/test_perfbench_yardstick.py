"""The yardstick's operation and byte counts against values worked out by
hand at one shape, and the trace's arithmetic on a made-up timeline."""
import json

import pytest
from conftest import REPO

from perfbench.bench import yardstick
from perfbench.bench.trace import Trace, top


def model(name):
    return json.loads((REPO / "perfbench" / "configs" / f"{name}.json").read_text())["model"]


TINY = dict(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=9000, causal=True)


def test_tiny_prefill_by_hand():
    # q 64x64 + k 64x32 + v 64x32 + o 64x64 + MLP 3 x 64x128, two layers
    assert yardstick.matmul_weights_per_token(TINY) == 2 * (4096 + 2048 + 2048 + 4096 + 24576)
    # 2 x 73,728 weights x 16 tokens; the head 2 x 64 x 9,000 at 2 positions;
    # attention 2 layers x 2*2*8*8*4*32*0.5 = 16,384
    assert yardstick.prefill_flops(TINY, 2, 8) == 2_359_296 + 2_304_000 + 32_768
    assert yardstick.train_flops(TINY, 2, 8) == 3 * (2_359_296 + 2 * 64 * 9000 * 16 + 32_768)


def test_published_widths_by_hand():
    assert yardstick.matmul_weights_per_token(model("granite-3-8b")) == 7_969_177_600
    # 54 Mamba-2 blocks of 39,854,080 and 9 applications of the shared
    # block's 131,072,000 (q, k, v 2,560 -> 32 heads of 160, o back: 4 x
    # 13,107,200; the MLP 3 x 2,560 x 10,240)
    assert yardstick.matmul_weights_per_token(model("zamba2-2.7b")) == 3_331_768_320


def test_attention_call_by_hand():
    flops, nbytes = yardstick.attention_call_work(model("granite-3-8b"), 8, 2048)
    assert flops == 274_877_906_944            # 2 x 8 x 2048^2 x 32 x 256 / 2
    assert nbytes == 335_544_320               # bf16 q, o 32 heads, k, v 8 heads of 128
    assert yardstick.least_seconds(flops, nbytes) == pytest.approx(flops / 989e12)
    flops, nbytes = yardstick.attention_call_work(model("zamba2-2.7b"), 2, 4096)
    assert flops == 343_597_383_680            # 2 x 2 x 4096^2 x 32 x 320 / 2
    assert nbytes == 335_544_320               # bf16 q, k, v, o: 32 heads of 160


def test_ssd_intra_call_by_hand():
    flops, nbytes = yardstick.ssd_intra_call_work(model("zamba2-2.7b"), 2, 4096)
    # 64 chunks x (C B^T 2 x 128^2 x 64 + M x 128^2 x 80 x 64 + states 2 x 128 x 80 x 64 x 64)
    assert flops == 10_871_635_968
    # reads: x bf16, dt and log decay f32, B and C bf16; writes: y and states f32, decays
    assert nbytes == 91_226_112 + 251_678_720
    assert yardstick.least_seconds(flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_kernel_kinds():
    assert yardstick.kernel_kind("void flash_fwd_sm90_kernel<128, 1>(CUtensorMap)") == "flash_attention (#6)"
    assert yardstick.kernel_kind("ssd_intra_sm90_kernel<1, 1>") == "ssd_intra (#7)"
    assert yardstick.kernel_kind("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT") == "matmul (cuBLAS)"
    assert yardstick.kernel_kind("Memcpy DtoD (Device -> Device)") == "copies and casts"
    assert yardstick.kernel_kind("void at::native::vectorized_elementwise_kernel<4>") == "elementwise and other"


def test_trace_busy_idle_and_labels():
    tr = Trace(window=(0.0, 100.0), wall_s=1e-4,
               device=[(10.0, 30.0, "a"), (20.0, 40.0, "b"), (60.0, 70.0, "a"), (95.0, 120.0, "c")],
               spans=[(0.0, 50.0, "prefill")], ops=[(39.0, 45.0, "aten::mm")])
    assert tr.busy_intervals() == [(10.0, 40.0), (60.0, 70.0), (95.0, 100.0)]
    assert tr.busy_s == pytest.approx(45e-6)
    assert tr.idle_gaps() == [(0.0, 10.0), (40.0, 60.0), (70.0, 95.0)]
    assert tr.idle_by_label() == pytest.approx({"prefill": 10e-6, "prefill/aten::mm": 20e-6,
                                                "harness": 25e-6})
    assert tr.seconds_matching(["A", "c"]) == pytest.approx(55e-6)
    assert top(tr.seconds_by_name(), 2) == [["a", pytest.approx(30e-6)], ["c", pytest.approx(25e-6)]]


def test_device_only_trace_uses_the_host_clock():
    tr = Trace(window=None, wall_s=1e-4, device=[(10.0, 30.0, "a"), (20.0, 40.0, "b")], spans=[], ops=[])
    assert tr.window_s == 1e-4 and tr.busy_s == pytest.approx(30e-6)
