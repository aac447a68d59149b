"""work.py's counts against counts made by hand at small shapes."""

import pytest

from portbench import harness, work


def test_flash_forward_by_hand():
    # one row of 3 valid keys of 4, 1 head of width 2, f32: q.k and p.v over
    # 4 query rows x 3 keys x 2 dims, 2 flops a MAC each
    ops, nbytes = work.flash_work([3], 4, 1, 2, 4)
    assert ops == 2 * 2 * 4 * 3 * 2
    # q read + o written (4 x 2 x 4 B each), k and v valid rows (3 x 2 x 4 B
    # each), the LSE (4 x 4 B), the length (4 B)
    assert nbytes == 2 * 32 + 2 * 24 + 16 + 4


def test_flash_backward_by_hand():
    (k2_ops, k2_b), (k3_ops, k3_b) = work.flash_bwd_work([3], 4, 1, 2, 4)
    assert k2_ops == 3 * 2 * 9 * 2 and k3_ops == 4 * 2 * 9 * 2
    row = 8  # 2 dims x 4 B
    kv = 2 * 3 * row + 4
    assert k2_b == 4 * (3 * row + 8) + kv
    assert k3_b == 3 * (2 * row + 8) + kv + 4 * 2 * row


def test_mrf_stage_by_hand():
    # B 1, T 5, C 2, kernels (3,), 1 dilation: 2 convs of 3 taps
    ops, nbytes = work.mrf_work(1, 5, 2, [3], 1, 4)
    assert ops == 2 * 1 * 5 * 2 * 2 * 6
    assert nbytes == 2 * 5 * 2 * 4 + (6 * 4 + 2 * 2) * 4


def test_fft_and_fastspeech2_by_hand():
    model = {"transformer": {"encoder_hidden": 2, "conv_filter_size": 3,
                             "conv_kernel_size": [3, 1], "encoder_layer": 1, "decoder_layer": 1},
             "variance_predictor": {"filter_size": 2, "kernel_size": 3}}
    n, m = 4, 5
    fft = lambda t: 4 * 2 * 2 * 2 * t + 2 * 2 * t * t * 2 + 2 * 2 * 3 * 3 * t + 2 * 3 * 2 * 1 * t
    var = 3 * n * (2 * 2 * 2 * 3 + 2 * 2 * 2 * 3 + 2 * 2)
    post = 2 * m * 5 * (8 * 512 + 3 * 512 * 512 + 512 * 8)
    assert work.fs2_forward_flops(model, 8, n, m) == fft(n) + var + fft(m) + 2 * 2 * 8 * m + post


def test_hifigan_by_hand_and_v1():
    cfg = {"upsample_initial_channel": 4, "num_mels": 3, "upsample_rates": [2],
           "upsample_kernel_sizes": [4], "resblock_kernel_sizes": [3],
           "resblock_dilation_sizes": [[1]]}
    # conv_pre 3->4 k7; up 4->2 k4 stride 2 (2 out samples a frame); MRF 2x2
    # with 2 convs of 3 taps per sample; conv_post 2->1 k7
    want = 2 * 3 * 4 * 7 + 2 * 4 * 2 * 4 // 2 * 2 + 2 * 2 * 2 * 6 * 2 + 2 * 2 * 7 * 2
    assert work.hifigan_flops_per_frame(cfg) == want
    v1 = harness.load_json(harness.HERE / "configs" / "fs2_jvsvctk_hifigan_v1.json")["vocoder"]
    assert work.hifigan_flops_per_frame(v1) == pytest.approx(6.14e8, rel=0.01)
    assert work.mrf_stages(v1, 16, 1000) == [(16, 128000, 64), (16, 256000, 32)]


def test_peaks_and_bounds():
    assert work.bound_s(495e12, 0, "float32") == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)
