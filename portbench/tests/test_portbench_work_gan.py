"""work_gan.py's counts of the GAN step against counts made by hand at
small shapes, and its totals at config_v1's."""

import pytest

from portbench import harness, work, work_gan


def test_one_period_discriminator_by_hand():
    # period 2 over 12 samples: 6 rows of 2; (5, 1) convs 1->2->4 of stride
    # 3, padding 2 (rows 6 -> 2 -> 1), then 4->4 of stride 1, padding 2 (1
    # row), then conv_post 4->1 (3, 1): 2 flops a MAC, rows x period outputs
    d = {"period_kernel_size": 5, "period_stride": 3, "period_channels": [2, 4]}
    got = work_gan.period_convs(d, 2, 12, 1)
    assert got == [(2 * 1 * 2 * 5 * 2 * 2, True), (2 * 2 * 4 * 5 * 1 * 2, False),
                   (2 * 4 * 4 * 5 * 1 * 2, False), (2 * 4 * 1 * 3 * 1 * 2, False)]
    # 13 samples are padded to 14: 7 rows, 3 after the first conv; batch 3
    assert work_gan.period_convs(d, 2, 13, 3)[0] == (2 * 1 * 2 * 5 * 3 * 2 * 3, True)


def test_one_scale_discriminator_by_hand():
    # 10 samples: conv 1->4 k 3 (10 out), grouped 4->8 k 5 stride 2 groups 2
    # (5 out, 2 input channels a group), conv_post 8->1 k 3
    d = {"scale_layers": [[4, 3, 1, 1], [8, 5, 2, 2]]}
    assert work_gan.scale_convs(d, 10, 1) == [(2 * 1 * 4 * 3 * 10, True),
                                               (2 * 2 * 8 * 5 * 5, False),
                                               (2 * 8 * 1 * 3 * 5, False)]


def test_one_mrf_stage_by_hand():
    # conv_pre 3->4 k 7; up 4->2 k 4 stride 2 over 1 input frame; the MRF at
    # 2 channels, 2 samples: one unit of two 3-tap convs; conv_post 2->1 k 7
    h = {"upsample_initial_channel": 4, "num_mels": 3, "upsample_rates": [2],
         "upsample_kernel_sizes": [4], "resblock_kernel_sizes": [3],
         "resblock_dilation_sizes": [[1]]}
    assert work_gan.generator_convs(h, 1, 1) == [
        (2 * 3 * 4 * 7, True), (2 * 4 * 2 * 4, False), (2 * 2 * 2 * 6 * 2, False),
        (2 * 2 * 7 * 2, False)]


def test_a_mel_by_hand():
    # n_fft 8, hop 2: 8 samples padded by 3 each side give 4 frames of 5 bins
    h = {"n_fft": 8, "hop_size": 2, "num_mels": 2}
    assert work_gan.mel_flops(h, 8, 1) == 4 * (2.5 * 8 * 3 + 8 + 4 * 5 + 2 * 5 * 2)


def test_config_v1_step():
    config = harness.load_json(harness.HERE / "configs" / "hifigan_v1_gan.json")
    h = config["hifigan"]
    # the generator agrees with the synth cells' count, a frame at a time
    assert sum(f for f, _ in work_gan.generator_convs(h, 1, 1)) == \
        work.hifigan_flops_per_frame(h)
    parts = work_gan.step_parts(config, 16)
    assert parts["generator_forward"] == 16 * 32 * work.hifigan_flops_per_frame(h)
    assert parts["generator_forward"] == pytest.approx(314.4e9, rel=1e-3)
    fwd_d = sum(f for f, _ in work_gan.discriminator_convs(config["discriminators"], 8192, 16))
    assert fwd_d == pytest.approx(276.8e9, rel=1e-3)
    assert parts["gen_update_discriminators"] == 3 * fwd_d
    assert 5 * fwd_d < parts["disc_update"] < 6 * fwd_d
    assert work_gan.step_flops(config, 16) == pytest.approx(3.433e12, rel=1e-3)
