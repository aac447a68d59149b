"""`vocoder_infer`'s length-bounded cut on the CPU: with `lengths`, the
generator runs over the mel's first `cut_frames` frames only, and the int16
rows equal those of the generator over the whole mel, trimmed, bit for bit;
without `lengths`, and for MelGAN, it runs over all of it; and the right-hand
radius R that `HiFiGANGenerator.right_context_frames` works out from the
layers bounds the receptive field measured from an impulse.

The bit-for-bit cases run in float64: the CPU's float32 convolutions round
by the signal's length (about 1e-6 of a sample here), which can move a
truncated int16 sample by one step, whereas the cut itself must change
nothing. Widths are cut down; R depends on kernels, strides and paddings,
not on widths."""

import functools

import numpy as np
import pytest
import torch

from masg_tpu_torch.infer.vocoder import (CUT_MULTIPLE, DEFAULT_HIFIGAN_CONFIG, Vocoder,
                                          build_generator, cut_frames,
                                          measure_receptive_field_frames, to_int16,
                                          vocoder_infer)
from masg_tpu_torch.models import melgan
from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
from masg_tpu_torch.utils import profiling
import torch_port_support  # noqa: F401  (the port tests' thread count)

T, HOP, R = 48, 256, 14  # R: V1's and V2's kernels, strides and paddings

# V1's first stages run block by block (cuDNN on the card), V2's every
# stage through `fused_mrf_stage` (its plain version here)
WIDTHS = {"v1": 256, "v2": 128}

# a small generator of other kernels, strides and dilations (hop 16)
CUSTOM = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
              resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 2)))


def seeded(gen):
    init_random_weights(gen, torch.Generator().manual_seed(1))
    return gen


@functools.lru_cache(maxsize=None)
def f64_vocoder(shape: str) -> Vocoder:
    cfg = dict(DEFAULT_HIFIGAN_CONFIG, upsample_initial_channel=WIDTHS[shape])
    return Vocoder(seeded(build_generator(cfg)).double())


@functools.lru_cache(maxsize=None)
def mel_and_whole(shape: str):
    """A (4, T) mel and the int16 rows of the generator over all of it."""
    mel = torch.randn(4, T, 80, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    with torch.inference_mode():
        whole = f64_vocoder(shape).generator(mel)
    return mel, to_int16(whole.float().numpy(), 32768.0)


# the batch's longest row, in frames, and the cut it gives at T = 48, m = 16
LONGEST = {"one_hop": (1, 16), "tight": (T - R - CUT_MULTIPLE, T - CUT_MULTIPLE),
           "below_edge": (T - R - 1, T), "at_edge": (T - R, T), "past_edge": (T - R + 1, T),
           "capacity": (T, T)}


@pytest.mark.parametrize("case", list(LONGEST))
@pytest.mark.parametrize("shape", list(WIDTHS))
def test_the_cut_keeps_every_kept_sample_bit_for_bit(shape, case):
    longest, want_cut = LONGEST[case]
    voc = f64_vocoder(shape)
    mel, whole = mel_and_whole(shape)
    lengths = [0, HOP, longest * HOP, longest * HOP - 77]
    assert voc.generator.right_context_frames() == R
    assert cut_frames(voc, T, lengths) == want_cut
    profiling.clear()
    with profiling.recording():
        rows = vocoder_infer(mel, voc, lengths)
    counts = profiling.counters()
    profiling.clear()
    assert counts["vocoder.samples"] == 4 * want_cut * HOP
    assert counts.get("vocoder.cut_frames", 0) == 4 * (T - want_cut)
    assert [len(r) for r in rows] == lengths
    for got, row, n in zip(rows, whole, lengths):
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, row[:n])
    assert np.abs(rows[2].astype(np.int32)).max() > 1000


@pytest.mark.parametrize("make", ["none", "melgan"])
def test_without_lengths_or_a_bound_the_generator_sees_the_whole_mel(make):
    if make == "none":
        voc, lengths, b = Vocoder(seeded(HiFiGANGenerator(upsample_initial_channel=32))), None, 2
    else:
        gen = melgan.MelGANGenerator(ngf=4)
        melgan.init_random_weights(gen, torch.Generator().manual_seed(1))
        voc, lengths, b = Vocoder(gen), [HOP, 0], 2
    frames = 40
    assert cut_frames(voc, frames, lengths) == frames
    mel = torch.randn(b, frames, 80, generator=torch.Generator().manual_seed(3))
    profiling.clear()
    with profiling.recording():
        rows = vocoder_infer(mel, voc, lengths)
    counts = profiling.counters()
    profiling.clear()
    assert counts["vocoder.samples"] == b * frames * HOP and "vocoder.cut_frames" not in counts
    assert [len(r) for r in rows] == (lengths or [frames * HOP] * b)


def test_negative_and_empty_lengths_are_not_cut():
    """Python's slice rule counts a negative length from the end of the
    whole row, so such a call is not cut."""
    voc = Vocoder(seeded(HiFiGANGenerator(upsample_initial_channel=32)))
    assert cut_frames(voc, 64, [HOP, -5]) == 64
    assert cut_frames(voc, 64, []) == 64
    assert cut_frames(voc, 64, np.array([HOP, 0])) == 16


@pytest.mark.parametrize("which", ["v1", "v2", "custom"])
def test_the_worked_out_radius_bounds_the_measured_field(which):
    if which == "custom":
        # 3 frames, x 4 + 2, + 10 (kernel 5 at dilations 1, 2), x 4 + 2,
        # + 10, + 3: 111 samples, 7 frames of 16, and the sample's own
        gen, hop, want = seeded(HiFiGANGenerator(**CUSTOM)), 16, 8
    else:
        published = 512 if which == "v1" else 128
        full = build_generator(dict(DEFAULT_HIFIGAN_CONFIG, upsample_initial_channel=published))
        assert full.right_context_frames() == R  # the published width, not run
        cfg = dict(DEFAULT_HIFIGAN_CONFIG, upsample_initial_channel=32)
        gen, hop, want = seeded(build_generator(cfg)), HOP, R
    rf = gen.right_context_frames()
    assert rf == want
    assert rf >= measure_receptive_field_frames(Vocoder(gen, hop_length=hop))
    # one frame fewer still gives the first n samples exactly (R counts a
    # sample's own frame); two fewer do not
    gen = gen.double()
    mel = torch.randn(2, 60, 80, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    with torch.inference_mode():
        whole = gen(mel)
        for longest in (5, 20):
            n = longest * hop
            exact = gen(mel[:, :longest + rf - 1])[:, :n]
            short = gen(mel[:, :longest + rf - 2])[:, :n]
            assert torch.equal(exact, whole[:, :n])
            assert not torch.equal(short, whole[:, :n])
