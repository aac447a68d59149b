"""The HiFi-GAN GAN step's spans and counters (`masg_tpu_torch.train.vocoder`,
`models.hifigan`) on the CPU at tiny widths: each step records its three
phases once, with the two AdamW updates as their children; the step and
sample counters; the generator's count of MRF stages run block by block;
the batch's copy to the device inside `data.to_device`; and losses and
parameters bit-identical with tracing on and off."""

import numpy as np
import pytest
import torch

from masg_tpu_torch.models.hifigan import HiFiGANGenerator
from masg_tpu_torch.train import vocoder as tv
from masg_tpu_torch.utils import profiling
import torch_port_support  # noqa: F401  (the port tests' thread count)

TINY = {"segment_size": 512, "hop_size": 16, "n_fft": 64, "win_size": 64, "num_mels": 8,
        "sampling_rate": 22050, "fmin": 0, "fmax": 8000, "fmax_for_loss": None,
        "learning_rate": 2e-4, "adam_b1": 0.8, "adam_b2": 0.99, "lr_decay": 0.999,
        "upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
        "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1, 2]], "mpd_periods": [2, 3],
        "mpd_channels": [4, 8, 16, 16], "msd_scales": 2,
        "msd_layers": [[8, 15, 1, 1], [16, 41, 4, 4], [16, 5, 1, 1]]}
B, STEPS = 2, 3
PHASES = ["vocoder_train.generator", "vocoder_train.disc_update", "vocoder_train.gen_update"]


@pytest.fixture(autouse=True)
def fresh():
    profiling.clear()
    yield
    profiling.clear()


def batches():
    rng = np.random.default_rng(0)
    t = np.arange(TINY["segment_size"]) / 22050
    out = []
    for _ in range(STEPS):
        f0 = rng.uniform(100, 300, (B, 1))
        out.append(torch.from_numpy((0.5 * np.sin(2 * np.pi * f0 * t)
                                     + 0.02 * rng.normal(size=(B, t.size))).astype(np.float32)))
    return out


def train(record: bool):
    state = tv.init_vocoder_train_state(TINY, 2, seed=5)
    step = tv.make_vocoder_train_step(TINY)
    losses = []
    for y in batches():
        if record:
            with profiling.recording():
                _, m = step(state, y)
        else:
            _, m = step(state, y)
        losses.append(torch.stack(list(m)))
    params = [p.detach().clone() for m in (state.generator, state.mpd, state.msd)
              for p in m.parameters()]
    return torch.stack(losses), params


def test_each_step_records_its_phases_and_two_optimizer_updates():
    train(record=True)
    spans = profiling.spans()
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in sorted(top, key=lambda s: s.start_ns)] == PHASES * STEPS
    by_id = {s.id: s for s in spans}
    opt = [s for s in spans if s.name == "vocoder_train.optimizer"]
    assert [by_id[s.parent].name for s in sorted(opt, key=lambda s: s.start_ns)] == \
        PHASES[1:] * STEPS
    for s in opt:
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert len(spans) == 5 * STEPS and all(s.stream_ms is None for s in spans)  # CPU: no stream
    c = profiling.counters()
    assert c == {"vocoder_train.steps": STEPS,
                 "vocoder_train.samples": STEPS * B * TINY["segment_size"],
                 "hifigan.plain_mrf_stages": STEPS * len(TINY["upsample_rates"])}


def test_the_generator_counts_the_stages_it_runs_block_by_block():
    mel = torch.zeros(1, 2, 80)
    with profiling.recording(), torch.no_grad():
        HiFiGANGenerator(fused_mrf=False)(mel)  # V1, as it trains: all 4 stages
        assert profiling.counters() == {"hifigan.plain_mrf_stages": 4}
        HiFiGANGenerator()(mel)  # V1 inference: C = 256, 128 block by block, 64, 32 fused
        assert profiling.counters() == {"hifigan.plain_mrf_stages": 6}
        HiFiGANGenerator(upsample_initial_channel=128)(mel)  # every stage fused: no count
        assert profiling.counters() == {"hifigan.plain_mrf_stages": 6}


@pytest.mark.cuda
def test_on_the_card_a_fused_generator_counts_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K4 has no CPU mode)")
    with torch.device("cuda"):
        gen = HiFiGANGenerator(upsample_initial_channel=128)
    with profiling.recording(), torch.no_grad():
        gen(torch.zeros(1, 4, 80, device="cuda"))
    assert profiling.counters().get("hifigan.plain_mrf_stages", 0) == 0


def test_a_batch_is_copied_to_the_device_inside_its_span():
    wav = np.linspace(-1, 1, B * TINY["segment_size"], dtype=np.float32).reshape(B, -1)
    mels = np.ones((B, 4, TINY["num_mels"]), np.float32)
    with profiling.recording():
        y = tv.batch_to_device(wav, "cpu")
        pair = tv.batch_to_device((mels, wav), "cpu")
    assert torch.equal(y, torch.from_numpy(wav)) and y.dtype == torch.float32
    assert [torch.equal(t, torch.from_numpy(a)) for t, a in zip(pair, (mels, wav))] == [True] * 2
    assert [s.name for s in profiling.spans()] == ["data.to_device"] * 2
    assert tv.batch_to_device(wav, "cpu") is not None and len(profiling.spans()) == 2  # off


def test_losses_and_parameters_are_bit_identical_with_tracing_on_and_off():
    on_losses, on_params = train(record=True)
    off_losses, off_params = train(record=False)
    assert torch.equal(on_losses, off_losses)
    assert all(torch.equal(a, b) for a, b in zip(on_params, off_params))
