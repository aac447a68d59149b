"""The GAN cell at tiny sizes for the CPU, and faults planted in the
program's GAN step, for the tests that see `correct` fail.

    python -m portbench.tests.tiny_gan [fault] [--full --seed n --seconds s]

runs the cell once (at tiny sizes on the CPU, or with `--full` at the
cell's own sizes on the card) and prints the result line."""

from __future__ import annotations

import copy

from portbench import harness

CELL = "v1_train_vocoder_gan"
# chip_smoke's TINY_VOCODER widths: a generator of 32 channels at rates 4 x 4,
# two periods and two scales of narrow discriminators
TINY_HIFIGAN = {"segment_size": 512, "hop_size": 16, "n_fft": 64, "win_size": 64,
                "num_mels": 8, "upsample_rates": [4, 4], "upsample_kernel_sizes": [8, 8],
                "upsample_initial_channel": 32, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 2]]}
TINY_DISCRIMINATORS = {"periods": [2, 3], "period_channels": [4, 8, 16, 16], "scales": 2,
                       "scale_layers": [[8, 15, 1, 1], [16, 41, 4, 4], [16, 5, 1, 1]]}


def config() -> dict:
    c = copy.deepcopy(harness.load_json(harness.HERE / "configs" / "hifigan_v1_gan.json"))
    c["hifigan"].update(TINY_HIFIGAN)
    c["discriminators"].update(TINY_DISCRIMINATORS)
    return c


def cell(**traffic) -> dict:
    c, _ = harness.load_cell(harness.benchmark(), CELL)
    c["traffic"].update(batch_size=2, corpus_size=8, warm_steps=2,
                        seconds={"median": 0.1, "sigma": 0.4, "min": 0.02, "max": 0.3},
                        voiced_s=[0.02, 0.08], gap_s=[0.01, 0.03], **traffic)
    return c


def context(seed: int = 12345, seconds: float = 0.5, **traffic):
    import time

    return harness.Context(cell=cell(**traffic), config=config(), seed=seed, seconds=seconds,
                           trace=False, device="cpu", started=time.perf_counter())


# --- faults planted in the program ---------------------------------------------------


def _wrap_optimizers(wrap):
    """`wrap(gen_opt, disc_opt)` on the optimizers of every train state made."""
    from masg_tpu_torch.train import vocoder

    orig = vocoder.make_optimizers

    def make_optimizers(*a, **k):
        gen_opt, disc_opt = orig(*a, **k)
        wrap(gen_opt, disc_opt)
        return gen_opt, disc_opt

    vocoder.make_optimizers = make_optimizers


def _fault_no_disc_update():
    """The discriminators' AdamW update skipped."""
    def wrap(gen_opt, disc_opt):
        disc_opt.step = lambda *a, **k: None

    _wrap_optimizers(wrap)


def _fault_stale_disc():
    """The generator's loss taken against the discriminators as they were
    before this step's update, which then lands after the generator's."""
    def wrap(gen_opt, disc_opt):
        d_step, g_step = disc_opt.step, gen_opt.step

        def gen_then_disc(*a, **k):
            g_step(*a, **k)
            d_step()

        disc_opt.step = lambda *a, **k: None
        gen_opt.step = gen_then_disc

    _wrap_optimizers(wrap)


def _fault_mel_40():
    """The mel loss weighted 40 instead of 45: both loss mels (the full band,
    `fmax_for_loss` null) scaled by 40 / 45, which scales their L1 gap."""
    from masg_tpu_torch.train import vocoder

    orig = vocoder.mel_spectrogram_hifigan

    def mel_spectrogram_hifigan(audio, *a, f_max=8000.0, **k):
        out = orig(audio, *a, f_max=f_max, **k)
        return out * (40.0 / 45.0) if f_max is None else out

    vocoder.mel_spectrogram_hifigan = mel_spectrogram_hifigan


def _fault_half():
    """Half of each batch left out: every loss a mean over the rest."""
    from masg_tpu_torch.train import vocoder

    orig = vocoder.make_vocoder_train_step

    def make_vocoder_train_step(*a, **k):
        step = orig(*a, **k)
        return lambda state, batch: step(state, batch[:batch.shape[0] // 2])

    vocoder.make_vocoder_train_step = make_vocoder_train_step


def _fault_no_power_iteration():
    """Spectral norm's power iteration skipped: sigma from the old u and v."""
    import torch
    from masg_tpu_torch.train import vocoder

    def forward(self, weight):
        mat = weight.flatten(1)
        return weight / torch.dot(self._u.clone(), torch.mv(mat, self._v.clone()))

    vocoder.SpectralNorm.forward = forward


FAULTS = {"no_disc_update": _fault_no_disc_update, "stale_disc": _fault_stale_disc,
          "mel_40": _fault_mel_40, "half": _fault_half,
          "no_power_iteration": _fault_no_power_iteration}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    import torch

    from portbench import run

    ap = argparse.ArgumentParser()
    ap.add_argument("fault", nargs="?", choices=sorted(FAULTS))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    if args.fault:
        FAULTS[args.fault]()
    bench = harness.benchmark()
    if args.full:
        c, cfg = harness.load_cell(bench, CELL)
        line = run.run_cell(CELL, c, cfg, args.seed, args.seconds, False, "cuda", bench,
                            time.perf_counter())
    else:
        ctx = context(seed=args.seed)
        line = run.run_cell(CELL, ctx.cell, ctx.config, ctx.seed, ctx.seconds, False, "cpu",
                            bench, ctx.started)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
