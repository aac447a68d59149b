"""Tiny configurations and mixes for driving the harness on the CPU."""

from __future__ import annotations

import copy

from portbench import harness

TINY_MODEL = {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
              "decoder_hidden": 64, "conv_filter_size": 128}


def config(name: str = "fs2_jvsvctk_hifigan_v1") -> dict:
    """A configuration at tiny widths: 2 + 2 FFT blocks of 64, predictors of
    64, a generator of 32 initial channels (its MRF stages at 16, 8, 4, 2,
    all on the fused path)."""
    c = copy.deepcopy(harness.load_json(harness.HERE / "configs" / f"{name}.json"))
    c["model"]["transformer"].update(TINY_MODEL)
    c["model"]["variance_predictor"]["filter_size"] = 64
    c["vocoder"]["upsample_initial_channel"] = 32
    c["n_speakers"], c["speakers"] = 12, {"ja": 6, "en": 6}
    return c


def cell(workload: str, **traffic) -> dict:
    """The cell `workload` of BENCHMARK.json at tiny sizes."""
    bench = harness.benchmark()
    c, _ = harness.load_cell(bench, workload)
    t = c["traffic"]
    if c["driver"] == "synth":
        t.update(batch_size=2, pool_batches=4, prior_per_meta=1, max_mel_len=96,
                 check_batches=2, check_from_first=2,
                 phones={"median": 8, "sigma": 0.5, "min": 3, "max": 12})
    elif c["driver"] == "serve":
        t.update(rate_per_s=8.0, text_buckets=[8, 16], max_batch=4, calibration_batch=4,
                 check_requests=3, wait_s=30.0,
                 phones={"median": 6, "sigma": 0.5, "min": 3, "max": 16})
    elif c["driver"] == "train":
        t.update(batch_size=2, group_size=2, corpus_size=16, warm_batches=8,
                 phones={"median": 8, "sigma": 0.5, "min": 3, "max": 12}, frames_per_phone=3)
    t.update(traffic)
    return c


def context(workload: str, seed: int = 12345, seconds: float = 0.5, **traffic):
    import time

    c = cell(workload, **traffic)
    cfg = config(c["config"])
    if c["driver"] == "train":
        cfg["model"]["max_seq_len"] = 40
    return harness.Context(cell=c, config=cfg, seed=seed, seconds=seconds, trace=False,
                           device="cpu", started=time.perf_counter())


# --- faults planted in the program, for the tests that see `correct` fail ------


def _fault_wav():
    """A sample of the first row altered where the wav is produced."""
    from masg_tpu_torch.infer import vocoder

    orig = vocoder.to_int16

    def to_int16(wav, max_wav_value):
        wav = wav.copy()
        wav[0, 100] += 0.25
        return orig(wav, max_wav_value)

    vocoder.to_int16 = to_int16


def _fault_duration():
    """One phone's duration altered in the output."""
    from masg_tpu_torch.infer import synthesis

    orig = synthesis.synthesize_batch

    def synthesize_batch(*a, **k):
        out = orig(*a, **k)
        d = out.duration_rounded.clone()
        d[0, 0] += 1
        return out._replace(duration_rounded=d)

    synthesis.synthesize_batch = synthesize_batch


def _fault_unchanged():
    """A train step that leaves the state as it was."""
    import torch
    from masg_tpu_torch.train import step

    def _update(state, total, mesh=None):
        state.step += 1
        return torch.zeros(())

    step._update = _update


def _fault_half():
    """Half of each batch left out: the loss is the mean over the rest."""
    from masg_tpu_torch.train import step

    orig = step.batch_to_device

    def batch_to_device(batch, device, dtype):
        out = orig(batch, device, dtype)
        n = out["speakers"].shape[0] // 2
        return {k: v[:n] for k, v in out.items()}

    step.batch_to_device = batch_to_device


FAULTS = {"wav": _fault_wav, "duration": _fault_duration, "unchanged": _fault_unchanged,
          "half": _fault_half}


def main(argv=None) -> int:
    """`python -m portbench.tests.tiny <workload> [fault]`: one run at tiny
    sizes on the CPU, the harness's look for a chip skipped, printing the
    result line as a benchmark run does. With `--full --seed n --seconds s`
    the run is the cell's own, on the card: the fault's reading at the
    cell's size."""
    import argparse
    import json
    import time

    import torch

    from portbench import run

    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
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
        cell, config = harness.load_cell(bench, args.workload)
        line = run.run_cell(args.workload, cell, config, args.seed, args.seconds, False, "cuda",
                            bench, time.perf_counter())
    else:
        ctx = context(args.workload)
        line = run.run_cell(args.workload, ctx.cell, ctx.config, ctx.seed, ctx.seconds, False,
                            "cpu", bench, ctx.started)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
