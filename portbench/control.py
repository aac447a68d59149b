"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the nearest precision below the one the
configuration states (float32 with TF32 off -> TF32), and judged by the same
numbers as a run. It has to come out as not correct. Benchmark runs never
run it; it gives the upper readings from which the limits are set.

    python3 -m portbench.control --workload <name> --seeds 1 2 3

prints, per seed, each number the cell compares. Needs a CUDA device (TF32
exists only there).
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from portbench import build, harness, traffic
from portbench.drivers import serve, synth, train
from portbench.reference import fastspeech2 as ref_fs2
from portbench.reference import hifigan as ref_hifigan


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def synth_readings(cell: dict, config: dict, seed: int, device: str) -> Dict[str, float]:
    """The synth cell's numbers for the TF32 reference in the program's
    place, over the batches a run at `seed` would check."""
    t = cell["traffic"]
    fs2_sd, voc_sd = build.weights(config, seed, device)
    pool = synth._prior_pool(config, t, fs2_sd, seed)
    _, languages = build.speakers(config)
    batches = traffic.synth_batches(seed, t, config["n_symbols"], languages, len(pool))
    tf32(False)
    synth.calibrate_durations(config, fs2_sd, batches, pool, device)
    kept = {}
    hop = config["preprocess"]["stft"]["hop_length"]
    for i in synth.sample_indices(seed, t):
        inp = synth._inputs(config, batches[i % len(batches)], pool, fs2_sd, device)
        tf32(True)
        with torch.no_grad():
            r = ref_fs2.infer(fs2_sd, config["model"], inp["texts"], inp["src_lens"],
                              inp["accents"], inp["speaker_vec"], t["max_mel_len"])
            wav = ref_hifigan.to_int16(ref_hifigan.generate(voc_sd, config["vocoder"],
                                                            r.postnet_mel).cpu().numpy())
        tf32(False)
        out = SimpleNamespace(duration_rounded=r.duration, pitch_prediction=r.pitch,
                              energy_prediction=r.energy, postnet_mel=r.postnet_mel,
                              mel_len=r.mel_len)
        mel_len = r.mel_len.cpu().numpy()
        kept[i] = (out, mel_len, [w[:int(n) * hop] for w, n in zip(wav, mel_len)])
    checks = synth.compare(config, t, cell["limits"], fs2_sd, voc_sd, pool, batches, kept, device)
    return {c.name: c.value for c in checks}


def train_readings(cell: dict, config: dict, seed: int, device: str) -> Dict[str, float]:
    """The train cell's numbers for the TF32 reference in the program's
    place, over the three steps a run at `seed` would check."""
    t = cell["traffic"]
    fs2_sd, _ = build.weights(config, seed, device, vocoder=False)
    ds = train._dataset_class()(config, t, seed)
    stream = train._stream(ds, t, seed)
    first = [next(stream) for _ in range(train.CHECKED_STEPS)]
    seeds = [harness.seed_int(seed, i) for i in range(train.CHECKED_STEPS)]
    tf32(True)
    losses, grad, change = train.reference_readings(config, fs2_sd, first, seeds, device)
    tf32(False)
    prog = {"loss": losses, "grad": grad, "change": change}
    checks = train.compare(config, fs2_sd, first, seeds, prog, device, cell["limits"])
    return {c.name: c.value for c in checks}


def serve_readings(cell: dict, config: dict, seed: int, device: str) -> Dict[str, float]:
    """The serve cell's numbers for the TF32 reference in the program's
    place, over the requests a run at `seed` would check, each alone at its
    own text bucket and mel cap (the engine's rule: min(max_seq_len,
    round_up(12 x bucket, 128)))."""
    import io
    import wave

    t = cell["traffic"]
    ctx = harness.Context(cell=cell, config=config, seed=seed, seconds=30.0, trace=False,
                          device=device, started=0.0)
    tf32(False)
    fs2_sd, voc_sd, reqs, _, check = serve.traffic_of(ctx)
    hop = config["preprocess"]["stft"]["hop_length"]
    buckets = sorted(t["text_buckets"])
    caps = {L: min(config["model"]["max_seq_len"], -(-12 * L // 128) * 128) for L in buckets}
    seen, slots = {}, [{} for _ in reqs]
    for i in check:
        ids, acc, spk = reqs[i]
        n = len(ids)
        L = min(b for b in buckets if b >= n)
        a = acc if acc is not None else np.full(n, traffic.NO_ACCENT_ID)
        row = lambda x: torch.as_tensor(traffic.pad_rows([np.asarray(x)], L), device=device)
        tf32(True)
        with torch.no_grad():
            r = ref_fs2.infer(fs2_sd, config["model"], row(ids), torch.tensor([n], device=device),
                              row(a), fs2_sd["speaker_emb.weight"][spk][None], caps[L])
            wav = ref_hifigan.to_int16(ref_hifigan.generate(voc_sd, config["vocoder"],
                                                            r.postnet_mel).cpu().numpy())[0]
        tf32(False)
        out = SimpleNamespace(duration_rounded=r.duration, pitch_prediction=r.pitch,
                              energy_prediction=r.energy)
        seen[i] = (out, 0, caps[L], L)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(config["preprocess"]["audio"]["sampling_rate"])
            w.writeframes(wav[:min(int(r.mel_len[0]), caps[L]) * hop].tobytes())
        slots[i] = {"status": 200, "body": buf.getvalue()}
    engine = SimpleNamespace(mel_caps=caps, text_buckets=buckets)
    checks = serve.compare(config, t, cell["limits"], fs2_sd, voc_sd, reqs, check, seen, slots,
                           engine, device)
    return {c.name: c.value for c in checks}


READINGS = {"synth": synth_readings, "train": train_readings, "serve": serve_readings}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control needs a CUDA device", file=sys.stderr)
        return 2
    cell, config = harness.load_cell(harness.benchmark(), args.workload)
    rows: List[dict] = []
    for s in args.seeds:
        r = READINGS[cell["driver"]](cell, config, s, "cuda")
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": s, "control": r}), flush=True)
    worst = {k: min(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"workload": args.workload, "smallest_control_reading": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
