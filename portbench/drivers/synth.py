"""Offline text-to-wav batches, closed loop, back to back: the program's
`infer.synthesis.synthesize_batch` (free-running, to the cell's mel
capacity) then `infer.vocoder.vocoder_infer` trimmed to each row's
`mel_len * hop`, as the synthesis CLIs run them. Batches take the speaker
sources in turn: rows of the speaker table, or embeddings drawn from the
prior (`speaker_emb`).

`correct`: a sample of the window's batches, drawn from the seed, is worked
out again by the plain reference after the window. The program's discrete
choices (durations, pitch and energy bins) are judged by how far each lies
outside the interval that the reference's continuous value allows; the
reference then follows them, and the program's PostNet mel and int16 wav
are compared with its own.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import build, traffic, work
from portbench.harness import Check, Context, Outcome, Tracer
from portbench.reference import fastspeech2 as ref_fs2
from portbench.reference import hifigan as ref_hifigan


def _prior_pool(config: dict, t: dict, sd, seed: int) -> np.ndarray:
    metas = traffic.prior_rows(t)
    return ref_fs2.sample_prior(sd, metas, config["model"]["speaker_generation"]["GMM_mixtures"],
                                traffic.rng(seed, 2))


def calibrate_durations(config: dict, sd, batches, pool, device: str) -> None:
    """Sets the duration predictor's output bias (in place) so that the
    phones of the batches last `frames_per_phone` frames on average: random
    weights would move the mean, and the work with it, with the seed."""
    want = config["assumed"]["frames_per_phone"]
    key = "variance_adaptor.duration_predictor.linear_layer.bias"
    sd[key].zero_()
    zs = []
    for b in batches:
        inp = _inputs(config, b, pool, sd, device)
        with torch.no_grad():
            _, pad, log_d = ref_fs2.encode(sd, config["model"], inp["texts"], inp["src_lens"],
                                           inp["accents"], inp["speaker_vec"])
        zs.append(log_d[~pad].double())
    z = torch.cat(zs)
    sd[key].fill_(math.log(1.0 + want) - float(torch.logsumexp(z, 0) - math.log(len(z))))


def _inputs(config: dict, b: dict, pool, sd, device: str) -> Dict[str, torch.Tensor]:
    """The tensors of batch `b` on `device`, with its speaker vectors."""
    def ids(a):
        return torch.as_tensor(a, dtype=torch.long, device=device)

    out = {"texts": ids(b["texts"]), "src_lens": ids(b["src_lens"]), "accents": ids(b["accents"])}
    if b["source"] == "table":
        out["speaker_vec"] = sd["speaker_emb.weight"][ids(b["who"])]
    else:
        out["speaker_vec"] = torch.as_tensor(pool[b["who"]], device=device)
    return out


def sample_indices(seed: int, t: dict) -> List[int]:
    """The window's batches that are checked, drawn from the seed among the
    first `check_from_first`: half of each speaker source."""
    g = traffic.rng(seed, 4)
    first, half = t["check_from_first"], t["check_batches"] // 2
    return sorted(g.choice(np.arange(0, first, 2), half, replace=False).tolist()
                  + g.choice(np.arange(1, first, 2), half, replace=False).tolist())


def program_batch(config: dict, b: dict, pool) -> dict:
    """Batch `b` as the program's `synthesize_batch` takes it (numpy)."""
    out = {"texts": b["texts"].astype(np.int32), "src_lens": b["src_lens"].astype(np.int32),
           "accents": b["accents"].astype(np.int32)}
    if b["source"] == "table":
        out["speakers"] = b["who"].astype(np.int32)
        out["speaker_meta"] = build.speaker_meta(config, b["who"])
    return out


def run(ctx: Context) -> Outcome:
    from masg_tpu_torch.infer.synthesis import synthesize_batch
    from masg_tpu_torch.infer.vocoder import vocoder_infer
    from masg_tpu_torch.ops.fused_mrf import fused_mrf_stage
    from masg_tpu_torch.ops.attention import flash_attention

    config, t, dev = ctx.config, ctx.cell["traffic"], ctx.device
    hop = config["preprocess"]["stft"]["hop_length"]
    sr = config["preprocess"]["audio"]["sampling_rate"]
    cap = t["max_mel_len"]
    ctx.stamp("imported")
    fs2_sd, voc_sd = build.weights(config, ctx.seed, dev)
    pool = _prior_pool(config, t, fs2_sd, ctx.seed)
    _, languages = build.speakers(config)
    batches = traffic.synth_batches(ctx.seed, t, config["n_symbols"], languages, len(pool))
    calibrate_durations(config, fs2_sd, batches, pool, dev)
    ctx.stamp("calibrated")
    model = build.port_fs2(config, fs2_sd, dev)
    vocoder = build.port_vocoder(config, voc_sd, dev)
    ctx.stamp("built")
    feeds = [(program_batch(config, b, pool), pool[b["who"]] if b["source"] == "prior" else None)
             for b in batches]

    def text_to_wav(batch, emb):
        with ctx.span("text2mel"):
            out = synthesize_batch(model, batch, max_mel_len=cap, speaker_emb=emb)
            mel_len = out.mel_len.cpu().numpy()
        with ctx.span("vocoder"):
            wavs = vocoder_infer(out.postnet_mel, vocoder, mel_len * hop)
        return out, mel_len, wavs

    # warm up every (text width, speaker source) the pool holds
    seen = set()
    for feed, b in zip(feeds, batches):
        key = (b["texts"].shape[1], b["source"])
        if key not in seen:
            seen.add(key)
            text_to_wav(*feed)
    ctx.stamp("warm")
    sample = sample_indices(ctx.seed, t)
    kept: Dict[int, tuple] = {}
    n0 = {"K1": flash_attention.launches, "K4": fused_mrf_stage.launches}
    audio_s, rows, i = 0.0, [], 0
    with Tracer(ctx.trace) as tracer:
        ctx.window_opens()
        tracer.mark()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            b = batches[i % len(batches)]
            out, mel_len, wavs = text_to_wav(*feeds[i % len(feeds)])  # ends on the host
            audio_s += float(mel_len.sum()) * hop / sr
            rows.append((b["src_lens"], mel_len))
            if i in sample:
                kept[i] = (out, mel_len, wavs)
            i += 1
        window_s = time.perf_counter() - t0
    ctx.window_closed()
    rec = ctx.rec
    rec.window_s = window_s
    if ctx.trace:
        rec.events, rec.trace_window = tracer.kernels(), (tracer.t0, tracer.t1)
    rec.counters.update(batches=i, K1=flash_attention.launches - n0["K1"],
                        K4=fused_mrf_stage.launches - n0["K4"])
    b_size = t["batch_size"]
    stages = work.mrf_stages(config["vocoder"], b_size, cap)
    ks, n_dil = config["vocoder"]["resblock_kernel_sizes"], len(config["vocoder"]["resblock_dilation_sizes"][0])
    rec.work["k4_launches"] = [work.mrf_work(*s, ks, n_dil, 4) for s in stages] * i
    per_frame = work.hifigan_flops_per_frame(config["vocoder"])
    n_mels = config["preprocess"]["mel"]["n_mel_channels"]
    rec.work["useful_flops"] = sum(
        work.fs2_forward_flops(config["model"], n_mels, int(s), int(m)) + per_frame * int(m)
        for src, mel in rows for s, m in zip(src, mel))
    del model, vocoder
    checks = compare(config, t, ctx.cell["limits"], fs2_sd, voc_sd, pool, batches, kept, dev)
    return Outcome(e2e={"audio_s_per_s": audio_s / window_s}, attempted=i, failed=0,
                   checks=checks)


def decision_gaps(follow: Dict[str, torch.Tensor], r, edges) -> tuple:
    """(duration gap, bin gap): how far, at worst, the program's integer
    durations lie outside round()'s interval around the reference's real
    durations (|d - r| - 1/2), and its pitch and energy bins outside the
    interval that holds the reference's value (bin b holds lo < v <= hi)."""
    dur = (follow["duration"].double() - r.duration_real.double()).abs() - 0.5
    gap = 0.0
    for k, v in (("pitch", r.pitch), ("energy", r.energy)):
        e = edges[k].double()
        bnd = torch.cat([e.new_tensor([-math.inf]), e, e.new_tensor([math.inf])])
        b = follow[f"{k}_bin"]
        v = v.double()
        gap = max(gap, float(torch.clamp(torch.maximum(bnd[b] - v, v - bnd[b + 1]), min=0).max()))
    return max(float(dur.max()), 0.0), gap


def judge(config: dict, cap: int, sd, voc_sd, inp: Dict[str, torch.Tensor], prog) -> Dict[str, float]:
    """The numbers compared for one batch. `prog`: the program's output
    (FS2Output), mel_len and int16 wavs."""
    out, mel_len, wavs = prog
    va = "variance_adaptor"
    edges = {k: sd[f"{va}.{k}_bins"] for k in ("pitch", "energy")}
    follow = {"duration": out.duration_rounded.long(),
              "pitch_bin": torch.bucketize(out.pitch_prediction.float(), edges["pitch"]),
              "energy_bin": torch.bucketize(out.energy_prediction.float(), edges["energy"])}
    with torch.no_grad():
        r = ref_fs2.infer(sd, config["model"], inp["texts"], inp["src_lens"], inp["accents"],
                          inp["speaker_vec"], cap, follow)
    dur_gap, bin_gap = decision_gaps(follow, r, edges)
    ref_mel = r.postnet_mel
    mel_err = float((out.postnet_mel.float() - ref_mel).abs().max() / ref_mel.abs().max())
    with torch.no_grad():
        ref_wav = ref_hifigan.to_int16(ref_hifigan.generate(voc_sd, config["vocoder"],
                                                            ref_mel).cpu().numpy())
    hop = config["preprocess"]["stft"]["hop_length"]
    lsb = 0
    for j, w in enumerate(wavs):
        n = int(r.mel_len[j]) * hop
        m = min(n, len(w))  # a wav of another length fails by the samples it lacks or adds
        lsb = max(lsb, int(np.abs(w[:m].astype(np.int64) - ref_wav[j, :m]).max(initial=0)),
                  abs(len(w) - n))
    return {"duration_gap": dur_gap, "bin_gap": bin_gap,
            "mel_len_mismatch": float((out.mel_len.cpu() != r.mel_len.cpu()).sum()),
            "postnet_mel_rel_err": mel_err, "wav_lsb": float(lsb)}


def compare(config: dict, t: dict, limits: dict, sd, voc_sd, pool, batches, kept, dev
            ) -> List[Check]:
    """The cell's checks over the kept batches: each number's worst batch."""
    worst: Dict[str, float] = {}
    for i, prog in sorted(kept.items()):
        inp = _inputs(config, batches[i % len(batches)], pool, sd, dev)
        for k, v in judge(config, t["max_mel_len"], sd, voc_sd, inp, prog).items():
            worst[k] = max(worst.get(k, 0.0), v)
    if len(kept) < t["check_batches"]:
        worst["batches_unchecked"] = float(t["check_batches"] - len(kept))

    return [Check(k, worst.get(k, 0.0), limits[k]) for k in
            ("duration_gap", "bin_gap", "mel_len_mismatch", "postnet_mel_rel_err", "wav_lsb",
             "batches_unchecked")]
