"""Open-loop HTTP serving: the program's server wired as its `cli.serve`
wires it at its defaults (`ServingEngine` with text buckets 16/32/64/128,
`DynamicBatcher(max_batch=32, window_ms=5, max_queue=256)`, `make_server`
on 127.0.0.1 at a free port, the batch ladder x text buckets warmed), in
this process. A client on one thread (asyncio) sends POST /synthesize at
Poisson arrival times at the cell's fixed rate, one utterance of phones
each, a speaker of the table. Each request is timed from when it was due
to its last byte; a request that fails or never comes counts as the worst.

`correct`: a sample of the requests sent, drawn from the seed with the
longest among them, is worked out again by the plain reference from the
request alone, at the mel capacity of the dispatch that carried it,
following the program's discrete choices for its row (durations, pitch and
energy bins, read by a wrapper around the engine's model and judged by
their margin against the reference's values, as in the offline cells); the
wav bytes returned over HTTP are compared with the reference's int16 wav.
"""

from __future__ import annotations

import asyncio
import io
import json
import threading
import time
import wave
from typing import Dict, List

import numpy as np
import torch

from portbench import build, traffic
from portbench.drivers import synth
from portbench.harness import Check, Context, Outcome, Tracer
from portbench.reference import fastspeech2 as ref_fs2
from portbench.reference import hifigan as ref_hifigan


class Server:
    """The program's engine, batcher and HTTP server, up on a free port, with
    the benchmark's wrappers around the batcher's calls into the engine
    (rows per dispatch) and around the engine's model (the rows of the
    requests being checked)."""

    def __init__(self, ctx: Context, fs2_sd, voc_sd, watch: Dict[tuple, int]):
        from masg_tpu_torch.cli.serve import make_server
        from masg_tpu_torch.infer.serving import DynamicBatcher, ServingEngine

        t = ctx.cell["traffic"]
        self.engine = ServingEngine(build.port_config(ctx.config), state_dict=fs2_sd,
                                    vocoder=build.port_vocoder(ctx.config, voc_sd, ctx.device),
                                    text_buckets=tuple(t["text_buckets"]), device=ctx.device)
        self.batcher = DynamicBatcher(self.engine, max_batch=t["max_batch"],
                                      window_ms=t["window_ms"], max_queue=t["max_queue"])
        self.ctx, self.watch, self.seen = ctx, watch, {}
        self.current: List[dict] = []
        self.counting = False
        many, model = self.engine.synthesize_many, self.engine.model
        forward = model.forward

        def synthesize_many(requests, batch_buckets=None):
            self.current = requests
            if self.counting:
                ctx.rec.count("dispatches")
                ctx.rec.count("dispatch_rows", len(requests))
            with ctx.span("dispatch"):
                return many(requests, batch_buckets)

        def watched_forward(speakers, texts, src_lens, max_mel_len, *a, **k):
            out = forward(speakers, texts, src_lens, max_mel_len, *a, **k)
            for row, r in enumerate(self.current):
                i = self.watch.get(tuple(int(x) for x in r["ids"]))
                if i is not None:
                    self.seen[i] = (out, row, max_mel_len, texts.shape[1])
            return out

        self.engine.synthesize_many = synthesize_many
        model.forward = watched_forward
        self.engine.warmup(include_speaker_emb=True, batch_sizes=tuple(self.batcher._buckets))
        self.http = make_server(self.batcher, "127.0.0.1", 0)
        self.port = self.http.server_address[1]
        self.thread = threading.Thread(target=self.http.serve_forever, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.http.shutdown()
        self.http.server_close()
        self.thread.join(timeout=30)
        self.batcher.close()


def request_body(ids, acc, spk: int, symbols, accent_chars: str) -> bytes:
    req = {"phones": "{" + " ".join(symbols[i] for i in ids) + "}", "speaker_id": int(spk)}
    if acc is not None:
        req["accents"] = "".join(accent_chars[a] for a in acc)
    return json.dumps(req).encode()


async def _send(port: int, body: bytes, due: float, loop, slot: dict) -> None:
    await asyncio.sleep(max(0.0, due - loop.time()))
    slot["start"] = loop.time()
    head = (f"POST /synthesize HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(head + body)
        await writer.drain()
        data = await reader.read()
        slot["end"] = loop.time()
        writer.close()
        status = int(data.split(b" ", 2)[1])
        slot["status"] = status
        if status == 200:
            slot["body"] = data.split(b"\r\n\r\n", 1)[1]
    except (OSError, ValueError, IndexError) as e:
        slot["error"] = f"{type(e).__name__}: {e}"


def open_loop(port: int, bodies: List[bytes], times: np.ndarray, wait_s: float) -> List[dict]:
    """Sends bodies[i] at times[i] seconds after the start, each on its own
    connection; waits up to `wait_s` after the last send for the answers.
    Returns per request {due, start, end, status, body} on one clock."""
    loop = asyncio.new_event_loop()
    try:
        t0 = loop.time() + 0.05
        slots = [{"due": t0 + float(t)} for t in times]

        async def main():
            tasks = [asyncio.ensure_future(_send(port, b, s["due"], loop, s))
                     for b, s in zip(bodies, slots)]
            deadline = t0 + float(times[-1]) + wait_s if len(times) else t0
            done, pending = await asyncio.wait(tasks, timeout=max(0.0, deadline - loop.time()))
            for p in pending:
                p.cancel()
            await asyncio.gather(*pending, return_exceptions=True)

        loop.run_until_complete(main())
        return slots
    finally:
        loop.close()


def latencies_ms(slots: List[dict]) -> np.ndarray:
    """Due-to-last-byte of each request; one that failed or never came
    counts as the latest any request of the run saw, or the wait's end."""
    ok = [s["end"] - s["due"] for s in slots if s.get("status") == 200]
    worst = max(ok + [s.get("end", 0.0) - s["due"] for s in slots], default=0.0)
    return np.array([(s["end"] - s["due"]) if s.get("status") == 200 else worst
                     for s in slots]) * 1e3


def wav_of(body: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(body)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def alphabet() -> np.ndarray:
    """The phone ids a phone string carries: each symbol written once, no
    blanks or braces."""
    from masg_tpu_torch.text.symbols import symbol_to_id, symbols

    return np.array([i for i in range(1, len(symbols)) if symbol_to_id[symbols[i]] == i
                     and symbols[i].strip() and not set(symbols[i]) & set("{} ")])


def traffic_of(ctx: Context):
    """(FastSpeech2 and vocoder weights, requests, arrival times, the checked
    request indices) of a run at ctx.seed; the duration bias is calibrated
    over the requests as over an offline pool."""
    config, t = ctx.config, ctx.cell["traffic"]
    fs2_sd, voc_sd = build.weights(config, ctx.seed, ctx.device)
    _, languages = build.speakers(config)
    times = traffic.arrivals(ctx.seed, t["rate_per_s"], ctx.seconds)
    reqs = traffic.requests(ctx.seed, t, len(times), alphabet(), languages)
    b = t["calibration_batch"]
    pool = [{"source": "table", "who": np.array([r[2] for r in reqs[i:i + b]]),
             "src_lens": np.array([len(r[0]) for r in reqs[i:i + b]]),
             "texts": traffic.pad_rows([r[0] for r in reqs[i:i + b]], 128),
             "accents": traffic.pad_rows([r[1] if r[1] is not None else
                                          np.full(len(r[0]), traffic.NO_ACCENT_ID)
                                          for r in reqs[i:i + b]], 128)}
            for i in range(0, len(reqs), b)]
    synth.calibrate_durations(config, fs2_sd, pool, None, ctx.device)
    g = traffic.rng(ctx.seed, 7)
    longest = int(np.argmax([len(r[0]) for r in reqs]))
    check = sorted({longest, *g.choice(len(reqs), t["check_requests"] - 1, replace=False).tolist()})
    return fs2_sd, voc_sd, reqs, times, check


def setup(ctx: Context):
    """(server, requests, arrival times, the checked request indices, the
    weights)."""
    ctx.stamp("imported")
    fs2_sd, voc_sd, reqs, times, check = traffic_of(ctx)
    watch = {tuple(int(x) for x in reqs[i][0]): i for i in check}
    ctx.stamp("calibrated")
    server = Server(ctx, fs2_sd, voc_sd, watch)
    ctx.stamp("served")
    return server, reqs, times, check, fs2_sd, voc_sd


def run(ctx: Context) -> Outcome:
    from masg_tpu_torch.text import ACCENT_TO_ID
    from masg_tpu_torch.text.symbols import symbols

    t = ctx.cell["traffic"]
    server, reqs, times, check, fs2_sd, voc_sd = setup(ctx)
    chars = "".join(sorted(ACCENT_TO_ID, key=ACCENT_TO_ID.get))
    bodies = [request_body(ids, acc, spk, symbols, chars) for ids, acc, spk in reqs]
    # the HTTP path warmed, one request per text bucket, not counted
    warm = [request_body(np.resize(alphabet(), L), None, 0, symbols, chars)
            for L in t["text_buckets"]]
    open_loop(server.port, warm, np.arange(len(warm)) * 2.0, 120.0)
    server.seen.clear()
    server.counting = True
    with Tracer(ctx.trace) as tracer:
        ctx.window_opens()
        tracer.mark()
        t0 = time.perf_counter()
        slots = open_loop(server.port, bodies, times, t["wait_s"])
        if ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ctx.window_closed()
    server.counting = False
    rec = ctx.rec
    rec.window_s = window_s
    if ctx.trace:
        rec.events, rec.trace_window = tracer.kernels(), (tracer.t0, tracer.t1)
    lat = latencies_ms(slots)
    late = np.array([s.get("start", s["due"]) - s["due"] for s in slots]) * 1e3
    failed = sum(s.get("status") != 200 for s in slots)
    rec.counters.update(requests=len(slots), failed=failed, p50_ms=float(np.percentile(lat, 50)),
                        sender_late_p99_ms=float(np.percentile(late, 99)),
                        sender_late_max_ms=float(late.max()),
                        shed=server.batcher.n_shed_overload)
    seen = dict(server.seen)
    server.close()
    checks = compare(ctx.config, t, ctx.cell["limits"], fs2_sd, voc_sd, reqs, check, seen, slots,
                     server.engine, ctx.device)
    return Outcome(e2e={"p95_latency_ms": float(np.percentile(lat, 95))}, attempted=len(slots),
                   failed=failed, checks=checks)


def compare(config: dict, t: dict, limits: dict, sd, voc_sd, reqs, check, seen, slots, engine,
            device: str) -> List[Check]:
    """The checked requests against the reference, each at its own length
    and the capacity of the dispatch that carried it."""
    hop = config["preprocess"]["stft"]["hop_length"]
    va = "variance_adaptor"
    edges = {k: sd[f"{va}.{k}_bins"] for k in ("pitch", "energy")}
    worst = {"duration_gap": 0.0, "bin_gap": 0.0, "wav_lsb": 0.0, "requests_unchecked": 0.0}
    for i in check:
        if i not in seen or slots[i].get("status") != 200:
            worst["requests_unchecked"] += 1
            continue
        out, row, cap, width = seen[i]  # the dispatch's mel capacity and text width
        ids, acc, spk = reqs[i]
        n = len(ids)
        own_cap = engine.mel_caps[min(L for L in engine.text_buckets if L >= n)]
        follow = {"duration": out.duration_rounded[row:row + 1].long(),
                  "pitch_bin": torch.bucketize(out.pitch_prediction[row:row + 1].float(),
                                               edges["pitch"]),
                  "energy_bin": torch.bucketize(out.energy_prediction[row:row + 1].float(),
                                                edges["energy"])}
        a = acc if acc is not None else np.full(n, traffic.NO_ACCENT_ID)

        def padded(x):  # the row as the dispatch padded it
            return torch.as_tensor(traffic.pad_rows([np.asarray(x)], width), device=device)

        with torch.no_grad():
            r = ref_fs2.infer(sd, config["model"], padded(ids), torch.tensor([n], device=device),
                              padded(a), sd["speaker_emb.weight"][spk][None], cap, follow)
            wav = ref_hifigan.to_int16(ref_hifigan.generate(voc_sd, config["vocoder"],
                                                            r.postnet_mel).cpu().numpy())[0]
        gaps = synth.decision_gaps(follow, r, edges)
        worst["duration_gap"] = max(worst["duration_gap"], gaps[0])
        worst["bin_gap"] = max(worst["bin_gap"], gaps[1])
        want = wav[:min(int(r.mel_len[0]), own_cap) * hop]
        got = wav_of(slots[i]["body"])
        m = min(len(got), len(want))
        lsb = max(int(np.abs(got[:m].astype(np.int64) - want[:m]).max(initial=0)),
                  abs(len(got) - len(want)))
        worst["wav_lsb"] = max(worst["wav_lsb"], float(lsb))
    return [Check(k, v, limits[k]) for k, v in worst.items()]
