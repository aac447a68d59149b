"""The port's serving engine, HTTP server and dynamic batcher on the CPU.

The engine is held against masg_tpu's ServingEngine on the same weights
(masg_tpu's tiny FastSpeech2 with the duration bias ln 5, so an untrained
model free-runs at ~4 frames per phone, and a HiFi-GAN V1 at
`upsample_initial_channel=32` from the port's `init_random_weights`, which
keeps the wav at an audio-range level): mel_len identical and the wav within
2 LSB (the int16 cast truncates f32 sums taken in other orders), the mel
within 2e-4. The batching, chunking and streaming paths are held against the
port's own single-request path, with masg_tpu's bars
(tests/test_serving.py), and the HTTP and batcher contracts are masg_tpu's.
masg_tpu's side is its mel-only engine, then its vocoder over the full
padded mel, trimmed: the wav its fused per-bucket graph gives, through the
vocoder jit of tests/torch_port_support.py that
tests/test_torch_port_streaming.py compiles at the same mel caps (256 and 384
frames), so each compiles once per process.
Every wait, join and HTTP call has a timeout; every server and batcher is
closed in a finalizer.
"""

import base64
import io
import json
import math
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from masg_tpu_torch.cli.serve import make_server, request_to_ids
from masg_tpu_torch.infer.serving import (DynamicBatcher, RequestTimeout, ServerOverloaded,
                                          ServingEngine, pick_bucket)
from masg_tpu_torch.infer.vocoder import Vocoder, vocoder_infer
from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
from torch_port_support import masg_tpu_engine, masg_tpu_vocoder, port_tiny_config

BUCKETS, FPP = (16, 32), 12  # mel caps 256 and 384
HTTP_TIMEOUT = 120


@pytest.fixture(scope="module")
def pair():
    """((masg_tpu mel-only engine, masg_tpu vocoder), port engine) on the
    same weights."""
    import jax
    from masg_tpu.infer.serving import with_duration_bias
    from test_fastspeech2 import tiny_config

    from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax

    gen = HiFiGANGenerator(upsample_initial_channel=32)
    init_random_weights(gen, torch.Generator().manual_seed(1))
    jeng = masg_tpu_engine(tiny_config(), vocoder=None, text_buckets=BUCKETS,
                           frames_per_phone=FPP)
    variables = with_duration_bias(jax.tree.map(np.asarray, dict(jeng.variables)),
                                   math.log(5.0))
    jeng.variables = variables

    cfg = port_tiny_config()
    sd = fs2_state_dict_from_jax(variables["params"], variables["batch_stats"], cfg)
    teng = ServingEngine(cfg, state_dict=sd, vocoder=Vocoder(gen), text_buckets=BUCKETS,
                         frames_per_phone=FPP, device="cpu")
    return (jeng, masg_tpu_vocoder(gen)), teng


@pytest.fixture(scope="module")
def engine(pair):
    return pair[1]


def lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def jax_synthesize(jax_pair, ids, speaker_id=0, speaker_emb=None, pitch_control=1.0,
                   energy_control=1.0, duration_control=1.0):
    """masg_tpu's `ServingEngine.synthesize`: the bucket's graph to the mel
    cap, the vocoder over the full padded mel, the wav trimmed to mel_len."""
    from masg_tpu.infer.vocoder import vocoder_infer as jax_infer

    jeng, jvoc = jax_pair
    texts, src_lens, acc, _ = jeng._pad_request(ids, None)
    mel, mel_len = jeng._run(texts, src_lens, acc, speaker_id, None, speaker_emb,
                             (pitch_control, energy_control, duration_control))
    mel_len = int(np.asarray(mel_len)[0])
    return mel_len, jax_infer(mel, jvoc, lengths=[mel_len * jeng.hop])[0]


@pytest.mark.parametrize("n", [9, 25])
def test_synthesize_matches_masg_tpu_at_each_bucket(pair, n):
    """At a duration control that keeps mel_len below the bucket's cap, so
    the vocoder also runs over free-running frames past mel_len (the tail
    semantics) and mel_len is not pinned at the cap."""
    ref, teng = pair
    ids = list(range(5, 5 + n))
    got = teng.synthesize(ids, speaker_id=1, duration_control=0.3)
    want_len, want_wav = jax_synthesize(ref, ids, speaker_id=1, duration_control=0.3)
    assert got["bucket"] == pick_bucket(n, BUCKETS)
    assert got["mel_len"] == want_len and 0 < got["mel_len"] < teng.mel_caps[got["bucket"]]
    assert got["wav"].dtype == np.int16 and got["wav"].shape == want_wav.shape
    assert got["wav"].shape == (got["mel_len"] * 256,)
    assert np.abs(want_wav.astype(np.int32)).max() > 1000  # audio-range, not a few LSB
    print(f"[parity] ServingEngine.synthesize, bucket {got['bucket']}: mel_len "
          f"{got['mel_len']} identical, max {lsb(got['wav'], want_wav)} LSB (bar 2)")
    assert lsb(got["wav"], want_wav) <= 2


def test_mel_only_engine_matches_masg_tpu(pair):
    """A vocoder-less engine returns the trimmed mel: masg_tpu's mel-only
    engine at the same bucket within 2e-4."""
    (jeng, _), teng = pair
    mel_eng = ServingEngine(teng.cfg, state_dict=teng.model.state_dict(), vocoder=None,
                            text_buckets=(16,), frames_per_phone=FPP, device="cpu")
    ids = [5, 6, 7, 8, 9, 10, 11]
    r = mel_eng.synthesize(ids)
    assert "wav" not in r and r["mel"].shape == (r["mel_len"], 80)
    want = jeng.synthesize(ids)
    assert r["mel_len"] == want["mel_len"]
    err = float(np.abs(r["mel"] - want["mel"]).max())
    print(f"[parity] mel-only ServingEngine: max abs mel err {err:.3g} (bar 2e-4)")
    assert err <= 2e-4


def test_speaker_emb_path_matches_masg_tpu(pair):
    ref, teng = pair
    emb = np.full((1, teng.cfg.model.transformer.encoder_hidden), 0.1, np.float32)
    got = teng.synthesize([5, 6, 7, 8, 9], speaker_emb=emb)
    want_len, want_wav = jax_synthesize(ref, [5, 6, 7, 8, 9], speaker_emb=emb)
    assert got["mel_len"] == want_len > 0
    assert lsb(got["wav"], want_wav) <= 2


def test_controls_match_masg_tpu_and_repeat(pair):
    """Controls go in as (B, 1) tensors: the same mel_len and wav as masg_tpu
    for each; a second call gives the same bits; duration_control shrinks."""
    ref, teng = pair
    ids = list(range(5, 14))
    base = teng.synthesize(ids)
    assert np.array_equal(base["wav"], teng.synthesize(ids)["wav"])
    for kw in ({"duration_control": 0.05}, {"pitch_control": 1.3, "energy_control": 0.7}):
        got = teng.synthesize(ids, **kw)
        want_len, want_wav = jax_synthesize(ref, ids, **kw)
        assert got["mel_len"] == want_len, kw
        assert lsb(got["wav"], want_wav) <= 2, kw
    assert 0 < teng.synthesize(ids, duration_control=0.05)["mel_len"] < base["mel_len"]


def test_pick_bucket_and_oversize(engine):
    assert pick_bucket(9, (16, 32)) == 16
    assert pick_bucket(16, (16, 32)) == 16
    assert pick_bucket(17, (16, 32)) == 32
    with pytest.raises(ValueError, match="exceeds"):
        pick_bucket(33, (16, 32))
    with pytest.raises(ValueError, match="exceeds"):
        engine.synthesize(list(range(1, 40)))
    with pytest.raises(ValueError, match="empty"):
        engine.synthesize([])


def test_synthesize_many_matches_single(engine):
    """One batched dispatch over N requests reproduces the per-request path,
    mixed per-request controls included (masg_tpu's atol=2)."""
    reqs = [{"ids": [5, 6, 7, 8, 9], "speaker_id": 0},
            {"ids": [10, 11, 12], "speaker_id": 1, "duration_control": 0.05},
            {"ids": list(range(5, 14)), "speaker_id": 2, "pitch_control": 1.3}]
    n0 = engine.n_batches
    batched = engine.synthesize_many(reqs)  # n=3 pads to the batch bucket 4
    assert engine.n_batches == n0 + 1 and all(r["batch"] == 3 for r in batched)
    for r, b in zip(reqs, batched):
        single = engine.synthesize(r["ids"], **{k: v for k, v in r.items() if k != "ids"})
        assert single["mel_len"] == b["mel_len"]
        np.testing.assert_allclose(b["wav"], single["wav"], atol=2)
    with pytest.raises(ValueError, match="not batchable"):
        engine.synthesize_many([{"ids": [5], "speaker_emb": np.zeros((1, 8))}])


def test_synthesize_many_own_bucket_cap(engine):
    """A saturating request co-batched with a longer text truncates at its
    OWN bucket's mel cap, like the single-request path."""
    single = engine.synthesize(list(range(5, 16)), duration_control=50.0)
    assert single["mel_len"] == engine.mel_caps[16]  # saturated
    batched = engine.synthesize_many([{"ids": list(range(5, 16)), "duration_control": 50.0},
                                      {"ids": list(range(5, 30))}])
    assert batched[0]["bucket"] == 32 and batched[0]["mel_len"] == single["mel_len"]


def test_synthesize_chunked_matches_parts(engine):
    from masg_tpu_torch.infer.synthesis import chunk_phone_ids

    ids = list(range(5, 25)) + [420] + list(range(30, 55))  # 46 phones, an sp pause
    r = engine.synthesize_chunked(ids)
    assert r["n_chunks"] >= 2 and r["wav"].shape == (r["mel_len"] * 256,)
    parts = engine.synthesize_many(
        [{"ids": c} for c, _ in chunk_phone_ids(ids, max_phones=engine.text_buckets[-1])])
    np.testing.assert_array_equal(r["wav"], np.concatenate([p["wav"] for p in parts]))


def _trimmed_one_shot(engine, ids, speaker_emb=None):
    texts, sl, acc, _ = engine._pad_request(ids, None)
    mel, mel_len = engine._run(texts, sl, acc, speaker_emb=speaker_emb, mel_only=True)
    return mel[:, :int(mel_len[0])], vocoder_infer(mel[:, :int(mel_len[0])], engine.vocoder)[0]


def test_streaming_matches_one_shot_of_trimmed_mel(engine):
    """The concatenated PCM equals vocoding the trimmed mel in one shot
    (the reference pipeline's semantics), within 1 LSB. The context is the
    default, the measured receptive field + 2 (masg_tpu's test passes 8
    frames, which its near-silent vocoder allows; this one's field is wider)."""
    ids = list(range(5, 14))
    chunks = list(engine.synthesize_streaming(ids, chunk_frames=24))
    assert len(chunks) >= 2  # really streamed
    stream = np.concatenate(chunks)
    _, full = _trimmed_one_shot(engine, ids)
    assert stream.shape == full.shape and lsb(stream, full) <= 1


def test_streaming_speaker_emb(engine):
    """Streaming honours a speaker embedding: the embedding changes the mel,
    and the stream equals the one-shot vocode of that mel."""
    emb = np.full((1, engine.cfg.model.transformer.encoder_hidden), 0.1, np.float32)
    ids = list(range(5, 14))
    mel_plain, _ = _trimmed_one_shot(engine, ids)
    mel_emb, full = _trimmed_one_shot(engine, ids, speaker_emb=emb)
    n = min(mel_plain.shape[1], mel_emb.shape[1])
    assert float((mel_plain[:, :n] - mel_emb[:, :n]).abs().max()) > 1e-3
    wav = np.concatenate(list(engine.synthesize_streaming(
        ids, speaker_emb=emb, chunk_frames=24)))
    assert wav.dtype == np.int16 and wav.shape == full.shape and lsb(wav, full) <= 1


# --- HTTP --------------------------------------------------------------------


def _serve(front):
    srv = make_server(front, port=0)  # ephemeral port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, f"http://127.0.0.1:{srv.server_address[1]}"


def _close(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


@pytest.fixture(scope="module")
def server(engine):
    srv, thread, url = _serve(engine)
    yield url
    _close(srv, thread)


def _post(url, payload, path="/synthesize", timeout=HTTP_TIMEOUT):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_health_and_404(server):
    with urllib.request.urlopen(server + "/health", timeout=HTTP_TIMEOUT) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["sample_rate"] == 22050
    assert h["buckets"] == {"16": 256, "32": 384}  # round_up(L * 12, 128)
    for key in ("requests", "batches", "queue_depth", "shed_overload", "shed_timeout"):
        assert key in h
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nowhere", timeout=HTTP_TIMEOUT)
    assert e.value.code == 404
    assert _post(server, {"phones": "{a}"}, path="/nowhere")[0] == 404


def test_http_synthesize_wav(server, engine):
    code, headers, body = _post(server, {"phones": "{a i u e o a i u e o}"})
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (22050, 1, 2)
        frames = w.readframes(w.getnframes())
    assert int(headers["X-Mel-Len"]) * 256 == len(frames) // 2 > 0
    ids, _ = request_to_ids({"phones": "{a i u e o a i u e o}"})
    assert frames == engine.synthesize(ids)["wav"].tobytes()


def test_http_synthesize_json(server):
    code, _, body = _post(server, {"phones": "{a i u}", "format": "json", "speaker_id": 1})
    assert code == 200
    r = json.loads(body)
    assert r["mel_len"] > 0 and r["bucket"] == 16
    with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"]))) as w:
        assert w.getnframes() == r["mel_len"] * 256


def test_http_bad_requests(server):
    code, _, body = _post(server, {"nonsense": True})
    assert code == 400 and "phones" in json.loads(body)["error"]
    # an unknown accent char or phone symbol is a client error, not a 500
    code, _, body = _post(server, {"phones": "{a i}", "accents": "zz"})
    assert code == 400 and "unknown symbol" in json.loads(body)["error"]
    assert _post(server, {"phones": "{a notaphone}"})[0] == 400
    assert _post(server, {"phones": "{}"})[0] == 400


def test_http_mel_only_response(engine):
    """A mel-only server's JSON carries sample_rate and n_mels with the mel."""
    mel_eng = ServingEngine(engine.cfg, state_dict=engine.model.state_dict(), vocoder=None,
                            text_buckets=(16,), frames_per_phone=FPP, device="cpu")
    srv, thread, url = _serve(mel_eng)
    try:
        code, _, body = _post(url, {"phones": "{a i u}"})
        assert code == 200
        r = json.loads(body)
        assert r["sample_rate"] == 22050 and r["n_mels"] == 80
        mel = np.frombuffer(base64.b64decode(r["mel_b64"]), np.float32)
        assert mel.size == r["mel_len"] * r["n_mels"] > 0
        code, _, body = _post(url, {"phones": "{a i u}"}, path="/synthesize_streaming")
        assert code == 400 and "vocoder" in json.loads(body)["error"]
    finally:
        _close(srv, thread)


def test_http_overlength_text_chunks(server):
    """A text longer than the largest bucket (32) chunks at pause phones and
    returns the stitched audio instead of a 400."""
    phones = " ".join((["a"] * 20 + ["sp"]) * 3)  # 63 phones, pauses at 21 and 42
    code, headers, body = _post(server, {"phones": "{" + phones + "}"})
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    with wave.open(io.BytesIO(body)) as w:
        assert w.getnframes() == int(headers["X-Mel-Len"]) * 256 > 0


def test_http_streaming_endpoint(server, engine):
    """/synthesize_streaming: a RIFF header with unknown sizes, then the
    engine's streaming PCM in HTTP chunks."""
    payload = {"phones": "{a b c d e f g h i}"}
    code, headers, body = _post(server, payload, path="/synthesize_streaming")
    assert code == 200 and headers["Content-Type"] == "audio/wav"
    assert headers["Transfer-Encoding"] == "chunked" and headers["X-Sample-Rate"] == "22050"
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and body[36:40] == b"data"
    assert body[4:8] == b"\xff\xff\xff\xff" and body[40:44] == b"\xff\xff\xff\xff"
    pcm = np.frombuffer(body[44:], np.int16)
    ids, _ = request_to_ids(payload)
    direct = np.concatenate(list(engine.synthesize_streaming(ids)))
    assert pcm.size > 0 and np.array_equal(pcm, direct)


def test_http_streaming_long_text_and_speaker_emb(server, engine):
    phones = " ".join(["a b c d e f g sp"] * 5)  # 40 phones > bucket 32
    code, _, body = _post(server, {"phones": "{" + phones + "}"}, path="/synthesize_streaming")
    assert code == 200 and body[:4] == b"RIFF"
    ids, _ = request_to_ids({"phones": "{" + phones + "}"})
    assert body[44:] == engine.synthesize_chunked(ids)["wav"].tobytes()

    emb = [0.1] * engine.cfg.model.transformer.encoder_hidden
    code, _, body = _post(server, {"phones": "{a b c d e}", "speaker_emb": emb},
                          path="/synthesize_streaming")
    assert code == 200
    direct = np.concatenate(list(engine.synthesize_streaming(
        request_to_ids({"phones": "{a b c d e}"})[0],
        speaker_emb=np.asarray([emb], np.float32))))
    assert np.array_equal(np.frombuffer(body[44:], np.int16), direct)


def test_http_synthesize_speaker_emb_json(server, engine):
    emb = [0.1] * engine.cfg.model.transformer.encoder_hidden
    code, _, body = _post(server, {"phones": "{a b c d e}", "speaker_emb": emb,
                                   "format": "json"})
    assert code == 200
    r = json.loads(body)
    want = engine.synthesize(request_to_ids({"phones": "{a b c d e}"})[0],
                             speaker_emb=np.asarray([emb], np.float32))
    assert r["mel_len"] == want["mel_len"]
    with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"]))) as w:
        assert w.readframes(w.getnframes()) == want["wav"].tobytes()


# --- the dynamic batcher -------------------------------------------------------


def test_dynamic_batcher_fuses_concurrent_requests(engine):
    """Concurrent requests fuse into fewer dispatches with the results of the
    single path; the batcher passes the engine's fields through."""
    from concurrent.futures import ThreadPoolExecutor

    # a generous window: all 4 pool threads must enqueue inside it
    batcher = DynamicBatcher(engine, max_batch=4, window_ms=250.0)
    try:
        ids_list = [[5, 6, 7], [8, 9, 10, 11], [12, 13], [5, 9, 13]]
        singles = [engine.synthesize(ids) for ids in ids_list]
        req0, batch0 = engine.n_requests, engine.n_batches
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(batcher.synthesize, ids_list, timeout=HTTP_TIMEOUT))
        assert engine.n_requests - req0 == 4
        assert 1 <= engine.n_batches - batch0 < 4  # really batched
        for s, g in zip(singles, got):
            assert s["mel_len"] == g["mel_len"]
            np.testing.assert_allclose(s["wav"], g["wav"], atol=2)
        assert batcher.sample_rate == engine.sample_rate
        assert batcher.mel_caps == engine.mel_caps
    finally:
        batcher.close()


def test_dynamic_batcher_validation_and_close(engine):
    """A bad request fails only its own caller, and close() strands no
    waiter."""
    batcher = DynamicBatcher(engine, max_batch=4, window_ms=5.0)
    try:
        with pytest.raises(ValueError, match="empty"):
            batcher.synthesize([])
        with pytest.raises(ValueError, match="exceeds"):
            batcher.synthesize(list(range(1, 40)))
        assert batcher.synthesize([5, 6, 7])["mel_len"] > 0  # still serving
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.synthesize([5, 6, 7])


def test_concurrent_callers_keep_counts_and_results(engine):
    """Threads on every path at once (direct synthesize, the batcher and
    streaming through it) under a short switch interval: the engine counts
    each request once, direct and streamed results repeat their single runs
    bit for bit, batched ones within masg_tpu's atol=2."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    ids_list = [[5, 6, 7], [8, 9, 10, 11], list(range(5, 14)), [12, 13]]
    singles = [engine.synthesize(ids)["wav"] for ids in ids_list]
    streams = [np.concatenate(list(engine.synthesize_streaming(ids, chunk_frames=24)))
               for ids in ids_list]
    batcher = DynamicBatcher(engine, max_batch=4, window_ms=2.0)
    jobs = [(kind, i) for kind in ("direct", "batched", "stream") for i in range(4)] * 2

    def run(job):
        kind, i = job
        if kind == "direct":
            return engine.synthesize(ids_list[i])["wav"]
        if kind == "batched":
            return batcher.synthesize(ids_list[i])["wav"]
        return np.concatenate(list(batcher.synthesize_streaming(ids_list[i], chunk_frames=24)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n0 = engine.n_requests
        with ThreadPoolExecutor(12) as pool:
            futures = [pool.submit(run, job) for job in jobs]
            results = [f.result(timeout=HTTP_TIMEOUT) for f in futures]
        assert engine.n_requests - n0 == len(jobs)
    finally:
        sys.setswitchinterval(interval)
        batcher.close()
    for (kind, i), got in zip(jobs, results):
        if kind == "batched":
            assert got.shape == singles[i].shape and lsb(got, singles[i]) <= 2
        else:
            assert np.array_equal(got, streams[i] if kind == "stream" else singles[i]), kind


def test_http_through_the_batcher(engine):
    """/synthesize and /health through a DynamicBatcher: the same audio as
    the engine, the dispatch counted in `batches`."""
    batcher = DynamicBatcher(engine, max_batch=4, window_ms=5.0, max_queue=8)
    srv, thread, url = _serve(batcher)
    try:
        code, headers, body = _post(url, {"phones": "{a i u e o}"})
        assert code == 200
        with wave.open(io.BytesIO(body)) as w:
            frames = w.readframes(w.getnframes())
        want = engine.synthesize(request_to_ids({"phones": "{a i u e o}"})[0])
        assert np.abs(np.frombuffer(frames, np.int16).astype(np.int32)
                      - want["wav"].astype(np.int32)).max() <= 2
        with urllib.request.urlopen(url + "/health", timeout=HTTP_TIMEOUT) as r:
            h = json.loads(r.read())
        assert h["batches"] == engine.n_batches and h["queue_depth"] == 0
    finally:
        _close(srv, thread)
        batcher.close()


class _GatedEngine:
    """An engine stub whose dispatch blocks on an event, so the overload tests
    hold the batcher's worker mid-flight deterministically."""

    text_buckets = (16,)
    mel_caps = {16: 64}
    sample_rate = 22050
    hop = 256

    def __init__(self):
        self.gate = threading.Event()
        self.inflight = threading.Event()
        self.n_requests = 0
        self.n_batches = 0

    def synthesize_many(self, reqs, batch_buckets=None):
        self.inflight.set()
        assert self.gate.wait(10), "test gate never opened"
        self.n_requests += len(reqs)
        self.n_batches += 1
        return [{"mel_len": 4, "wav": np.zeros(16, np.int16), "sample_rate": self.sample_rate,
                 "latency_s": 0.0, "bucket": 16} for _ in reqs]


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


@pytest.mark.smoke
def test_batcher_overload_sheds_with_retry_after():
    """Requests beyond max_queue raise ServerOverloaded at once (no device
    time spent) while queued requests still complete."""
    eng = _GatedEngine()
    batcher = DynamicBatcher(eng, max_batch=1, window_ms=1.0, max_queue=2)
    try:
        results = []
        threads = [threading.Thread(target=lambda: results.append(batcher.synthesize([5, 6])))
                   for _ in range(3)]
        threads[0].start()
        assert eng.inflight.wait(10)  # the worker holds request 0 at the gate
        threads[1].start()
        threads[2].start()
        _wait_until(lambda: len(batcher._queue) >= 2)
        with pytest.raises(ServerOverloaded) as exc:
            batcher.synthesize([5, 6, 7])
        assert exc.value.retry_after_s >= 1.0 and batcher.n_shed_overload == 1
        eng.gate.set()
        for t in threads:
            t.join(timeout=10)
        assert len(results) == 3 and eng.n_requests == 3  # the shed one never ran
    finally:
        eng.gate.set()
        batcher.close()


@pytest.mark.smoke
def test_batcher_request_timeout_sheds_queued():
    """Queued requests past their deadline raise RequestTimeout and are shed
    without device time; an in-flight overrun that finishes inside the
    dispatch-scale grace returns its result."""
    eng = _GatedEngine()
    batcher = DynamicBatcher(eng, max_batch=1, window_ms=1.0, request_timeout_s=0.2)
    try:
        outcomes = []

        def call():
            try:
                batcher.synthesize([5, 6, 7])
                outcomes.append(None)
            except Exception as e:
                outcomes.append(e)

        threads = [threading.Thread(target=call) for _ in range(3)]
        threads[0].start()
        assert eng.inflight.wait(10)  # request 0 held in flight at the gate
        threads[1].start()
        threads[2].start()
        time.sleep(0.5)  # all three deadlines pass while the gate holds
        eng.gate.set()  # ... and the in-flight one finishes inside its grace
        for t in threads:
            t.join(timeout=10)
        assert outcomes.count(None) == 1, outcomes
        assert sum(isinstance(e, RequestTimeout) for e in outcomes) == 2, outcomes
        _wait_until(lambda: batcher.n_shed_timeout >= 2, timeout=5)
        assert batcher.n_shed_timeout == 2 and eng.n_requests == 1
        assert batcher.n_timeout_inflight == 0
    finally:
        eng.gate.set()
        batcher.close()


@pytest.mark.smoke
def test_batcher_inflight_grace_expiry_counts_metric():
    """An in-flight request that outlives the dispatch grace raises
    RequestTimeout and is counted in n_timeout_inflight."""
    eng = _GatedEngine()
    batcher = DynamicBatcher(eng, max_batch=1, window_ms=1.0, request_timeout_s=0.05)
    batcher._ema_s_per_req = 0.01  # grace = max(1.0, 0.01 * 1 * 2) = 1.0 s
    try:
        with pytest.raises(RequestTimeout, match="in-flight grace"):
            batcher.synthesize([5, 6, 7])  # the gate stays shut through the grace
        assert batcher.n_timeout_inflight == 1
    finally:
        eng.gate.set()
        batcher.close()


@pytest.mark.smoke
def test_batcher_expired_queue_entries_do_not_shed_new_requests():
    """Dead queue entries (callers already timed out) do not count toward
    max_queue: a new request prunes them instead of getting a 503."""
    eng = _GatedEngine()
    batcher = DynamicBatcher(eng, max_batch=1, window_ms=1.0, max_queue=1,
                             request_timeout_s=0.05)
    try:
        def call():
            try:
                batcher.synthesize([5, 6, 7])
            except RequestTimeout:
                pass

        t0 = threading.Thread(target=call)
        t0.start()
        assert eng.inflight.wait(10)  # the worker holds request 0 at the gate
        t1 = threading.Thread(target=call)
        t1.start()  # fills the queue (depth 1 = max_queue)
        time.sleep(0.3)  # request 1's deadline passes while it is queued
        t2 = threading.Thread(target=call)
        t2.start()  # a full queue of a dead entry: pruned, not shed
        time.sleep(0.05)
        assert batcher.n_shed_overload == 0
        eng.gate.set()
        for t in (t0, t1, t2):
            t.join(timeout=10)
        assert batcher.n_shed_overload == 0
    finally:
        eng.gate.set()
        batcher.close()


@pytest.mark.smoke
def test_bypass_paths_shed_on_overload():
    """Streaming, chunked and speaker_emb requests bypass the batch queue but
    still shed once max_queue bypasses are in flight."""

    class _SlowBypassEngine(_GatedEngine):
        def synthesize(self, ids, **kw):
            self.inflight.set()
            assert self.gate.wait(10)
            return {"mel_len": 4}

        def synthesize_chunked(self, ids, **kw):
            return self.synthesize(ids)

        def synthesize_streaming(self, ids, **kw):
            self.inflight.set()
            assert self.gate.wait(10)
            yield np.zeros(16, np.int16)

    eng = _SlowBypassEngine()
    batcher = DynamicBatcher(eng, max_batch=1, window_ms=1.0, max_queue=1)
    try:
        t = threading.Thread(target=lambda: batcher.synthesize([5], speaker_emb=np.zeros((1, 4))))
        t.start()
        assert eng.inflight.wait(10)  # one bypass holds the cap
        with pytest.raises(ServerOverloaded):
            batcher.synthesize_chunked([5, 6])
        with pytest.raises(ServerOverloaded):
            next(batcher.synthesize_streaming([5, 6]))
        assert batcher.n_shed_overload == 2
        eng.gate.set()
        t.join(timeout=10)
        assert batcher.synthesize_chunked([5, 6])["mel_len"] == 4  # capacity released
    finally:
        eng.gate.set()
        batcher.close()


@pytest.mark.smoke
def test_http_overload_maps_to_503_and_timeout_to_504():
    """A full batcher queue is HTTP 503 + Retry-After, a request past its
    deadline 504; /health counts the sheds."""
    eng = _GatedEngine()
    batcher = DynamicBatcher(eng, max_batch=1, window_ms=1.0, max_queue=1)
    srv, thread, url = _serve(batcher)
    try:
        codes = {}

        def post():
            code, headers, _ = _post(url, {"phones": "{a o i}"}, timeout=30)
            codes[threading.get_ident()] = (code, headers.get("Retry-After"))

        t0 = threading.Thread(target=post)
        t0.start()
        assert eng.inflight.wait(10)
        t1 = threading.Thread(target=post)
        t1.start()
        _wait_until(lambda: len(batcher._queue) >= 1)
        post()  # the queue is full: 503 for this caller
        eng.gate.set()
        t0.join(timeout=10)
        t1.join(timeout=10)
        got = sorted(codes.values(), key=lambda x: x[0])
        assert [c for c, _ in got] == [200, 200, 503], got
        assert int(got[2][1]) >= 1
        with urllib.request.urlopen(url + "/health", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["shed_overload"] == 1 and health["queue_depth"] == 0
    finally:
        eng.gate.set()
        _close(srv, thread)
        batcher.close()

    eng = _GatedEngine()
    batcher = DynamicBatcher(eng, max_batch=1, window_ms=1.0, request_timeout_s=0.05)
    srv, thread, url = _serve(batcher)
    try:
        t0 = threading.Thread(target=lambda: _post(url, {"phones": "{a o i}"}, timeout=30))
        t0.start()
        assert eng.inflight.wait(10)  # request 0 holds the worker
        code, _, body = _post(url, {"phones": "{a o i}"}, timeout=30)  # expires queued
        assert code == 504 and "exceeded" in json.loads(body)["error"]
    finally:
        eng.gate.set()
        t0.join(timeout=10)
        _close(srv, thread)
        batcher.close()
