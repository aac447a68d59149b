"""HTTP synthesis server over the ServingEngine (port of masg_tpu/cli/serve.py).

No reference counterpart: the reference's inference surface is one-shot CLI
scripts (synthesize.py:104-131); this is the serving face of the same
pipeline: the model and vocoder stay on the card, every (batch, text) bucket
runs once at start-up, and each request is one padded dispatch.

    python -m masg_tpu_torch.cli.serve -c <config_dir> -r <step> [--port 8000] \
        [--device cuda] [--dynamic_batch 32 [--data_parallel]]

Endpoints:
  GET  /health      -> {"status": "ok", "buckets": {...}, "requests": N, ...}
  POST /synthesize  -> audio/wav (RIFF, 16-bit PCM)
  POST /synthesize_streaming -> chunked audio/wav: the first PCM block
      arrives after ONE vocoder window (ServingEngine.synthesize_streaming),
      not the whole utterance's vocode
      JSON body: {"phones": "{k o N n i ch i w a}",  # or "text" + "language"
                  "accents": "0[0000]00",             # optional
                  "speaker_id": 0,                    # or "speaker_emb": [..]
                  "pitch_control": 1.0, "energy_control": 1.0,
                  "duration_control": 1.0}
      with "format": "json" instead returns {"mel_len", "latency_s",
      "sample_rate", "bucket", "wav_b64"}.

Concurrency: ThreadingHTTPServer handles sockets concurrently; device work
is serialized inside the engine (one queue). `--data_parallel` splits each
batched dispatch over one replica per card (`ServingEngine(devices=)`).
masg_tpu's XLA compile cache has no counterpart here.
"""

from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
import struct
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..infer.serving import RequestTimeout, ServerOverloaded


# wav_bytes and request_to_ids: copied from masg_tpu/cli/serve.py
def wav_bytes(pcm: np.ndarray, sample_rate: int) -> bytes:
    """int16 mono PCM -> RIFF/WAVE bytes."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())
    return buf.getvalue()


def request_to_ids(req: dict, lexicon_path=None, config_dir=None):
    """Request JSON -> (phone ids, accent ids or None).

    Every unknown symbol (phone, accent char or pinyin) raises ValueError, so
    the HTTP layer maps client input errors to 400, not 500."""
    from ..text import ACCENT_TO_ID, phone_string_to_sequence, text_to_sequence

    accent_ids = None
    try:
        if "phones" in req:
            ids = phone_string_to_sequence(req["phones"])
            if req.get("accents"):
                accent_ids = [ACCENT_TO_ID[c] for c in req["accents"]][: len(ids)]
        elif "text" in req:
            lang = req.get("language", "ja")
            if lang == "ja":
                from ..text.g2p import preprocess_japanese

                phones, accents = preprocess_japanese(req["text"])
                ids = text_to_sequence(phones)
                if req.get("use_accent"):
                    accent_ids = [ACCENT_TO_ID[c] for c in accents][: len(ids)]
            elif lang == "en":
                from ..text.g2p import preprocess_english

                ids = text_to_sequence(preprocess_english(req["text"]))
            else:
                from ..text import pinyin_to_sequence
                from ..text.g2p import preprocess_mandarin, resolve_lexicon_path

                ids = pinyin_to_sequence(preprocess_mandarin(
                    req["text"], resolve_lexicon_path(lexicon_path, config_dir)))
        else:
            raise ValueError("request needs 'phones' or 'text'")
    except KeyError as e:  # unknown symbol = client error -> 400
        raise ValueError(f"unknown symbol in request: {e}") from e
    return ids, accent_ids


class SynthesisHandler(BaseHTTPRequestHandler):
    engine = None  # a ServingEngine or DynamicBatcher, set by make_server
    lexicon_path = None  # --lexicon flag; resolved per request (zh only)
    config_dir = None  # fallback lexicon search root
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, payload: dict, headers: Optional[dict] = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, e: Exception):
        """Batcher sheds -> 503 + Retry-After / 504; anything else -> 500."""
        if isinstance(e, ServerOverloaded):
            self._json(503, {"error": str(e)},
                       {"Retry-After": str(int(round(e.retry_after_s)))})
        elif isinstance(e, RequestTimeout):
            self._json(504, {"error": str(e)})
        else:
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        if self.path == "/health":
            e = self.engine
            self._json(200, {
                "status": "ok",
                "buckets": {str(L): e.mel_caps[L] for L in e.text_buckets},
                "sample_rate": e.sample_rate,
                "requests": e.n_requests,
                "batches": getattr(e, "n_batches", 0),
                "queue_depth": len(getattr(e, "_queue", ())),
                "shed_overload": getattr(e, "n_shed_overload", 0),
                "shed_timeout": getattr(e, "n_shed_timeout", 0),
            })
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _read_request(self):
        n = int(self.headers.get("Content-Length", "0"))
        req = json.loads(self.rfile.read(n) or b"{}")
        ids, accent_ids = request_to_ids(req, self.lexicon_path, self.config_dir)
        kwargs = dict(
            accent_ids=accent_ids,
            speaker_id=int(req.get("speaker_id", 0)),
            pitch_control=float(req.get("pitch_control", 1.0)),
            energy_control=float(req.get("energy_control", 1.0)),
            duration_control=float(req.get("duration_control", 1.0)),
        )
        emb = req.get("speaker_emb")
        return req, ids, kwargs, (np.asarray([emb], np.float32) if emb is not None else None)

    def _stream_wav(self, gen, sample_rate):
        """Chunked-transfer streaming WAV: a RIFF header with the unknown-
        length convention (0xFFFFFFFF sizes), then one HTTP chunk per PCM
        block as the vocoder produces it."""
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Sample-Rate", str(sample_rate))
        self.end_headers()

        def chunk(b: bytes):
            self.wfile.write(f"{len(b):X}\r\n".encode())
            self.wfile.write(b)
            self.wfile.write(b"\r\n")
            self.wfile.flush()

        chunk(b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
              + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
              + b"data" + struct.pack("<I", 0xFFFFFFFF))
        for pcm in gen:
            chunk(np.ascontiguousarray(pcm).tobytes())
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def do_POST(self):
        if self.path == "/synthesize_streaming":
            self._synthesize_streaming()
        elif self.path == "/synthesize":
            self._synthesize()
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def _synthesize_streaming(self):
        try:
            _, ids, kwargs, emb = self._read_request()
            if emb is None and len(ids) > self.engine.text_buckets[-1]:
                # over-bucket texts: synthesize through pause-chunking (as
                # /synthesize does) and stream the stitched wav in fixed PCM
                # slices; first-audio latency is not improved here, but the
                # endpoint stays consistent and memory stays bounded
                wav = self.engine.synthesize_chunked(ids, **kwargs)["wav"]
                step = 192 * self.engine.hop
                gen = (wav[i:i + step] for i in range(0, len(wav), step))
            else:
                gen = self.engine.synthesize_streaming(ids, speaker_emb=emb, **kwargs)
            first = next(gen)  # synthesis errors surface as JSON, not as a broken stream
        except (ValueError, StopIteration) as e:
            self._json(400, {"error": str(e) or "empty synthesis"})
            return
        except Exception as e:
            self._error(e)
            return
        self._stream_wav(itertools.chain([first], gen), self.engine.sample_rate)

    def _synthesize(self):
        try:
            req, ids, kwargs, emb = self._read_request()
            # texts longer than the largest bucket chunk at pause phones and
            # stitch (ServingEngine.synthesize_chunked) instead of 400ing
            synth = (self.engine.synthesize_chunked
                     if emb is None and len(ids) > self.engine.text_buckets[-1]
                     else self.engine.synthesize)
            result = synth(ids, speaker_emb=emb, **kwargs)
        except ValueError as e:
            self._json(400, {"error": str(e)})
            return
        except Exception as e:  # surface the cause, don't kill the handler
            self._error(e)
            return

        head = {"mel_len": result["mel_len"], "latency_s": result["latency_s"],
                "sample_rate": result["sample_rate"], "bucket": result["bucket"]}
        if "wav" not in result:
            mel = result["mel"].astype(np.float32)
            self._json(200, head | {"n_mels": int(mel.shape[-1]),
                                    "mel_b64": base64.b64encode(mel.tobytes()).decode()})
        elif req.get("format") == "json":
            self._json(200, head | {"wav_b64": base64.b64encode(
                wav_bytes(result["wav"], result["sample_rate"])).decode()})
        else:
            body = wav_bytes(result["wav"], result["sample_rate"])
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Latency-S", f"{result['latency_s']:.4f}")
            self.send_header("X-Mel-Len", str(result["mel_len"]))
            self.end_headers()
            self.wfile.write(body)


def make_server(engine, host: str = "127.0.0.1", port: int = 8000,
                lexicon_path=None, config_dir=None) -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) and return the server; the caller runs
    serve_forever(). Split from main() so tests can drive it in-process."""
    handler = type("BoundHandler", (SynthesisHandler,), {
        "engine": engine, "lexicon_path": lexicon_path, "config_dir": config_dir})
    return ThreadingHTTPServer((host, port), handler)


def data_parallel_devices(device: str, dynamic_batch: int) -> list:
    """masg_tpu's `--data_parallel` sizing: the data axis fits the LARGEST
    batch bucket the DynamicBatcher dispatches (powers of 2 up to
    `dynamic_batch`), since a wider one divides no batch and shards nothing;
    one card per replica (the CPU counts as one device)."""
    import torch

    from ..parallel.mesh import data_parallel_size

    max_bucket = 1
    while max_bucket < dynamic_batch:
        max_bucket *= 2
    n_dev = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    n_data = data_parallel_size(max_bucket, n_dev)
    if n_data <= 1:
        print(f"warning: --data_parallel with --dynamic_batch {dynamic_batch} shards "
              f"nothing (largest batch bucket {max_bucket} / {n_dev} devices); raise "
              f"--dynamic_batch to at least the device count", flush=True)
    if torch.device(device).type != "cuda":
        return [device] * n_data
    return [f"cuda:{i}" for i in range(n_data)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-r", "--restore_step", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="reference-format FastSpeech2 checkpoint "
                             "({'model': state_dict}), instead of -r")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--buckets", default="16,32,64,128",
                        help="comma-separated text-length bucket ladder")
    parser.add_argument("--frames_per_phone", type=int, default=12)
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--no_vocoder", action="store_true",
                        help="serve mels only (skip HiFi-GAN)")
    parser.add_argument("--vocoder_checkpoint", default=None,
                        help="HiFi-GAN generator checkpoint (torch {'generator': "
                             "state_dict} or masg_tpu's flax .msgpack)")
    parser.add_argument("--dynamic_batch", type=int, default=32,
                        help=">1: fuse concurrent requests into one batched dispatch "
                             "(DynamicBatcher) of up to this many; 1 disables batching. "
                             "The default is masg_tpu's; PERF.md section 5 gives the "
                             "card's time per dispatch at B = 8/16/32")
    parser.add_argument("--batch_window_ms", type=float, default=5.0,
                        help="arrival window for request fusion")
    parser.add_argument("--max_queue", type=int, default=None,
                        help="batcher queue depth cap: requests beyond it get 503 + "
                             "Retry-After instead of unbounded queue latency (default "
                             "8x --dynamic_batch; 0 disables shedding)")
    parser.add_argument("--request_timeout", type=float, default=None,
                        help="per-request deadline in seconds: queued requests past it "
                             "are shed (504) without spending device time")
    parser.add_argument("--lexicon", default=None,
                        help="pinyin lexicon path (zh requests); defaults to "
                             "<config_dir>/lexicon/pinyin-lexicon-r.txt or cwd")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard batched dispatches over the cards (one replica each); "
                             "scales --dynamic_batch throughput with the card count")
    args = parser.parse_args(argv)

    import torch

    from ..core.config import load_config_dir
    from ..infer.serving import DynamicBatcher, ServingEngine
    from ..infer.vocoder import get_vocoder

    cfg = load_config_dir(args.config)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    vocoder = None
    if not args.no_vocoder:
        vocoder = get_vocoder(cfg.model, cfg.config_dir, checkpoint=args.vocoder_checkpoint,
                              device=args.device, dtype=dtype)
    devices = None
    if args.data_parallel:
        devices = data_parallel_devices(args.device, args.dynamic_batch)
        print(f"data-parallel serving over {len(devices)} devices", flush=True)
    engine = ServingEngine(cfg, restore_step=args.restore_step, checkpoint=args.checkpoint,
                           vocoder=vocoder,
                           text_buckets=tuple(int(b) for b in args.buckets.split(",")),
                           frames_per_phone=args.frames_per_phone, dtype=dtype,
                           device=args.device, devices=devices)
    batch_ladder = (1,)
    batcher = None
    if args.dynamic_batch > 1:
        max_queue = 8 * args.dynamic_batch if args.max_queue is None else args.max_queue
        batcher = DynamicBatcher(engine, max_batch=args.dynamic_batch,
                                 window_ms=args.batch_window_ms,
                                 max_queue=max_queue or None,
                                 request_timeout_s=args.request_timeout)
        batch_ladder = tuple(batcher._buckets)  # warm the exact dispatch shapes
    print("warming up buckets...", flush=True)
    for (B, L), dt in engine.warmup(include_speaker_emb=True,
                                    batch_sizes=batch_ladder).items():
        print(f"  bucket B={B} L={L} (T={engine.mel_caps[L]}): {dt:.2f}s", flush=True)

    server = make_server(batcher or engine, args.host, args.port, lexicon_path=args.lexicon,
                         config_dir=cfg.config_dir)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()


if __name__ == "__main__":
    main()
