"""Serving engine: bucketed text->wav synthesis behind a dynamic batcher
(port of masg_tpu/infer/serving.py).

The reference has no serving story: inference is one-shot CLI scripts that
pay model construction on every invocation (synthesize.py:104-131). The
engine holds one model and vocoder on the card and pads every request onto a
small ladder of (text length, mel cap) buckets, masg_tpu's shapes: each text
bucket L gets the mel cap min(max_seq_len, round_up(L * frames_per_phone,
128)). masg_tpu compiles one fused graph per bucket; here the same
per-bucket shapes run eagerly, FastSpeech2 through the flash-attention
kernel (K1) and the vocoder through the fused MRF kernel (K4), under
`torch.inference_mode()`. `warmup` runs every (batch, text) bucket once, which
builds the kernel libraries and warms cuDNN.

Per-request controls go in as (B, 1) float32 tensors, so one batched dispatch
can mix control values.

Thread safety: every use of the device holds the engine lock: the kernel
wrappers keep shared Python state (launch counters, the generator's packed
weights), so concurrent HTTP handlers and the batcher's worker queue for the
card instead of interleaving on it. A stream takes the lock once per vocoder
window, so requests interleave between windows. Every request tensor is put
on the engine's device explicitly, and `torch.inference_mode()` is entered
per call (it is thread-local).

Data-parallel serving (masg_tpu's `mesh=`, `_place_dp`): given `devices`,
the engine holds one replica of the model and the vocoder per device, in
one process. A dispatch whose batch divides into len(devices) equal row
blocks runs block i on replica i (the launches are queued on every card
before any result is read, so the cards overlap) and concatenates the
blocks on the first device; any other batch (the B = 1 latency path) runs
whole on the first replica, as masg_tpu replicates it.

`DynamicBatcher`, `ServerOverloaded`, `RequestTimeout` and `pick_bucket` are
plain Python, copied from masg_tpu/infer/serving.py.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compat.from_jax import with_duration_bias  # noqa: F401  (re-exported, as masg_tpu's)
from ..core.config import ExperimentConfig
from ..device import DeviceLike, resolve_device
from ..text import NO_ACCENT_ID
from .synthesis import chunk_phone_ids, load_model, round_up
from .vocoder import Vocoder, to_int16, vocode_streaming


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; raises if the request exceeds the ladder."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"request length {n} exceeds the largest text bucket {buckets[-1]}")


class ServingEngine:
    """Synthesis service over one model + vocoder on one device.

    Parameters
    ----------
    cfg: experiment config (the reference 3-file YAML dir, loaded).
    restore_step: checkpoint step to restore from the config's ckpt_path
        (0 = seeded random weights).
    state_dict: optional FastSpeech2 weights (overrides restore_step).
    checkpoint: optional reference-format `{'model': state_dict}` file.
    vocoder: a Vocoder, or None to emit mels only. It runs in the engine's
        dtype on its device: a vocoder in another dtype or on another device
        is copied there (`dtype=torch.bfloat16` casts the vocoder too).
    text_buckets: ladder of padded phone lengths, ascending.
    frames_per_phone: mel-frame budget per phone (the mel caps above).
    dtype, device: the model's dtype and device (the card when None).
    use_flash: attention through kernel K1 (the vocoder's `fused_mrf` is its
        own switch).
    devices: data-parallel serving over these devices (one replica each;
        `device` is then the first), e.g. `["cuda:0", "cuda:1"]`.
    """

    def __init__(self, cfg: ExperimentConfig, restore_step: int = 0,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 vocoder: Optional[Vocoder] = None,
                 text_buckets: Sequence[int] = (16, 32, 64, 128),
                 frames_per_phone: int = 12, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, use_flash: bool = True,
                 checkpoint: Optional[str] = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        self.cfg = cfg
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.dtype = dtype
        self.text_buckets = tuple(sorted(text_buckets))
        self.hop = cfg.preprocess.stft.hop_length
        self.sample_rate = cfg.preprocess.audio.sampling_rate
        self.meta_dim = cfg.preprocess.speaker_generation.one_hot_dim

        self.model = load_model(cfg, checkpoint, device=self.device, dtype=dtype,
                                use_flash=use_flash,
                                restore_step=restore_step if state_dict is None else 0)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        if vocoder is not None and (vocoder.dtype != dtype or vocoder.device != self.device):
            vocoder = vocoder.to(self.device, dtype)
        self.vocoder = vocoder
        # one (model, vocoder) per device; the first is the one above
        self.replicas = [(self.model, vocoder)] + [
            (copy.deepcopy(self.model).to(d),
             None if vocoder is None else vocoder.to(d, dtype))
            for d in self.devices[1:]]

        self.mel_caps: Dict[int, int] = {
            L: min(cfg.model.max_seq_len, round_up(L * frames_per_phone, 128))
            for L in self.text_buckets}
        self._lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0  # batched dispatches via synthesize_many
        # the batch ladder synthesize_many/synthesize_chunked dispatch on;
        # warmup overwrites it with the sizes it ran
        self.batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)

    # ------------------------------------------------------------------
    def warmup(self, include_speaker_emb: bool = False,
               batch_sizes: Sequence[int] = (1,)) -> Dict[Tuple[int, int], float]:
        """Run every (batch, text) bucket once; returns seconds keyed (B, L).
        The first run builds the kernel libraries; pass the dynamic-batching
        ladder (e.g. (1, 2, 4, 8)) so every dispatch shape has run."""
        self.batch_buckets = tuple(sorted(set(batch_sizes)))
        times: Dict[Tuple[int, int], float] = {}
        for L in self.text_buckets:
            for B in batch_sizes:
                t0 = time.perf_counter()
                with self._lock:
                    out, _ = self._run(np.ones((B, L), np.int32), np.full(B, L, np.int32),
                                       np.zeros((B, L), np.int32))
                    out[:1, :1].cpu()  # the host fetch waits for the device
                times[(B, L)] = time.perf_counter() - t0
            if include_speaker_emb:
                emb_dim = self.cfg.model.transformer.encoder_hidden
                with self._lock:
                    out, _ = self._run(np.ones((1, L), np.int32), np.asarray([L], np.int32),
                                       np.zeros((1, L), np.int32),
                                       speaker_emb=np.zeros((1, emb_dim), np.float32))
                    out[:1, :1].cpu()
        return times

    # ------------------------------------------------------------------
    def _run(self, texts: np.ndarray, src_lens: np.ndarray, accents: np.ndarray,
             speaker_id=0, speaker_meta: Optional[np.ndarray] = None,
             speaker_emb: Optional[np.ndarray] = None,
             controls=(1.0, 1.0, 1.0), mel_only: bool = False):
        """One dispatch at the (B, L) of `texts`: FastSpeech2 free-running to
        the bucket's mel cap, then (unless `mel_only` or mel-only engine) the
        vocoder over the full padded mel. Returns (wav or postnet_mel, mel_len)
        as tensors on the (first) device. With several replicas a batch that
        divides into equal row blocks runs a block on each. The caller holds
        the engine lock."""
        B = texts.shape[0]
        n = len(self.replicas)
        c = np.asarray(controls, np.float32)
        if c.ndim == 1:  # shared controls -> one row per batch item
            c = np.tile(c, (B, 1))
        spk = np.asarray(speaker_id, np.int64)
        if spk.ndim == 0:
            spk = np.full((B,), spk, np.int64)
        if n == 1 or B % n:
            return self._run_on(0, texts, src_lens, accents, spk, speaker_meta, speaker_emb,
                                c, mel_only)
        per = B // n

        def rows(a, i):
            return None if a is None else np.asarray(a)[i * per:(i + 1) * per]

        parts = [self._run_on(i, *(rows(a, i) for a in (texts, src_lens, accents, spk,
                                                        speaker_meta, speaker_emb, c)),
                              mel_only)
                 for i in range(n)]
        return tuple(torch.cat([p[j].to(self.device) for p in parts]) for j in range(2))

    def _run_on(self, i: int, texts, src_lens, accents, spk, speaker_meta, speaker_emb, c,
                mel_only: bool):
        """`_run` on replica i, whose device gets every input."""
        B, L = texts.shape
        T = self.mel_caps[L]
        dev = self.devices[i]
        model, vocoder = self.replicas[i]
        c = torch.as_tensor(c, device=dev)
        p_c, e_c, d_c = c[:, 0:1], c[:, 1:2], c[:, 2:3]

        def ids(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)

        with torch.inference_mode():
            if speaker_emb is not None:
                emb = torch.as_tensor(np.asarray(speaker_emb, np.float32), device=dev,
                                      dtype=self.dtype)
                out = model.synthesize_from_speaker_emb(
                    ids(texts), ids(src_lens), T, emb, p_control=p_c, e_control=e_c,
                    d_control=d_c, accents=ids(accents))
            else:
                meta = (np.asarray(speaker_meta, np.float32) if speaker_meta is not None
                        else np.zeros((B, self.meta_dim), np.float32))
                out = model(ids(spk), ids(texts), ids(src_lens), T,
                            p_control=p_c, e_control=e_c, d_control=d_c, accents=ids(accents),
                            speaker_meta=torch.as_tensor(meta, device=dev, dtype=self.dtype))
            if mel_only or vocoder is None:
                return out.postnet_mel, out.mel_len
            return vocoder(out.postnet_mel), out.mel_len

    # ------------------------------------------------------------------
    def _pad_request(self, ids, accent_ids):
        """Pad ids/accents onto the smallest fitting text bucket; unspecified
        accent tails degrade to NO_ACCENT_ID."""
        n = len(ids)
        if n == 0:
            raise ValueError("empty phone sequence")
        L = pick_bucket(n, self.text_buckets)
        texts = np.zeros((1, L), np.int32)
        texts[0, :n] = np.asarray(ids, np.int32)
        acc = np.zeros((1, L), np.int32)
        if accent_ids is not None:
            m = min(len(accent_ids), n)
            acc[0, :m] = np.asarray(accent_ids[:m], np.int32)
            acc[0, m:n] = NO_ACCENT_ID
        else:
            acc[0, :n] = NO_ACCENT_ID
        return texts, np.asarray([n], np.int32), acc, L

    # ------------------------------------------------------------------
    def synthesize(self, ids: Sequence[int], accent_ids: Optional[Sequence[int]] = None,
                   speaker_id: int = 0, speaker_meta: Optional[np.ndarray] = None,
                   speaker_emb: Optional[np.ndarray] = None, pitch_control: float = 1.0,
                   energy_control: float = 1.0, duration_control: float = 1.0
                   ) -> Dict[str, object]:
        """One utterance -> int16 wav (or mel when built without a vocoder).

        Returns {"wav" or "mel", "mel_len", "sample_rate", "latency_s",
        "bucket"}. Pads onto the smallest fitting text bucket and truncates
        the output to mel_len frames (* hop samples).

        Tail semantics (masg_tpu's): the vocoder runs over the FULL padded
        mel and the wav is trimmed, so the last ~receptive-field samples
        reflect the free-running frames past mel_len; synthesize_streaming
        vocodes the mel trimmed to mel_len (the reference pipeline's
        semantics, utils/model.py:74-92).
        """
        texts, src_lens, acc, L = self._pad_request(ids, accent_ids)
        t0 = time.perf_counter()
        with self._lock:
            out, mel_len = self._run(texts, src_lens, acc, speaker_id, speaker_meta,
                                     speaker_emb,
                                     (pitch_control, energy_control, duration_control))
            mel_len = int(mel_len[0])
            out = out[0].float().cpu().numpy()
            self.n_requests += 1
        latency = time.perf_counter() - t0

        result = {"mel_len": mel_len, "sample_rate": self.sample_rate,
                  "latency_s": latency, "bucket": L}
        if self.vocoder is None:
            result["mel"] = out[:mel_len]
        else:
            result["wav"] = to_int16(out[: mel_len * self.hop], self.vocoder.max_wav_value)
        return result

    # ------------------------------------------------------------------
    def synthesize_streaming(self, ids: Sequence[int],
                             accent_ids: Optional[Sequence[int]] = None,
                             speaker_id: int = 0, speaker_meta: Optional[np.ndarray] = None,
                             speaker_emb: Optional[np.ndarray] = None,
                             pitch_control: float = 1.0, energy_control: float = 1.0,
                             duration_control: float = 1.0, chunk_frames: int = 192,
                             context_frames: Optional[int] = None):
        """Generator of int16 PCM chunks: the acoustic model runs once
        (mel only), then the vocoder streams receptive-field-exact windows
        (`vocode_streaming`), so the first audio comes after one vocoder
        window instead of the whole utterance's. The concatenated chunks
        equal vocoding the trimmed mel in one shot (the reference pipeline's
        semantics; see the tail note on `synthesize`)."""
        if self.vocoder is None:
            raise ValueError("streaming synthesis requires a vocoder")
        texts, src_lens, acc, L = self._pad_request(ids, accent_ids)
        with self._lock:
            mel, mel_len = self._run(texts, src_lens, acc, speaker_id, speaker_meta,
                                     speaker_emb,
                                     (pitch_control, energy_control, duration_control),
                                     mel_only=True)
            mel_len = int(mel_len[0])
            mel = mel[:1, :mel_len].float()
            self.n_requests += 1
        yield from vocode_streaming(self.vocoder, mel, chunk_frames, context_frames,
                                    lock=self._lock)

    # ------------------------------------------------------------------
    def synthesize_many(self, requests: List[dict],
                        batch_buckets: Optional[Sequence[int]] = None
                        ) -> List[Dict[str, object]]:
        """Fuse N speaker-id requests into ONE dispatch.

        Each request is the kwargs of `synthesize` (speaker_emb is not
        batchable: those go through the per-request path). All texts pad to
        the largest needed text bucket; the batch pads to the next batch
        bucket by repeating row 0 (pad outputs are discarded), so the dispatch
        shapes stay len(text_buckets) x len(batch_buckets).
        """
        if not requests:
            return []
        for r in requests:
            if r.get("speaker_emb") is not None:
                raise ValueError("synthesize_many: speaker_emb path not batchable")
            if len(r["ids"]) == 0:  # len(): ids may be a numpy array
                raise ValueError("empty phone sequence")
        L = pick_bucket(max(len(r["ids"]) for r in requests), self.text_buckets)
        n = len(requests)
        B = pick_bucket(n, batch_buckets or self.batch_buckets)

        texts = np.zeros((B, L), np.int32)
        acc = np.zeros((B, L), np.int32)
        src_lens = np.ones(B, np.int32)
        spk = np.zeros(B, np.int64)
        meta = np.zeros((B, self.meta_dim), np.float32)
        controls = np.ones((B, 3), np.float32)
        for i, r in enumerate(requests):
            ids = r["ids"]
            k = len(ids)
            texts[i, :k] = np.asarray(ids, np.int32)
            a = r.get("accent_ids")
            if a is not None:
                m = min(len(a), k)
                acc[i, :m] = np.asarray(a[:m], np.int32)
                acc[i, m:k] = NO_ACCENT_ID  # short accents degrade to no-accent
            else:
                acc[i, :k] = NO_ACCENT_ID
            src_lens[i] = k
            spk[i] = int(r.get("speaker_id", 0))
            if r.get("speaker_meta") is not None:
                meta[i] = np.asarray(r["speaker_meta"], np.float32).reshape(-1)
            controls[i] = (r.get("pitch_control", 1.0), r.get("energy_control", 1.0),
                           r.get("duration_control", 1.0))
        for i in range(n, B):  # pad rows: repeat row 0, discard outputs
            texts[i], acc[i], src_lens[i] = texts[0], acc[0], src_lens[0]
            spk[i], meta[i], controls[i] = spk[0], meta[0], controls[0]

        t0 = time.perf_counter()
        with self._lock:
            out, mel_len = self._run(texts, src_lens, acc, spk, meta, None, controls)
            mel_len = mel_len.cpu().numpy()
            out = out[:n].float().cpu().numpy()
            self.n_requests += n
            self.n_batches += 1
        latency = time.perf_counter() - t0

        results = []
        for i in range(n):
            # clamp to the request's OWN bucket cap: co-batched longer texts
            # raise the dispatch's T, and without this a saturating request
            # would return other-length audio than the single path
            own_cap = self.mel_caps[pick_bucket(len(requests[i]["ids"]), self.text_buckets)]
            ml = min(int(mel_len[i]), own_cap)
            r = {"mel_len": ml, "sample_rate": self.sample_rate, "latency_s": latency,
                 "bucket": L, "batch": n}
            if self.vocoder is None:
                r["mel"] = out[i, :ml]
            else:
                r["wav"] = to_int16(out[i, : ml * self.hop], self.vocoder.max_wav_value)
            results.append(r)
        return results

    # ------------------------------------------------------------------
    def synthesize_chunked(self, ids, accent_ids=None, **kwargs) -> Dict[str, object]:
        """Serve a text LONGER than the largest bucket: split at pause phones
        (`chunk_phone_ids`), run the chunks as batched dispatches over the
        bucket ladder (`synthesize_many`), stitch the audio in order. Seams
        land on silence."""
        if len(list(ids)) == 0:
            raise ValueError("empty phone sequence")
        chunks = chunk_phone_ids(list(ids), accent_ids, max_phones=self.text_buckets[-1])
        reqs = [dict(kwargs, ids=c, accent_ids=a) for c, a in chunks]
        stride = self.batch_buckets[-1]  # groups ride the warmed ladder
        parts, latency = [], 0.0
        for i in range(0, len(reqs), stride):
            group = self.synthesize_many(reqs[i:i + stride])
            latency += group[0]["latency_s"]  # one dispatch per group
            parts.extend(group)
        key = "mel" if self.vocoder is None else "wav"
        return {
            key: np.concatenate([p[key] for p in parts], axis=0),
            "mel_len": int(sum(p["mel_len"] for p in parts)),
            "sample_rate": self.sample_rate,
            "latency_s": latency,
            "bucket": max(p["bucket"] for p in parts),
            "n_chunks": len(parts),
        }


# --- copied from masg_tpu/infer/serving.py (plain Python) ---------------------


class ServerOverloaded(RuntimeError):
    """The batcher's queue is at its depth cap: shed the request instead of
    letting queue latency grow without bound. `retry_after_s` estimates when
    capacity frees up (queue depth x recent per-request service time)."""

    def __init__(self, depth: int, max_queue: int, retry_after_s: float):
        super().__init__(f"server overloaded: queue depth {depth} >= cap {max_queue}")
        self.retry_after_s = retry_after_s


class RequestTimeout(RuntimeError):
    """Request exceeded its deadline while queued or in flight."""


class DynamicBatcher:
    """Transparent request batcher in front of a ServingEngine.

    Concurrent `synthesize` calls arriving within `window_ms` of each other
    fuse into one batched dispatch (up to `max_batch`); a lone request
    dispatches right after the window. speaker_emb requests bypass the batcher
    (un-batchable path).

    Overload: with `max_queue` set, requests arriving at a full queue raise
    ServerOverloaded (HTTP 503 + Retry-After) instead of queuing without
    bound; with `request_timeout_s` set, a request that cannot finish inside
    its deadline raises RequestTimeout (HTTP 504): expired requests still in
    the queue are shed without spending device time, and dead entries never
    trigger sheds of live traffic. Un-batchable surfaces (speaker_emb,
    synthesize_chunked, synthesize_streaming) shed through bypass_guard
    against the same max_queue cap. An in-flight request that overruns its
    deadline gets one dispatch-scale grace period (its device time is already
    spent) before it raises, counted in n_timeout_inflight.
    """

    def __init__(self, engine: ServingEngine, max_batch: int = 8, window_ms: float = 5.0,
                 max_queue: Optional[int] = None,
                 request_timeout_s: Optional[float] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.max_queue = max_queue
        self.request_timeout_s = request_timeout_s
        # EMA of per-request service time for the Retry-After estimate, seeded
        # pessimistically and corrected by the first real batch
        self._ema_s_per_req = 0.1
        self.n_shed_overload = 0
        self.n_shed_timeout = 0
        # caller-side deadline overruns of requests already in flight
        self.n_timeout_inflight = 0
        # concurrent un-batchable bypass requests holding the engine, capped
        # by max_queue so overload protection covers the bypass paths too
        self._n_bypass = 0
        self._buckets = [1]
        while self._buckets[-1] < max_batch:
            self._buckets.append(self._buckets[-1] * 2)
        self._queue: List[Tuple[dict, threading.Event, dict]] = []
        self._mutex = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._worker = threading.Thread(target=self._drain_loop, daemon=True)
        self._worker.start()

    def close(self):
        # _stop flips under the mutex so no submitter can pass its _stop
        # check and append after the leftover drain below
        with self._mutex:
            self._stop = True
        self._wake.set()
        self._worker.join(timeout=5)
        # fail any request still queued: a caller blocked on done.wait()
        # must never hang
        with self._mutex:
            leftovers, self._queue = self._queue, []
        for _, done, slot in leftovers:
            slot["error"] = RuntimeError("DynamicBatcher closed")
            done.set()

    def __getattr__(self, name):
        # passthrough (mel_caps, text_buckets, n_requests, ...) so the HTTP
        # layer can front either an engine or a batcher
        return getattr(self.engine, name)

    # un-batchable surfaces are wrapped explicitly (not passthrough) so the
    # overload shed covers them too; see bypass_guard
    def synthesize_chunked(self, ids, **kwargs) -> Dict[str, object]:
        with self.bypass_guard():
            return self.engine.synthesize_chunked(ids, **kwargs)

    def synthesize_streaming(self, ids, **kwargs):
        # the guard is held for the generator's lifetime: streaming spends
        # device time on every pull, not just at creation
        with self.bypass_guard():
            yield from self.engine.synthesize_streaming(ids, **kwargs)

    @contextlib.contextmanager
    def bypass_guard(self):
        """Overload shed for requests that bypass the batch queue: counts
        concurrent bypass requests against max_queue and raises
        ServerOverloaded past the cap, so the 503 + Retry-After contract
        holds on every path."""
        if self.max_queue is None:
            yield
            return
        with self._mutex:
            if self._n_bypass >= self.max_queue:
                self.n_shed_overload += 1
                retry = max(1.0, self._n_bypass * self._ema_s_per_req)
                raise ServerOverloaded(self._n_bypass, self.max_queue, retry)
            self._n_bypass += 1
        try:
            yield
        finally:
            with self._mutex:
                self._n_bypass -= 1

    def synthesize(self, ids, **kwargs) -> Dict[str, object]:
        if kwargs.get("speaker_emb") is not None:
            with self.bypass_guard():
                return self.engine.synthesize(ids, **kwargs)
        ids = list(ids)
        # validate now, against this caller only: a bad request raised inside
        # the worker would fail every co-batched request
        if len(ids) == 0:
            raise ValueError("empty phone sequence")
        pick_bucket(len(ids), self.engine.text_buckets)  # raises on oversize
        req = dict(kwargs, ids=ids)
        done = threading.Event()
        slot: dict = {}
        if self.request_timeout_s is not None:
            slot["deadline"] = time.monotonic() + self.request_timeout_s
        expired = []
        with self._mutex:
            # close() flips _stop under the same lock before draining, so a
            # request either enqueues before the drain (and close fails it)
            # or raises here: it never hangs
            if self._stop:
                raise RuntimeError("DynamicBatcher closed")
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                # dead entries (callers already timed out) must not trigger
                # spurious sheds: prune them before comparing with the cap
                if self.request_timeout_s is not None:
                    now = time.monotonic()
                    live = []
                    for item in self._queue:
                        (expired if item[2].get("deadline", now + 1) < now
                         else live).append(item)
                    self._queue = live
                if len(self._queue) >= self.max_queue:
                    self.n_shed_overload += 1
                    retry = max(1.0, len(self._queue) * self._ema_s_per_req)
                    raise ServerOverloaded(len(self._queue), self.max_queue, retry)
            self._queue.append((req, done, slot))
        for _, edone, eslot in expired:
            self.n_shed_timeout += 1
            eslot["error"] = RequestTimeout(
                f"request expired after {self.request_timeout_s}s in queue")
            edone.set()
        self._wake.set()
        # wait slightly past the deadline: in-flight completion beats raising
        if not done.wait(None if self.request_timeout_s is None
                         else self.request_timeout_s + self.window_s):
            if slot.get("dispatched"):
                # already spending device time: one dispatch-scale grace
                grace = max(1.0, self._ema_s_per_req * self.max_batch * 2)
                if not done.wait(grace):
                    self.n_timeout_inflight += 1
                    raise RequestTimeout(
                        f"request exceeded {self.request_timeout_s}s "
                        f"(+{grace:.1f}s in-flight grace, still finishing)")
            else:
                raise RequestTimeout(f"request exceeded {self.request_timeout_s}s "
                                     f"(still queued)")
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _drain_loop(self):
        while not self._stop:
            self._wake.wait()
            if self._stop:
                return
            time.sleep(self.window_s)  # let concurrent arrivals accumulate
            now = time.monotonic()
            expired = []
            with self._mutex:
                # shed already-expired requests without spending device time
                if self.request_timeout_s is not None:
                    live = []
                    for item in self._queue:
                        (expired if item[2].get("deadline", now + 1) < now
                         else live).append(item)
                    self._queue = live
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
                for _, _, slot in batch:
                    # callers tell queued (hard 504) from in-flight (grace)
                    # timeouts by this marker
                    slot["dispatched"] = True
                if not self._queue:
                    self._wake.clear()
            for _, done, slot in expired:
                self.n_shed_timeout += 1
                slot["error"] = RequestTimeout(
                    f"request expired after {self.request_timeout_s}s in queue")
                done.set()
            if not batch:
                continue
            try:
                t0 = time.monotonic()
                results = self.engine.synthesize_many([r for r, _, _ in batch],
                                                      batch_buckets=tuple(self._buckets))
                dt = (time.monotonic() - t0) / len(batch)
                self._ema_s_per_req += 0.2 * (dt - self._ema_s_per_req)
                for (_, done, slot), res in zip(batch, results):
                    slot["result"] = res
                    done.set()
            except Exception as e:
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()
