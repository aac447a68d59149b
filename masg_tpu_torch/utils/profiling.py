"""The port's tracing: spans and counters inside the program, a Chrome trace,
and a device barrier (port of masg_tpu/utils/profiling.py, widened).

Tracing follows the profiler. While a `torch.profiler` session is active
(any activities), or inside `recording()`, `span(name)` records
(id, name, parent, thread, start_ns, end_ns) and `count(name, n)` adds to a
counter; otherwise each costs one check and records nothing. A span's
parent is the innermost span open on the same thread. Times are
`time.time_ns()`, the realtime clock that the profiler stamps the card's
kernels with, so a span can be laid over the device trace. A span given a
CUDA tensor as `stream_time` also records a pair of timing events on that
device's current stream, and `spans()` gives the device time between them
(`stream_ms`) once the work has run. No span or counter waits for the
device; only `spans()` does, for the stream times it resolves.

An operator gets the spans beside the kernels with `trace(log_dir)`: inside
it each span also enters `torch.profiler.record_function`, so the Chrome
trace shows it on the host's row above the kernels it launched. Read the
raw records with `spans()` and `counters()` after the block; `clear()`
empties them.

Spans (S; "+ stream" where they take stream time) and counters (C) the
program records:

- S `fs2.variance_adaptor` + stream (`models/fastspeech2.py:_synthesis_core`):
  the duration, pitch and energy predictors, their embeddings and the
  length regulator;
- S `fs2.length_regulator` + stream (`models/variance_adaptor.py`), a child
  of the span above: the expansion of phones to the mel capacity;
- S `fs2.decoder` + stream (`_synthesis_core`): the decoder, `mel_linear`
  and the PostNet;
- S `vocoder.to_int16` (`infer/vocoder.py:vocoder_infer`): from the
  generator's output to the list of int16 rows. On the card: the conversion
  and trim there, the copy of the kept samples to page-locked memory, the
  wait for it (and so for the generator) and the row views; on the CPU:
  numpy's int16 conversion and trim of the float wav;
- C `vocoder.samples`, `vocoder.useful_samples` (`vocoder_infer`): the
  samples the generator made (B x T_cut x hop, T_cut the frames it ran
  over: `infer/vocoder.py:cut_frames`) and those kept after the trim;
- C `vocoder.cut_frames` (`vocoder_infer`): the mel frames the cut left out,
  B x (T - T_cut) a call (no key while the cut never engages; read by no
  metric);
- C `vocoder.device_int16` (`vocoder_infer`): the rows converted on the card
  (none on the CPU);
- S `data.to_device` (`train/step.py:batch_to_device`,
  `train/vocoder.py:batch_to_device`): a batch's host-to-device copies;
- S `train.forward` (the train step closures of `train/step.py`): the
  forward(s) and the loss;
- S `train.backward` (`train/step.py:_update`): autograd, the gradient fill
  and the reductions after it;
- S `train.optimizer` (`_update`): the master copy, the clip, Adam, the
  schedule, `zero_grad` and the copy back;
- S `vocoder_train.generator` + stream (`train/vocoder.py`, the GAN step):
  the generator's input mel (unless given) and its forward;
- S `vocoder_train.disc_update` + stream (the GAN step): the discriminators
  on the audio and the detached generator output, their loss's backward,
  the gradients' reduction (data parallel) and their AdamW update;
- S `vocoder_train.gen_update` + stream (the GAN step): the updated
  discriminators on the audio and the generator output, the adversarial,
  feature and mel losses (both loss mels), the backward into the generator,
  the reduction and its AdamW update;
- S `vocoder_train.optimizer` (the GAN step), a child of each of the two
  spans above: the AdamW step. Its `zero_grad` (`set_to_none`, no device
  work) opens the parent span, so a step's gradients stay on the parameters
  until the next step;
- C `vocoder_train.steps`, `vocoder_train.samples` (the GAN step): steps
  taken and audio samples trained on (B x segment a step, this rank's);
- C `hifigan.plain_mrf_stages` (`models/hifigan.py:HiFiGANGenerator.forward`):
  the MRF stages that ran block by block (cuDNN's convolutions on the
  card, ATen's on the CPU) instead of through `fused_mrf_stage`, on either
  device; every stage when the generator trains
  (`fused_mrf=False`), those above 64 channels in inference (none counted,
  and no key, when every stage is fused);
- C `profiling.dropped_spans` (here): spans not kept once `MAX_SPANS` are
  held.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

MAX_SPANS = 1 << 17

_profiler_enabled = torch._C._autograd._profiler_enabled
_recording = 0  # open `recording()` blocks
_trace_open = False  # inside `trace()`: spans also enter record_function


class Span(NamedTuple):
    id: int
    name: str
    parent: Optional[int]  # the id of the innermost span open on the thread, if any
    thread: int  # threading.get_ident() of the thread that opened it
    start_ns: int
    end_ns: int
    stream_ms: Optional[float]  # device time between its stream events, if it took them


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.ids = itertools.count()
            # [id, name, parent, thread, start_ns, end_ns, (event, event) or ms or None]
            self.done: List[list] = []
            self.counts: Dict[str, float] = {}

    def stack(self) -> List[int]:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, name: str, n: float) -> None:
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def keep(self, record: list) -> None:
        if len(self.done) < MAX_SPANS:
            self.done.append(record)
        else:
            self.add("profiling.dropped_spans", 1)


_R = _Recorder()


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "stream", "id", "parent", "t0", "events", "rf")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        self.t0 = time.time_ns()
        stack = _R.stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_R.ids)
        stack.append(self.id)
        self.rf = None
        if _trace_open:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.events = None
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _R.stack().pop()
        _R.keep([self.id, self.name, self.parent, threading.get_ident(), self.t0,
                 time.time_ns(), self.events])
        return False


def span(name: str, stream_time: Optional[torch.Tensor] = None):
    """A context manager that records the block as span `name` while tracing
    is on. `stream_time`: a tensor of the block's work; when it lives on a
    CUDA device the span also times the block on that device's current
    stream. Off, it is one shared object that does nothing."""
    if not (_recording or _profiler_enabled()):
        return _NO_SPAN
    stream = (torch.cuda.current_stream(stream_time.device)
              if stream_time is not None and stream_time.is_cuda else None)
    return _Span(name, stream)


def count(name: str, n: float) -> None:
    """Adds `n` to counter `name` while tracing is on."""
    if enabled():
        _R.add(name, n)


def enabled() -> bool:
    """Whether spans and counters record now: for a caller whose count costs
    something to work out."""
    return bool(_recording or _profiler_enabled())


def spans() -> List[Span]:
    """Every span recorded so far, in the order they closed, their stream
    times resolved (this waits for the device to reach their end events)."""
    out = []
    for r in list(_R.done):
        if isinstance(r[6], tuple):
            e0, e1 = r[6]
            e1.synchronize()
            r[6] = float(e0.elapsed_time(e1))
        out.append(Span(*r))
    return out


def counters() -> Dict[str, float]:
    """The counters recorded so far."""
    with _R.lock:
        return dict(_R.counts)


def clear() -> None:
    """Forgets every span and counter recorded so far."""
    _R.clear()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turns tracing on for the block, with or without a profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write `<log_dir>/trace.json` (Chrome trace
    format, for chrome://tracing or Perfetto): the host's ops, the program's
    spans above them, and the card's kernels when a card is present."""
    global _trace_open
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        _trace_open = True
        try:
            yield prof
            true_sync()
        finally:
            _trace_open = False
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def true_sync(x: Optional[torch.Tensor] = None) -> None:
    """Wait for the device work queued so far: on `x`'s card (every card
    when `x` is None); a no-op for CPU tensors, whose work is done on return."""
    if x is not None and x.device.type != "cuda":
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize(None if x is None else x.device)
