"""The readers of the program's own spans and counters
(`portbench/program_spans.py` and the metrics built on it) against hand
counts, on hand-made spans, kernels and traced windows; and, on a card,
that the program's spans and the profiler's kernels share one clock:

    python -m pytest -p no:cacheprovider -o addopts="" -s -m cuda portbench/tests
"""

import threading
import types

import pytest
import torch

from masg_tpu_torch.utils.profiling import Span
from portbench import harness, program_spans

MS = 1_000_000  # ns
MAIN = threading.main_thread().ident
OTHER = MAIN + 1
SYNTH = ("wav_host_idle_ms", "vocoder_pad_share", "variance_adaptor_ms", "length_regulator_ms",
         "mel_decoder_ms")
TRAIN = ("forward_idle_ms", "backward_idle_ms", "optimizer_idle_ms", "to_device_idle_ms")
READERS = ([f"{m}.{c}" for m in SYNTH for c in ("synth", "v2")]
           + [f"{m}.train" for m in TRAIN])


def span(i, name, a, b, parent=None, thread=MAIN, stream=None):
    return Span(i, name, parent, thread, a * MS, b * MS, stream)


def record():
    """A window of 0-100 ms whose kernels run at 10-20, 30-60 and 80-90 ms:
    idle 0-10, 20-30, 60-80 and 90-100."""
    rec = harness.Record()
    rec.trace_window = (0, 100 * MS)
    rec.events = [("k", 10 * MS, 10 * MS), ("k", 30 * MS, 30 * MS), ("k", 80 * MS, 10 * MS)]
    return rec


@pytest.fixture
def program(monkeypatch):
    """Puts hand-made spans and counters in the program's place."""
    fake = types.SimpleNamespace(spans=list, counters=dict)
    monkeypatch.setattr(program_spans, "_profiling", lambda: fake)

    def put(spans=(), counters=None):
        fake.spans = lambda: list(spans)
        fake.counters = lambda: dict(counters or {})
    return put


def test_idle_inside_a_span_counts_the_gaps_it_covers(program):
    program([
        span(0, "vocoder.to_int16", 15, 35),  # straddles two kernels' edges: 20-30 idle
        span(1, "vocoder.to_int16", 55, 85),  # 60-80 idle
        span(2, "vocoder.to_int16", 95, 110),  # past the window's end: left out
        span(3, "vocoder.to_int16", 0, 10, thread=OTHER),  # another thread's: left out
        span(4, "other", 0, 100),
    ])
    assert harness.reader("wav_host_idle_ms.synth")(record()) == 30.0
    assert harness.reader("wav_host_idle_ms.v2")(record()) == 30.0


def test_spans_of_one_name_that_overlap_count_once_and_a_child_is_its_own(program):
    program([
        span(1, "train.backward", 12, 28, parent=0),  # a child: 20-28 idle
        span(0, "train.forward", 5, 40),  # 5-10 and 20-30 idle
        span(2, "train.forward", 25, 65),  # overlaps the one above: adds 30 and 60-65
        span(3, "train.optimizer", 50, 60),  # inside a kernel: no idle
        span(4, "data.to_device", 85, 100),  # 90-100 idle
    ])
    rec = record()
    got = {m: harness.reader(f"{m}.train")(rec) for m in TRAIN}
    assert got == {"forward_idle_ms": 20.0, "backward_idle_ms": 8.0, "optimizer_idle_ms": 0.0,
                   "to_device_idle_ms": 10.0}


def test_stream_times_sum_and_the_adaptor_leaves_out_its_regulator(program):
    program([
        span(1, "fs2.length_regulator", 11, 12, parent=0, stream=1.5),
        span(0, "fs2.variance_adaptor", 10, 14, stream=5.0),
        span(2, "fs2.decoder", 14, 30, stream=12.0),
        span(4, "fs2.length_regulator", 41, 42, parent=3, stream=1.0),
        span(3, "fs2.variance_adaptor", 40, 44, stream=4.0),
        span(5, "fs2.decoder", 44, 60, stream=11.5),
        span(6, "fs2.length_regulator", 61, 62, thread=OTHER, stream=9.0),  # left out
        span(7, "fs2.decoder", 90, 120, stream=30.0),  # past the window: left out
    ])
    rec = record()
    for c in ("synth", "v2"):
        assert harness.reader(f"variance_adaptor_ms.{c}")(rec) == 9.0 - 2.5
        assert harness.reader(f"length_regulator_ms.{c}")(rec) == 2.5
        assert harness.reader(f"mel_decoder_ms.{c}")(rec) == 23.5


def test_a_span_without_stream_time_reads_none(program):
    program([span(0, "fs2.decoder", 10, 20)])
    assert harness.reader("mel_decoder_ms.synth")(record()) is None


def test_pad_share_from_the_vocoders_counters(program):
    program(counters={"vocoder.samples": 4000, "vocoder.useful_samples": 1000})
    assert harness.reader("vocoder_pad_share.synth")(record()) == 75.0
    assert harness.reader("vocoder_pad_share.v2")(record()) == 75.0


@pytest.mark.parametrize("metric", READERS)
def test_nothing_recorded_reads_none(program, metric, monkeypatch):
    program()
    assert harness.reader(metric)(record()) is None
    untraced = harness.Record()
    assert harness.reader(metric)(untraced) is None
    # a program without these spans (one older than them)
    monkeypatch.setattr(program_spans, "_profiling", lambda: None)
    assert harness.reader(metric)(record()) is None


def test_the_readers_find_the_programs_own_spans():
    from masg_tpu_torch.utils import profiling

    profiling.clear()
    try:
        with profiling.recording():
            with profiling.span("vocoder.to_int16"):
                pass
            profiling.count("vocoder.samples", 8)
            profiling.count("vocoder.useful_samples", 2)
        (s,) = profiling.spans()
        rec = harness.Record()
        rec.trace_window = (s.start_ns - MS, s.end_ns + MS)
        rec.events = [("k", s.start_ns - MS, MS)]  # idle from the span's start to the end
        assert harness.reader("wav_host_idle_ms.synth")(rec) == (s.end_ns - s.start_ns) / 1e6
        assert harness.reader("vocoder_pad_share.synth")(rec) == 75.0
    finally:
        profiling.clear()


@pytest.mark.cuda
def test_a_span_holds_its_kernel_on_the_profilers_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from masg_tpu_torch.utils import profiling

    x = torch.randn(4096, 4096, device="cuda")
    x @ x
    torch.cuda.synchronize()
    profiling.clear()
    with harness.Tracer(True) as tracer:
        tracer.mark()
        for _ in range(5):
            with profiling.span("clock", stream_time=x):
                y = x @ x
                torch.cuda.synchronize()
    spans = sorted((s for s in profiling.spans() if s.name == "clock"), key=lambda s: s.start_ns)
    profiling.clear()
    gemms = sorted((k for k in tracer.kernels() if "gemm" in k[0].lower()), key=lambda k: k[1])
    assert len(spans) == len(gemms) == 5, [k[0] for k in tracer.kernels()]
    leads, tails = [], []
    for s, (name, k0, d) in zip(spans, gemms):
        leads.append((k0 - s.start_ns) / 1e3)
        tails.append((s.end_ns - k0 - d) / 1e3)
        assert s.start_ns <= k0 and k0 + d <= s.end_ns, (leads, tails)
        assert d / 1e6 <= s.stream_ms <= (s.end_ns - s.start_ns) / 1e6
    print(f"[clock] {torch.cuda.get_device_name(0)}: {name[:48]} {d / 1e3:.1f} us; span start "
          f"to kernel start {min(leads):.1f}-{max(leads):.1f} us, kernel end to span end "
          f"{min(tails):.1f}-{max(tails):.1f} us over 5 spans")
    assert y.shape == x.shape
