"""The GAN cell at tiny sizes on the CPU (`python -m
portbench.tests.tiny_gan`) prints a result line of the contract's shape,
and with each fault planted in the program's step comes out not correct;
its per-layer readers against hand counts; on a card, its control (the
reference in TF32 in the program's place) comes out not correct."""

import json
import subprocess
import sys
import threading
import types

import pytest
import torch

from masg_tpu_torch.utils.profiling import Span
from portbench import harness, program_spans
from portbench.tests import tiny_gan

ENV = {"CUDA_VISIBLE_DEVICES": ""}
MS = 1_000_000
MAIN = threading.main_thread().ident


def _run(*args):
    import os

    p = subprocess.run([sys.executable, "-m", "portbench.tests.tiny_gan", *args],
                       cwd=str(harness.ROOT), env=dict(os.environ, **ENV), capture_output=True,
                       text=True, timeout=240)
    return p.returncode, p.stdout, p.stderr


@pytest.mark.parametrize("fault", [None, *sorted(tiny_gan.FAULTS)])
def test_a_run_prints_the_contracts_line_and_a_fault_is_not_correct(fault):
    rc, out, err = _run(*([fault] if fault else []))
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is (fault is None), line["checks"]
    assert set(line["checks"]) == {"loss_rel", "grad_norm_gap", "change_norm_gap", "sn_u_gap"}
    assert line["attempted"] >= 3 and line["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(harness.benchmark(), tiny_gan.CELL,
                                                  "end_to_end")}
    assert set(line["metrics"]) == want == {"train_frames_per_s", "setup_s"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [x.split(":")[0] for x in tail] == [f"check {k}" for k in line["checks"]]
    assert '"K4": 0' in err  # the generator trains on the plain MRF


@pytest.fixture
def program(monkeypatch):
    fake = types.SimpleNamespace(spans=list, counters=dict)
    monkeypatch.setattr(program_spans, "_profiling", lambda: fake)

    def put(spans=(), counters=None):
        fake.spans = lambda: list(spans)
        fake.counters = lambda: dict(counters or {})
    return put


def test_the_readers_by_hand(program):
    # kernels at 10-20, 30-60 and 80-90 ms of a 0-100 ms window
    rec = harness.Record()
    rec.trace_window = (0, 100 * MS)
    rec.events = [("k", 10 * MS, 10 * MS), ("k", 30 * MS, 30 * MS), ("k", 80 * MS, 10 * MS)]
    rec.window_s, rec.work["useful_flops"] = 0.1, 495e12 * 0.1 * 0.03

    def span(i, name, a, b, parent=None, stream=None):
        return Span(i, name, parent, MAIN, a * MS, b * MS, stream)

    program([span(0, "vocoder_train.generator", 0, 12, stream=4.0),
             span(1, "vocoder_train.disc_update", 12, 40, stream=20.0),
             span(2, "vocoder_train.optimizer", 22, 32, parent=1),  # 22-30 idle
             span(3, "vocoder_train.gen_update", 40, 100, stream=50.0),
             span(4, "vocoder_train.optimizer", 85, 92, parent=3),  # 90-92 idle
             span(5, "data.to_device", 92, 95),  # 92-95 idle
             span(6, "vocoder_train.generator", 95, 110, stream=9.0)])  # past the window
    got = {m: harness.reader(m)(rec) for m in (
        "gan_generator_ms.gan", "gan_disc_update_ms.gan", "gan_gen_update_ms.gan",
        "gan_optimizer_idle_ms.gan", "mfu.gan", "idle_share.gan", "to_device_idle_ms.gan")}
    assert got == {"gan_generator_ms.gan": 4.0, "gan_disc_update_ms.gan": 20.0,
                   "gan_gen_update_ms.gan": 50.0, "gan_optimizer_idle_ms.gan": 10.0,
                   "mfu.gan": pytest.approx(3.0), "idle_share.gan": pytest.approx(50.0),
                   "to_device_idle_ms.gan": 3.0}
    program([])  # a program without these spans: nothing to read
    assert harness.reader("gan_generator_ms.gan")(rec) is None
    assert harness.reader("gan_optimizer_idle_ms.gan")(rec) is None
    assert harness.reader("to_device_idle_ms.gan")(rec) is None


@pytest.mark.cuda
def test_the_control_comes_out_not_correct():
    """At the cell's own sizes: at tiny widths cuDNN's narrow convolutions
    gain too little from TF32 to show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only there)")
    from portbench import control_gan

    cell, config = harness.load_cell(harness.benchmark(), tiny_gan.CELL)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    r = control_gan.readings(cell, config, 12345, "cuda")
    assert any(v > cell["limits"][k] for k, v in r.items()), r
