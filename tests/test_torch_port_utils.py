"""The port's utils: `utils/mcd.py` against masg_tpu's on
tests/test_mcd.py's four cases (the same numpy arithmetic, so exactly), and
`utils/profiling` on the CPU (a Chrome trace written; its spans and
counters are in test_torch_port_tracing.py)."""

import json
import os

import numpy as np
import pytest
import torch

from masg_tpu.utils import mcd as jmcd
from masg_tpu_torch.utils import mcd as tmcd
from masg_tpu_torch.utils.profiling import trace, true_sync
import torch_port_support  # noqa: F401  (the port tests' thread count)


def _identical(m):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(50, 80))
    return [m.mcd(a, a), m.mcd(a, a, align="dtw")]


def _distortion(m):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(60, 80))
    return [m.mcd(a, a + 0.05 * rng.normal(size=a.shape)),
            m.mcd(a, a + 0.5 * rng.normal(size=a.shape))]


def _time_stretch(m):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(40, 80))
    s = np.repeat(a, 2, axis=0)
    return [m.mcd(a, s, align="dtw"), m.mcd(a, s, align="truncate")]


def _mcep(m):
    return m.mel_to_mcep(np.random.default_rng(3).normal(size=(7, 80)), n_mfc=13)


@pytest.mark.parametrize("case", [_identical, _distortion, _time_stretch, _mcep],
                         ids=["identical", "distortion", "time_stretch", "mcep"])
def test_mcd_matches_masg_tpu(case):
    got, want = case(tmcd), case(jmcd)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path)):
        y = x @ x
        true_sync(y)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert os.path.getsize(tmp_path / "trace.json") > 0

