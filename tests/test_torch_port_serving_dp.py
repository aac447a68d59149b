"""Data-parallel serving in the port: `ServingEngine(devices=[...])` holds one
replica per device and splits a batch whose size divides into equal row
blocks, one per replica; any other batch runs whole on the first replica
(masg_tpu's replicated B = 1 path). On the CPU with two "cpu" replicas,
against the port's single engine and against masg_tpu's mesh engine over 2
devices, tests/test_serving_mesh.py's cases: a divisible batch, a
non-divisible one, and requests through `DynamicBatcher`. Bars: mel_len
identical, the wav within 2 LSB (the port's serving bar: the int16 cast
truncates f32 sums taken in other orders). Every join has a timeout."""

import math
import threading

import jax
import numpy as np
import pytest
import torch

from masg_tpu_torch.infer.serving import DynamicBatcher, ServingEngine
from masg_tpu_torch.infer.vocoder import Vocoder
from masg_tpu_torch.models.hifigan import HiFiGANGenerator, init_random_weights
from test_serving_mesh import _requests
from torch_port_support import (jax_variables, masg_tpu_engine, masg_tpu_vocoder,
                                port_tiny_config)

BUCKETS, FPP = (16,), 8


@pytest.fixture(scope="module")
def engines():
    """(port single engine, port 2-replica engine, masg_tpu 2-device mesh
    engine), all on the same weights."""
    from masg_tpu.infer.serving import with_duration_bias
    from masg_tpu.models import FastSpeech2 as JaxFastSpeech2
    from masg_tpu.parallel.mesh import make_mesh
    from masg_tpu_torch.compat.from_jax import fs2_state_dict_from_jax
    from test_fastspeech2 import tiny_config

    gen = HiFiGANGenerator(upsample_initial_channel=32)
    init_random_weights(gen, torch.Generator().manual_seed(1))
    cfg_j = tiny_config()
    model = JaxFastSpeech2.from_config(cfg_j)
    L = BUCKETS[0]
    variables = jax_variables(model, {"params": 0}, np.zeros(1, np.int32),
                              np.ones((1, L), np.int32), np.asarray([L], np.int32), 64,
                              accents=np.zeros((1, L), np.int32),
                              speaker_meta=np.zeros(
                                  (1, cfg_j.preprocess.speaker_generation.one_hot_dim)))
    variables = with_duration_bias(variables, math.log(5.0))
    mesh = make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    jdp = masg_tpu_engine(cfg_j, variables=variables, vocoder=masg_tpu_vocoder(gen),
                          text_buckets=BUCKETS, frames_per_phone=FPP, mesh=mesh)

    cfg = port_tiny_config()
    sd = fs2_state_dict_from_jax(variables["params"], variables["batch_stats"], cfg)

    def port(**kw):
        return ServingEngine(cfg, state_dict=sd, vocoder=Vocoder(gen), text_buckets=BUCKETS,
                             frames_per_phone=FPP, **kw)

    return port(device="cpu"), port(devices=["cpu", "cpu"]), jdp


def lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def assert_same(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["mel_len"] == w["mel_len"], (what, i)
        assert lsb(g["wav"], w["wav"]) <= 2, (what, i, lsb(g["wav"], w["wav"]))


def _replicas_run(engine, fn):
    """(fn's result, the replica indices the engine dispatched to)."""
    seen = []
    inner = engine._run_on

    def record(i, *args, **kw):
        seen.append(i)
        return inner(i, *args, **kw)

    engine._run_on = record
    try:
        return fn(), seen
    finally:
        del engine._run_on


def test_divisible_batch_splits_over_the_replicas(engines):
    single, dp, jdp = engines
    reqs = _requests(8)
    got, seen = _replicas_run(dp, lambda: dp.synthesize_many(reqs, batch_buckets=(8,)))
    assert seen == [0, 1]
    assert any(r["mel_len"] > 0 for r in got)
    assert_same(got, single.synthesize_many(reqs, batch_buckets=(8,)), "vs single engine")
    assert_same(got, jdp.synthesize_many(reqs, batch_buckets=(8,)), "vs masg_tpu mesh")


def test_non_divisible_batch_runs_whole(engines):
    """B = 1 and B = 3 (2 divides neither) run whole on the first replica."""
    single, dp, jdp = engines
    ids = list(range(5, 14))
    r1, seen = _replicas_run(dp, lambda: dp.synthesize(ids, duration_control=1.1))
    assert seen == [0] and r1["mel_len"] > 0
    assert_same([r1], [single.synthesize(ids, duration_control=1.1)], "B = 1 vs single")
    assert_same([r1], [jdp.synthesize(ids, duration_control=1.1)], "B = 1 vs masg_tpu mesh")
    reqs = _requests(3, seed=2)
    r3, seen = _replicas_run(dp, lambda: dp.synthesize_many(reqs, batch_buckets=(3,)))
    assert seen == [0]
    assert_same(r3, single.synthesize_many(reqs, batch_buckets=(3,)), "B = 3 vs single")


def test_dynamic_batcher_over_replicas(engines):
    """The batcher runs unchanged above the 2-replica engine: concurrent
    requests fuse into a dispatch that splits over both."""
    single, dp, _ = engines
    batcher = DynamicBatcher(dp, max_batch=8, window_ms=30.0)
    reqs = _requests(8, seed=1)
    results = [None] * len(reqs)

    def worker(i):
        r = dict(reqs[i])
        results[i] = batcher.synthesize(r.pop("ids"), **r)

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert dp.n_batches < len(reqs)  # fused
    for got, req in zip(results, reqs):
        r = dict(req)
        want = single.synthesize(r.pop("ids"), **r)
        assert got["mel_len"] == want["mel_len"]
        assert lsb(got["wav"], want["wav"]) <= 2
