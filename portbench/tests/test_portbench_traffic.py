"""The traffic generator repeats from the seed, and every seed sends the
same sizes in another order."""

import numpy as np

from portbench import harness, traffic

BENCH = harness.benchmark()


def _mix(cell):
    return harness.load_cell(BENCH, cell)[0]["traffic"]


def test_offline_batches_repeat_and_keep_their_sizes():
    t = _mix("v1_synth_b16")
    langs = np.arange(209) >= 100
    a = traffic.synth_batches(5, t, 429, langs.astype(int), 64)
    b = traffic.synth_batches(5, t, 429, langs.astype(int), 64)
    c = traffic.synth_batches(2**31 + 7, t, 429, langs.astype(int), 64)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in ("texts", "accents", "who", "src_lens"))
    sizes = lambda bs: sorted(int(n) for x in bs for n in x["src_lens"])
    assert sizes(a) == sizes(c)
    assert any(not np.array_equal(x["texts"], y["texts"]) for x, y in zip(a, c))
    # every batch spans the law: its total is within a few percent of the mean
    totals = np.array([x["src_lens"].sum() for x in a])
    assert totals.std() / totals.mean() < 0.05


def test_corpus_sizes_are_the_same_for_every_seed():
    t = _mix("v1_train_fs2_b16")
    a, b = traffic.corpus_sizes(t, 1000), traffic.corpus_sizes(t, 1000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(d.sum() <= 1000 and d.min() >= 1 for d in a)
    mean = np.mean([d.mean() for d in a])
    assert abs(mean - t["frames_per_phone"]) / t["frames_per_phone"] < 0.05


def test_arrivals_and_requests_repeat_with_the_same_gaps():
    t = _mix("v1_serve_poisson")
    a, b = traffic.arrivals(9, 24.0, 30.0), traffic.arrivals(9, 24.0, 30.0)
    c = traffic.arrivals(2**31 + 11, 24.0, 30.0)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # one multiset of gaps, in another order: the same count and span
    assert len(a) == len(c) == 720 and abs(a[-1] - c[-1]) < 1.0
    alphabet = np.arange(1, 100)
    r1 = traffic.requests(9, t, 50, alphabet, np.zeros(209, int))
    r2 = traffic.requests(9, t, 50, alphabet, np.zeros(209, int))
    assert all(np.array_equal(x[0], y[0]) and x[2] == y[2] for x, y in zip(r1, r2))
