"""The one traffic generator: everything a cell sends is drawn here from
`--seed` and the parameters of the cell's `traffic` group, so a new mix is a
new data file.

Every seed sends the same set of sizes (and an open loop the same set of
gaps between arrivals) in another order, with other contents: the sizes are
stratified draws from the cell's laws, and the seed permutes them. So the
work of a run does not move with the seed, only its order and its values.

Parameters read (from a cell's `traffic` group):
- `phones`: the law of an utterance's length in phones, `{"median", "sigma",
  "min", "max"}` (log-normal, rounded, clipped);
- `batch_size`, `text_bucket` (a batch's texts pad to a multiple of it),
  `pool_batches` (offline batches made, sent in turn);
- `speaker_sources`: `table` (rows of the speaker table, uniform) and
  `prior` (embeddings drawn from the prior at `prior_metas`, each
  `prior_per_meta` times), taken in turn batch by batch;
- `frames_per_phone`, `log_duration_sigma`, `corpus_size`, `group_size`: a
  training corpus (durations log-normal per phone, at least 1 frame, at
  most the model's `max_seq_len` frames in all);
- `rate_per_s`: the open loop's mean arrival rate (exponential gaps).
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List

import numpy as np

NO_ACCENT_ID = 4


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream])


def stratified_normal(n: int) -> np.ndarray:
    """The n quantiles (i + 1/2) / n of N(0, 1), ascending."""
    nd = NormalDist()
    return np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])


def phone_counts(law: dict, n: int) -> np.ndarray:
    """n lengths in phones, the same multiset for every seed (ascending)."""
    x = np.exp(np.log(law["median"]) + law["sigma"] * stratified_normal(n))
    return np.clip(np.round(x), law["min"], law["max"]).astype(np.int64)


def utterance(g: np.random.Generator, n: int, n_symbols, ja: bool):
    """(phone ids, accent ids) of one utterance of n phones, ids drawn from
    1 .. n_symbols - 1 (or from the array `n_symbols`). Japanese rows carry
    accent ids 0-3 (0 shares the pad's row, as in the recipe), English rows
    the no-accent id."""
    ids = (g.choice(n_symbols, n) if isinstance(n_symbols, np.ndarray)
           else g.integers(1, n_symbols, n))
    acc = g.integers(0, NO_ACCENT_ID, n) if ja else np.full(n, NO_ACCENT_ID)
    return ids, acc


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_rows(rows: List[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def synth_batches(seed: int, t: dict, n_symbols: int, languages: np.ndarray,
                  n_prior: int) -> List[Dict[str, np.ndarray]]:
    """`pool_batches` offline batches: texts padded to the text bucket,
    speaker sources in turn. `who` names a table batch's speakers, or the
    rows of the prior pool (`n_prior` embeddings) a prior batch takes."""
    g = rng(seed, 1)
    b, sources, nb = t["batch_size"], t["speaker_sources"], t["pool_batches"]
    # row s of every batch comes from stratum s of the law (each batch spans
    # the law, so batches carry alike amounts of work), in an order drawn
    # from the seed; the rows of a batch are then shuffled
    strata = phone_counts(t["phones"], nb * b).reshape(b, nb)
    lengths = np.stack([g.permutation(s) for s in strata], axis=1)  # (nb, b)
    out = []
    for i in range(nb):
        source = sources[i % len(sources)]
        n = g.permutation(lengths[i])
        if source == "table":
            who = g.integers(0, len(languages), b)
            ja = languages[who] == 0
        else:
            who = g.integers(0, n_prior, b)
            ja = g.random(b) < 0.5
        utt = [utterance(g, int(k), n_symbols, bool(j)) for k, j in zip(n, ja)]
        width = round_up(int(n.max()), t["text_bucket"])
        out.append({"source": source, "who": who, "src_lens": n,
                    "texts": pad_rows([u[0] for u in utt], width),
                    "accents": pad_rows([u[1] for u in utt], width)})
    return out


def prior_rows(t: dict) -> np.ndarray:
    """The metadata rows the prior pool is drawn at."""
    return np.repeat(np.asarray(t["prior_metas"], np.float64), t["prior_per_meta"], axis=0)


def corpus_sizes(t: dict, max_frames: int) -> List[np.ndarray]:
    """Frames per phone of each utterance of a training corpus: the same
    corpus for every seed (the seed orders it and fills it)."""
    n = phone_counts(t["phones"], t["corpus_size"])
    g = rng(0, 2)
    n = g.permutation(n)
    s = t["log_duration_sigma"]
    mu = np.log(1 + t["frames_per_phone"]) - s * s / 2
    out = []
    for k in n:
        d = np.maximum(np.round(np.exp(g.normal(mu, s, int(k))) - 1), 1).astype(np.int64)
        while d.sum() > max_frames:  # trim the longest phones
            i = int(np.argmax(d))
            d[i] -= min(int(d.sum()) - max_frames, int(d[i]) - 1)
        out.append(d)
    return out


def requests(seed: int, t: dict, n: int, alphabet: np.ndarray, languages: np.ndarray):
    """n requests of one utterance each: (phone ids, accent ids or None,
    speaker id), the speaker uniform over the table; lengths are the law's
    stratified draws in an order drawn from the seed."""
    g = rng(seed, 6)
    lengths = g.permutation(phone_counts(t["phones"], n))
    out = []
    for k in lengths:
        spk = int(g.integers(0, len(languages)))
        ja = bool(languages[spk] == 0)
        ids, acc = utterance(g, int(k), alphabet, ja)
        out.append((ids, acc if ja else None, spk))
    return out


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Arrival times (s) in [0, seconds) at mean rate `rate`: the gaps are the
    exponential law's stratified quantiles, in an order drawn from the seed."""
    n = int(round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = rng(seed, 3).permutation(-np.log1p(-q) / rate)
    t = np.cumsum(gaps) - gaps[0]
    return t[t < seconds]
