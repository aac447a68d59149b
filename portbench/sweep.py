"""A sweep of an open-loop cell's arrival rate, run once to find the knee
(the highest rate with no failures and no backlog growing over the window)
from which the cell's fixed rate is set. Benchmark runs never run it.

    python3 -m portbench.sweep --workload v1_serve_poisson --seed 7 --seconds 20 \
        --rates 20 30 40 50

One process: the server comes up once and takes one window per rate.
Prints a JSON line per rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, traffic
    from portbench.drivers import serve

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cell, config = harness.load_cell(bench, args.workload)
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32"])
    cell["traffic"]["rate_per_s"] = max(args.rates)
    ctx = harness.Context(cell=cell, config=config, seed=args.seed, seconds=args.seconds,
                          trace=False, device="cuda", started=time.perf_counter())
    server, reqs, _, _, _, _ = serve.setup(ctx)
    from masg_tpu_torch.text import ACCENT_TO_ID
    from masg_tpu_torch.text.symbols import symbols

    chars = "".join(sorted(ACCENT_TO_ID, key=ACCENT_TO_ID.get))
    bodies = [serve.request_body(ids, acc, spk, symbols, chars) for ids, acc, spk in reqs]
    server.counting = True
    try:
        for rate in args.rates:
            times = traffic.arrivals(args.seed, rate, args.seconds)
            n0 = dict(ctx.rec.counters)
            slots = serve.open_loop(server.port, bodies[:len(times)], times, 60.0)
            lat = serve.latencies_ms(slots)
            q = len(lat) // 4
            d = {k: ctx.rec.counters.get(k, 0) - n0.get(k, 0) for k in ("dispatches", "dispatch_rows")}
            print(json.dumps({
                "rate_per_s": rate, "sent": len(slots),
                "failed": int(sum(s.get("status") != 200 for s in slots)),
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                "p99_ms": float(np.percentile(lat, 99)),
                "first_quarter_p50_ms": float(np.median(lat[:q])),
                "last_quarter_p50_ms": float(np.median(lat[-q:])),
                "rows_per_dispatch": d["dispatch_rows"] / max(d["dispatches"], 1)}), flush=True)
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
