"""The control of the GAN cell's comparison: the plain reference, computed
in TF32 (the nearest precision below the configuration's float32 with TF32
off), put in the program's place and judged by the same four numbers as a
run. It has to come out as not correct. Benchmark runs never run it; it
gives the upper readings from which the cell's limits are set.

    python3 -m portbench.control_gan --seeds 1 2 3

For each seed: the run's set-up (the corpus, the program's train state and
its warm-up steps), the state captured as at the window's opening, the next
`checked_steps` batches of the stream; then the reference in TF32 and in
float32 from that state over those batches, compared as a run compares the
program's readings with the reference's. Needs a CUDA device (TF32 exists
only there).
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from portbench import harness
from portbench.drivers import gan

CELL = "v1_train_vocoder_gan"


def readings(cell: dict, config: dict, seed: int, device: str,
             where: Optional[dict] = None) -> Dict[str, float]:
    ctx = harness.Context(cell=cell, config=config, seed=seed, seconds=0.0, trace=False,
                          device=device, started=time.perf_counter())
    root = tempfile.mkdtemp(prefix="portbench_gan_")
    try:
        s = gan.prepare(ctx, root)
        opening = gan.capture(s.state)
        ys = [torch.from_numpy(next(s.batches)).to(device)
              for _ in range(cell["traffic"]["checked_steps"])]
        spe = s.steps_per_epoch
        del s
        gc.collect()
        torch.cuda.empty_cache()
        prog = gan.reference_readings(config, opening, ys, spe, device, allow_tf32=True)
        ref = gan.reference_readings(config, opening, ys, spe, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {c.name: c.value for c in gan.compare(prog, ref, cell["limits"], where)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell, config = harness.load_cell(harness.benchmark(), CELL)
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32"])
    rows: List[dict] = []
    for s in args.seeds:
        where: dict = {}
        r = readings(cell, config, s, "cuda", where)
        rows.append(r)
        print(json.dumps({"workload": CELL, "seed": s, "control": r, "where": where}), flush=True)
    worst = {k: min(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"workload": CELL, "smallest_control_reading": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
