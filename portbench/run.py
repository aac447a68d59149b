"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as the
cell asks for. Prints the result as the last line of standard output, and
each number compared against its limit as the last lines of standard error.
Exits non-zero, printing no result, without the devices, when the program
under test cannot be imported, or when JAX or the package the port was made
from is loaded once the window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

THREADS = 2  # CPU threads of torch's and OpenMP's pools in a run

def run_cell(name: str, cell: dict, config: dict, seed: int, seconds: float, trace: bool,
             device: str, bench: dict, started: float) -> dict:
    """Drives one run of `cell` and returns its result line; raises if a
    forbidden module is loaded once the window has closed."""
    import torch

    from portbench import harness

    # the precision the configuration states, before anything is built
    torch.backends.cuda.matmul.allow_tf32 = bool(config["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["allow_tf32"])
    ctx = harness.Context(cell=cell, config=config, seed=seed, seconds=seconds, trace=trace,
                          device=device, started=started)
    ctx.rec.dtype = config["dtype"]
    out = harness.driver(cell["driver"]).run(ctx)
    found = harness.forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the run's process: {', '.join(found)}")
    line = harness.result_line(ctx, out, bench, name)
    print(f"run: setup {ctx.setup_s:.3f} s, window {ctx.rec.window_s:.3f} s, "
          f"{json.dumps(ctx.rec.counters)}", file=sys.stderr)
    harness.print_checks(out)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # few host threads: the host's cores are shared, and idle pool threads
    # that spin take them from the threads that launch the device's work
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
    from portbench import harness

    bench = harness.benchmark()
    cell, config = harness.load_cell(bench, args.workload)
    import torch

    torch.set_num_threads(THREADS)

    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import masg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is not importable: {e}", file=sys.stderr)
        return 2
    try:
        line = run_cell(args.workload, cell, config, args.seed, args.seconds,
                        bool(args.trace), "cuda", bench, STARTED)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 3
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
