"""Readings that the limits of ``correct`` are set from, on the card at the
cell's own size: the program's gaps over many seeds (the lower readings),
and the control's and the planted faults' gaps (the upper readings).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 4 [--out readings.jsonl]

The program's readings come from whole runs of the cell (a short window);
the control is the plain reference computed one precision below the
configuration's, in the program's place; a training cell also reads the
fault of a step that averages over half of its batch. Each reading prints
as one JSON line. Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def ints(text):
    return [int(v) for v in text.split(",") if v]


def upper_readings(ctx) -> dict:
    import torch

    from portbench import compare
    from portbench.harness import load_file
    from portbench.reference.precision import full_float32

    kind = ctx.wl["kind"]
    drv = load_file(ctx.folder / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")
    if kind == "train_chunked":
        weights, pool_i, pool_l, first, _ = drv.make_inputs(ctx)
        with full_float32():
            ref = drv.reference_first_steps(ctx, weights, pool_i, pool_l, first)
            ctrl = drv.reference_first_steps(ctx, weights, pool_i, pool_l, first, control=True)
            half = drv.reference_first_steps(ctx, weights, pool_i, pool_l, first,
                                             fault="half_batch")
        return {"control": compare.train_gaps(ctrl, ref),
                "half_batch": compare.train_gaps(half, ref)}
    if kind == "eval_sweep":
        weights, host_i, host_l = drv.make_inputs(ctx)
        picks = drv.schedule(ctx, len(ctx.wl["levels"]))
        return {"control": drv.control_gaps(ctx, weights, host_i, host_l, picks)}
    if kind == "stylize":
        pool = drv.make_pool(ctx)
        g = torch.Generator(device=pool.device).manual_seed(ctx.seed)
        rows = [torch.randperm(ctx.wl["pool"], generator=g, device=pool.device)[:ctx.wl["batch"]]
                for _ in range(ctx.wl["check_batches"])]
        return {"control": {"stylize_gap": drv.control_gap(ctx, pool, rows)}}
    raise ValueError(f"no upper readings for kind {kind!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibration reads the card; no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        def emit(row):
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        for seed in args.seeds:
            t = time.perf_counter()
            r = harness.run_cell(args.workload, seed, args.seconds, False, root=ROOT)
            emit({"workload": args.workload, "seed": seed, "side": "program",
                  "correct": r["correct"], "checks": r["checks"],
                  "metrics": r["metrics"], "seconds": time.perf_counter() - t})
            torch.cuda.empty_cache()
        for seed in args.control_seeds:
            t = time.perf_counter()
            ctx = harness.Run(ROOT, args.workload, seed, args.seconds, False, "cuda", t)
            for side, gaps in upper_readings(ctx).items():
                emit({"workload": args.workload, "seed": seed, "side": side, "gaps": gaps,
                      "seconds": time.perf_counter() - t})
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
