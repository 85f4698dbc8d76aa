"""The readings a cell's limits are set from (PERF.md, "correct"):

  program   sound runs of the program over many seeds, each a whole run
            of the cell with a short window: the lower readings;
  control   the reference in the nearest precision below the one the
            configuration states (float8 operands for a bfloat16
            configuration: e4m3 forward, e5m2 gradients), put in the
            program's place and judged against the float32 reference:
            the upper readings;
  half      the fault "half of the batch left out, the mean taken over
            the rest", planted in the reference put in the program's
            place.

and, for the look behind a number that sound runs read high:

  f32       the program computing in float32 instead of the
            configuration's precision;
  bf16      a bfloat16 twin of the reference (its arithmetic rounded to
            the configuration's precision) in the program's place.

    python3 benchmark/control.py --workload <cell> --program-seeds 1,2,3 \
        --control-seeds 4,5,6 [--f32-seeds 1,2] [--bf16-seeds 1,2] \
        [--seconds 2] [--out <file.json>]

Runs on the card the cell asks for; one process reads every seed, so the
set-up is paid once. Prints one JSON line per reading, and writes them
all to --out.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (str(HERE.parent), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import run as bench  # noqa: E402
from reference import net as refnet  # noqa: E402
from yardstick import checks, device, manifest  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def control_training(ctx, rows=None, quant=None):
    """The reference with `quant` (or over the first `rows` rows) in the
    program's place, judged against the float32 reference."""
    train = manifest.traffic("train")
    p = ctx.wl["params"]
    pool = train.make_pool(ctx, p["batch"], 1 + p["steps_per_dispatch"])
    truth = train.reference_steps(ctx, pool)
    other = train.reference_steps(ctx, pool, quant=quant, rows=rows)
    numbers, notes = checks.training_numbers(other, truth)
    return dict(numbers, notes=notes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--f32-seeds", default="")
    ap.add_argument("--bf16-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench.cache_dirs()
    wl = manifest.workload(args.workload)
    cfg = manifest.config(wl["config"])
    torch = device.require_cards(wl["chips"])
    dev = torch.device("cuda", 0)
    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)

    f32 = dict(cfg, program=dict(cfg["program"], compute_dtype=None))
    runs = [("program", cfg, args.program_seeds),
            ("f32", f32, args.f32_seeds)]
    for reading, c, seeds in runs:
        for seed in _seeds(seeds):
            t0 = time.perf_counter()
            res = bench.run_cell(wl, c, seed, args.seconds, 0, dev, t0)
            emit({"reading": reading, "seed": seed,
                  "numbers": res["numbers"], "correct": res["correct"],
                  "failed": res["failed"], "setup_s": res["setup_s"],
                  "end_to_end": res["end_to_end"], "notes": res["notes"]})
            del res
            gc.collect()
            torch.cuda.empty_cache()
    half = wl["params"]["batch"] // 2
    planted = {"control": [("control", dict(quant=refnet.fp8)),
                           ("half", dict(rows=half))],
               "bf16": [("bf16", dict(quant=refnet.bf16))]}
    for kind, seeds in (("control", args.control_seeds),
                        ("bf16", args.bf16_seeds)):
        for seed in _seeds(seeds):
            ctx = bench.context(wl, cfg, seed, 0, 0, dev,
                                time.perf_counter())
            for reading, kw in planted[kind]:
                emit({"reading": reading, "seed": seed,
                      "numbers": control_training(ctx, **kw)})
            gc.collect()
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
