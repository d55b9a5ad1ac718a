"""The readings that set each check's limits: sound runs of the program,
its bf16 control and planted faults, many seeds in one process.

    python -m portbench.control --workload <cell> --seconds <s> \
        --seeds 1,2,3 --mode program|bfloat16|fault:<name>[,...]

Prints one JSON line per run: the mode, the seed and the checks. The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="program")
    args = p.parse_args(argv)
    from portbench import faults, run
    run._pin_caches()
    for mode in args.mode.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            dtype = "bfloat16" if mode == "bfloat16" else None
            cm = (faults.FAULTS[mode.split(":", 1)[1]]() if mode.startswith("fault:")
                  else contextlib.nullcontext())
            t0 = time.perf_counter()
            try:
                with cm:
                    r = run.run_cell(args.workload, seed, args.seconds, False, dtype=dtype,
                                     t_start=t0)
                out = {"mode": mode, "seed": seed, "correct": r["correct"],
                       "checks": {k: v["value"] for k, v in r["checks"].items()},
                       "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
            except Exception as e:  # a control that crashes has failed: record it
                out = {"mode": mode, "seed": seed, "error": repr(e)[:300]}
            out["wall_s"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
