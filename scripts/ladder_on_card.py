#!/usr/bin/env python3
"""Ladder rows of ``chip_smoke.py`` on one CUDA card, without its other phases.

    python3 scripts/ladder_on_card.py distilled_mcts,distilled_mcts_bucketed
    python3 scripts/ladder_on_card.py mcts_c2_bucketed+queue

Builds K1, then drives each named row of ``chip_smoke.py``'s
``FULL_LADDER`` (the flagship, ``artifacts/run512/checkpoints``, against
``artifacts/run512/eval_log_round5.txt``) or ``DISTILLED_LADDER`` (the
distilled agent, ``artifacts/run512/checkpoints_distilled``, against
``eval_log_round4.txt``) through the sweep CLI at the committed protocol
(seed 0, 200 macro steps, 5 jumps), with ``chip_smoke.py --ladder``'s code
and 4-sigma gate. Each row takes minutes to tens of minutes, so a row that
does not fit beside every phase of ``chip_smoke.py`` in one call runs
here. Exits non-zero when a row fails its gate.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("rows", help="Comma-separated rows of "
                        + ", ".join([*cs.FULL_LADDER, *cs.DISTILLED_LADDER]))
    tags = parser.parse_args().rows.split(",")
    unknown = sorted(set(tags) - set(cs.FULL_LADDER) - set(cs.DISTILLED_LADDER))
    if unknown:
        cs.fail(f"no such rows {unknown}")
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from deep_active_inference_mc_torch.ops.cuda import KERNELS, build

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    build.build(KERNELS)
    runs, keep = {}, {}
    for network, ladder, log, name in (
            (cs.FLAGSHIP, cs.FULL_LADDER, cs.LADDER_LOG, "flagship"),
            (cs.DISTILLED, cs.DISTILLED_LADDER, cs.LADDER_LOG_R4, "distilled")):
        rows = {tag: ladder[tag] for tag in tags if tag in ladder}
        if rows:
            runs.update(cs.ladder_rows(torch, smi, network, rows, cs.committed_ladder(log), name,
                                       keep))
    print(f"[done] {len(runs)} rows in {time.perf_counter() - t0:.1f} s; K1 launches {runs}",
          flush=True)


if __name__ == "__main__":
    main()
