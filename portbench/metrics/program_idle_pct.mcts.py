"""``program_idle_pct.sweep``'s reading in the planner's cell: the share of
the traced stretch in which the card was idle while the host was inside one
of the port's spans (there ``sweep.*``, ``graphs.*`` and ``mcts.plan``)."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("program_idle_pct.sweep.py")))["read"]
