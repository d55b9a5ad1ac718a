"""Share of the rows that the planner's searches computed for envs that had
already decided: 100 x (1 - ``mcts.env_iterations`` /
``mcts.row_iterations``), from the port's counter registry
(``utils/profiling.py`` ``counters()``; ``plan/mcts.py``: the rows of every
iteration, its bucket's size, summed on the host, and the envs'
``repeats_done`` summed on the device) over every plan of the process: the
warm-up plan, the window's and the check's three re-plans, all of them
plans of the cell's traffic. A program that counts no rows reads nothing."""

from deep_active_inference_mc_torch.utils import profiling


def read(rec, counters=None):
    """``counters``: the port's registry's (by default the running process's)."""
    counters = getattr(profiling, "counters", dict)() if counters is None else counters
    rows, searched = counters.get("mcts.row_iterations"), counters.get("mcts.env_iterations")
    if not rows or searched is None:
        return None
    return 100.0 * (1.0 - searched / rows)
