"""Share of the batch's search iterations spent on envs that had already
decided, over the window: 100 x (1 - ``mcts.env_iterations`` / (envs x
``mcts.iterations``)), from the port's planner counters (``plan/mcts.py``:
the iterations each plan's batch ran, and the sum of its envs'
``repeats_done``). A decided env's rows are still computed, and masked."""


def read(rec):
    c = rec.counters
    iterations, done, envs = (c.get(k) for k in ("mcts.iterations", "mcts.env_iterations",
                                                  "mcts.envs"))
    if not iterations or not envs or done is None:
        return None
    return 100.0 * (1.0 - done / (envs * iterations))
