"""PyTorch port: the planner's spans and counters (``plan/mcts.py``,
``utils/profiling.py``).

On the CPU: each search of an ``mcts`` sweep is a span ``mcts.plan`` under
``sweep.run``, and the planner's counters equal the sums of its plans'
``MCTSResult``s; the counter registry's host and device counts. The test
marked ``cuda`` holds ``mcts.device``, the search step timed by CUDA events
inside the planner's graph, against the synced plans' own iterations. The
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mcts_spans.py
"""

import time

import pytest
import torch

from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.plan import mcts as tmcts
from deep_active_inference_mc_torch.train import sweep as tsweep
from deep_active_inference_mc_torch.utils import profiling
from deep_active_inference_mc_torch.utils.device import seeded_generator

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def registry():
    profiling.reset()
    yield
    profiling.reset()


def by_name(name):
    return [s for s in profiling.spans() if s.name == name]


def _sweep(device, envs, repeats, threshold=0.5):
    cfg = Config()
    lut = traster.build_sprite_lut(device)
    agent = ActiveInferenceAgent().to(device)
    agent.init(seeded_generator(device, 0))
    g = seeded_generator(device, 1)
    env = tenv.randomize(tenv.reset(g, envs, device), g)
    p = tmcts.MCTSParams(repeats=repeats, simulation_depth=2, use_habit=True,
                         threshold=threshold, max_depth=16)
    run = tsweep.make_sweep(agent, cfg, lut, method="mcts", n_macro_steps=1, mcts_params=p,
                            zero_score=False)
    return run, env


def test_sweep_plans_are_spans_and_counted():
    """Two macro steps of 4 envs, 6 repeats, the threshold low enough that
    phase A acts for some envs: one ``mcts.plan`` a step, under
    ``sweep.run``; the counters are the plans' sums."""
    run, env = _sweep(CPU, 4, 6, threshold=0.09)
    iterations = env_iterations = short = 0
    for k in range(2):
        env = run(seeded_generator(CPU, 10 + k), env)["env"]
        res = run.planner.last
        env_iterations += int(res.repeats_done.sum())
        short += int((res.repeats_done == 0).sum())
        # The done flag is read one iteration late: the batch runs one more
        # iteration than its last env, within the budget.
        iterations += min(int(res.repeats_done.max()) + 1, 6)
    plans = by_name("mcts.plan")
    assert len(plans) == 2 and {s.parent for s in plans} == {"sweep.run"}
    assert all(s.thread is not None for s in plans)
    assert profiling.counters() == {"mcts.iterations": iterations,
                                    "mcts.env_iterations": env_iterations,
                                    "mcts.short_circuits": short}
    assert 0 < short < 8
    assert not by_name("mcts.device")  # timed only inside a graph


def test_counters_add_host_numbers_and_device_sums():
    profiling.count("a", 2)
    profiling.count("a", 3)
    profiling.count("b", torch.tensor([True, False, True]))
    profiling.count("b", torch.tensor([1, 2]))
    profiling.count("c", torch.tensor([0.5, 0.25]))
    assert profiling.counters() == {"a": 5, "b": 5, "c": 0.75}
    profiling.reset()
    assert profiling.counters() == {}


def test_settle_keeps_a_pending_device_span_once_its_end_is_done():
    class Event:
        def __init__(self, done, ms=0.0):
            self.done, self.ms = done, ms

        def query(self):
            return self.done

        def elapsed_time(self, end):
            return end.ms

    running = (Event(True), Event(False))
    profiling.record_device_events("x.device", *running)
    profiling.settle()
    assert not by_name("x.device")  # still running: stays pending
    running[1].done, running[1].ms = True, 2.5
    profiling.settle()
    profiling.settle()
    (s,) = by_name("x.device")
    assert s.end_ns - s.start_ns == 2_500_000 and s.thread is None


# ------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_mcts_spans.py` on one")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_planner_times_its_search_step(cuda_device):
    """64 envs, 40 repeats, through the sweep: one ``mcts.device`` a plan,
    settled at the sweep's read-back, within the synced plan's mean time
    per iteration (the card runs the replays back to back)."""
    run, env = _sweep(cuda_device, 64, 40)
    env = run(seeded_generator(cuda_device, 9), env)["env"]  # the capture
    profiling.reset()
    walls = []
    for k in range(3):
        torch.cuda.synchronize()
        before = profiling.counters().get("mcts.iterations", 0)
        t0 = time.perf_counter()
        env = run(seeded_generator(cuda_device, 10 + k), env)["env"]  # syncs
        iters = profiling.counters()["mcts.iterations"] - before
        walls.append((time.perf_counter() - t0) / iters)
    samples = [1e-9 * (s.end_ns - s.start_ns) for s in by_name("mcts.device")]
    assert len(samples) == 3
    for dev_s, wall_s in zip(samples, walls):
        assert 0.2 * wall_s < dev_s < 1.1 * wall_s, (dev_s, wall_s)
    (plan,) = {s.parent for s in by_name("mcts.plan")}
    assert plan == "sweep.run"
