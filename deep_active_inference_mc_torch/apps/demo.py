"""Interactive real-time demo and qualitative eval (PyTorch port).

    python -m deep_active_inference_mc_torch.apps.demo [-n CHECKPOINT_DIR]
        [--method mcts|ai|habit|no|t1|t12] [--headless N | --record GIF |
        --record_ref GIF] [--device cuda|cpu] [...]

Port of ``deep_active_inference_mc_tpu/apps/demo.py``. Six controller
modes, switchable live:
  1 mcts   full planner (array-based MCTS, all G terms)
  2 ai     k-step EFE softmax agent (all G terms)
  3 habit  habitual network
  4 no     manual control (wasd)
  5 t1     reward-only agent (term a)
  6 t12    terms a+b agent
plus keys: q quit, m toggle mean, r reset score, o/p (or [/]) imagination
steps -/+, 8/9 softmax temperature -/+.

Every 1000 steps the score prints and resets; every 100 steps (a round)
the environment re-randomizes keeping its score; plans execute one action
per frame from a queue that flushes on a scoring event; the MCTS mode
overlays a 32x32 visit-density mask of the planned trajectories.

Where the draws come from (``DemoDraws``): the env's randomize draws and
each round's 100 respawns from one generator seeded by ``--seed``; the
action draw of ``habit``/``ai``/``t1``/``t12`` from one uniform of
``np.random.default_rng(t + seed)`` (the draw of the JAX demo's
``rng.choice``); the planner's and the G estimate's noise seeded by
(``seed``, tick). ``--headless N`` runs whole rounds through
``run_round``, which keeps the plan queue on the device and reads its
length once per tick; on the same draws it gives the same score trace as
the host-driven ``tick`` loop. ``-n`` loads a port checkpoint dir (or a
JAX params ``.npz``); without it the agent is a seeded init. The default
device is ``cuda``; ``--device cpu`` runs on the CPU. matplotlib (the
window) and PIL (the recordings) are imported where they are used.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from deep_active_inference_mc_torch.apps import sweep as sweep_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as env_lib
from deep_active_inference_mc_torch.envs import raster
from deep_active_inference_mc_torch.infer import efe
from deep_active_inference_mc_torch.plan import mcts as mcts_lib
from deep_active_inference_mc_torch.utils import compcache
from deep_active_inference_mc_torch.utils.device import resolve_device, seeded_generator

DURATION_OF_EXPERIMENT = 1000
DURATION_OF_ROUND = 100
CONTROLLERS = ("t1", "t12", "ai", "mcts", "habit")
_ENV_STREAM, _PLAN_STREAM = 0, 1


def make_mask(all_paths: List[List[int]], pos_x: int, pos_y: int, jumps: int):
    """Visit-density mask over planned trajectories (the reference demo's
    turtle arithmetic)."""
    mask = np.zeros((32, 32))
    for path in all_paths:
        tx, ty = pos_x, pos_y
        for p_i in path:
            for _ in range(jumps):
                if p_i == 0 and tx < 31:
                    tx += 1
                elif p_i == 1 and tx > 0:
                    tx -= 1
                elif p_i == 2 and ty < 31:
                    ty += 1
                elif p_i == 3 and ty > 0:
                    ty -= 1
                else:
                    continue
                mask[tx, ty] += 1.0
    return mask / mask.max() if mask.max() > 0 else mask


def choose(p: torch.Tensor, u: float) -> torch.Tensor:
    """Index drawn from probabilities ``p`` (A,) by the uniform ``u``:
    what ``np.random.Generator.choice(A, p=p)`` returns for that uniform
    (float64 cumsum over the normalized cdf, right-side search), on
    ``p``'s device and without a host sync."""
    cdf = torch.cumsum(p.to(torch.float64), dim=0)
    cdf = cdf / cdf[-1]
    return torch.searchsorted(cdf, torch.tensor([u], dtype=torch.float64, device=p.device),
                              right=True)[0]


class DemoDraws:
    """The demo's draws. Tests inject their own by overriding the methods."""

    def __init__(self, device, seed: int):
        self.device = torch.device(device)
        self.seed = seed
        self.gen = seeded_generator(self.device, seed, _ENV_STREAM)

    def randomize(self) -> env_lib.EnvDraws:
        """(latents, score, last_r) of a 1-env randomize."""
        return env_lib.draw_randomize(self.gen, 1, self.device)

    def round_respawns(self) -> torch.Tensor:
        """(DURATION_OF_ROUND, 1, 6): the respawn of each tick of a round."""
        return env_lib.sample_latents(self.gen, (DURATION_OF_ROUND, 1), self.device)

    def respawn(self) -> torch.Tensor:
        """(1, 6): the respawn of a step outside a controller's round."""
        return env_lib.sample_latents(self.gen, 1, self.device)

    def uniform(self, t: int) -> float:
        """The action draw of the plan made at tick ``t``."""
        return float(np.random.default_rng(int(t) + self.seed).random())

    def plan_generator(self, t: int) -> torch.Generator:
        """The G estimate's noise of the plan made at tick ``t``."""
        return seeded_generator(self.device, self.seed, _PLAN_STREAM, t)

    def plan_seed_path(self, t: int):
        """The planner's seeds of the plan made at tick ``t``."""
        return (self.seed, _PLAN_STREAM, int(t))


class Demo:
    """Controller + environment state machine, UI-independent."""

    def __init__(self, agent, args, draws: Optional[DemoDraws] = None):
        self.agent = agent
        self.args = args
        self.device = next(agent.parameters()).device
        self.lut = raster.build_sprite_lut(self.device)
        self.draws = draws if draws is not None else DemoDraws(self.device, args.seed)
        self.env = env_lib.EnvState(*self.draws.randomize())
        self.env = self.env.replace(score=torch.zeros((1,), device=self.device))
        self.executing_steps: List[int] = []
        self.t = 0
        self.method = args.method
        self.steps = args.steps
        self.temperature = args.temperature
        self.mean = args.mean
        self.mask = np.zeros((32, 32))
        self.G = np.zeros(4)
        self.terms = [np.zeros(4) for _ in range(3)]
        self.last_info = ""
        self.plans_made = 0
        self._respawns: Optional[torch.Tensor] = None
        self.mcts_params = mcts_lib.MCTSParams(
            C=args.C, threshold=args.threshold, repeats=args.repeats,
            simulation_depth=args.depth, use_habit=not args.no_habit, use_means=True,
            fused_eval=getattr(args, "fused", False),
            using_prior_for_exploration=getattr(args, "prior_explore", False))

    # ------------------------------------------------------------------ UI
    def frame(self) -> np.ndarray:
        o = env_lib.render(self.lut, self.env)[0, 0].cpu().numpy().copy()
        o[59:63, 31] = 1.0  # center marker
        if self.method == "mcts" and self.mask.max() > 0:
            o[16:48, 16:48] = np.clip(o[16:48, 16:48] + self.mask, 0, 1)
        return o

    @property
    def score(self) -> float:
        return float(self.env.score[0])

    @property
    def max_queue(self) -> int:
        jumps = self.args.jumps
        return max(self.mcts_params.max_depth * jumps, self.steps * jumps, self.steps)

    # ------------------------------------------------------------ controllers
    @torch.inference_mode()
    def plan_queue(self, collect_paths: bool = False):
        """The plan of tick ``t`` as a device queue: (queue (max_queue,)
        actions padded with -1, qlen 0-d, planner result or None). The
        one plan function of both the host ``tick`` and ``run_round``."""
        t, jumps, steps = self.t, self.args.jumps, self.steps
        o = env_lib.render(self.lut, self.env)
        idx = torch.arange(self.max_queue, device=self.device)
        self.plans_made += 1
        if self.method == "habit":
            q_pi = self.agent.habitual_net(o)[0]
            pi = choose(q_pi / q_pi.sum(), self.draws.uniform(t))
            self._shown = {"choice": q_pi}
            return torch.where(idx < steps, pi, -1), torch.tensor(steps, device=self.device), None
        if self.method == "mcts":
            res = mcts_lib.active_inference_mcts(
                self.agent, o, self.mcts_params, seed_path=self.draws.plan_seed_path(t),
                collect_paths=collect_paths)
            path, length = res.actions[0], res.lengths[0]
            src = path[torch.clamp(idx // jumps, max=path.shape[0] - 1)]
            return torch.where(idx // jumps < length, src, -1), length * jumps, res
        # ai / t1 / t12: k-step EFE softmax agents. G accumulates over
        # ``steps``: the softmax sees the per-step average.
        G, terms, _ = efe.calculate_G_4_repeated(
            self.agent, o, self.draws.plan_generator(t), steps=steps, calc_mean=self.mean,
            samples=10)
        G, t0, t1 = G[0] / steps, -terms[0][0] / steps, terms[1][0] / steps
        x = {"ai": -G, "t1": -t0, "t12": -(t0 + t1)}[self.method]
        e = torch.exp((x - x.max()) / self.temperature)
        choices = e / e.sum()
        self._shown = {"choice": choices, "G": G, "terms": [t0, t1, terms[2][0] / steps]}
        pi = choose(choices, self.draws.uniform(t))
        n = steps * jumps
        return torch.where(idx < n, pi, -1), torch.tensor(n, device=self.device), None

    def _plan(self):
        if self.method not in CONTROLLERS:  # manual
            self.executing_steps = []
            return
        queue, qlen, res = self.plan_queue(collect_paths=True)
        self.executing_steps = queue[:int(qlen)].tolist()
        if self.method == "habit":
            self.last_info = f"habit Qpi={np.round(self._shown['choice'].cpu().numpy(), 2)}"
        elif self.method == "mcts":
            length = int(res.lengths[0])
            all_paths = []
            for it in range(int(res.repeats_done[0])):
                p_row = res.all_paths[it, 0].cpu().numpy()
                all_paths.append([int(a) for a in p_row[p_row >= 0]])
            self.mask = make_mask(all_paths, int(self.env.latents[0, 5]),
                                  int(self.env.latents[0, 4]), self.args.jumps)
            self.last_info = (f"mcts path={res.actions[0, :length].tolist()} "
                              f"reps={int(res.repeats_done[0])} "
                              f"N={np.round(res.root_N[0].cpu().numpy(), 1)}")
        else:
            self.G = self._shown["G"].cpu().numpy()
            self.terms = [x.cpu().numpy() for x in self._shown["terms"]]
            self.last_info = (f"{self.method} G={np.round(self.G, 2)} "
                              f"softmax={np.round(self._shown['choice'].cpu().numpy(), 2)}")

    def manual_action(self, pi: int):
        self.env, _ = env_lib.step(self.env, torch.tensor([pi], device=self.device),
                                   respawn=self.draws.respawn())

    def _experiment_and_round_boundaries(self):
        """At tick t: every 1000 the score prints and resets; every 100 the
        env re-randomizes keeping its score, and the round's respawns are
        drawn."""
        if self.t % DURATION_OF_EXPERIMENT == 0 and self.t > 0:
            print(f"{self.t} ROUND SCORE: {self.score:.3f}", flush=True)
            self.env = self.env.replace(score=torch.zeros((1,), device=self.device))
        if self.t % DURATION_OF_ROUND == 0:
            score = self.env.score
            self.env = env_lib.EnvState(*self.draws.randomize()).replace(score=score)
            self._respawns = self.draws.round_respawns()
            return True
        return False

    def _respawn(self) -> torch.Tensor:
        if self._respawns is None:
            return self.draws.respawn()
        return self._respawns[self.t % DURATION_OF_ROUND]

    def tick(self):
        """One frame of the main loop, driven from the host."""
        if self.method in CONTROLLERS:
            if self._experiment_and_round_boundaries():
                self.executing_steps = []
            if not self.executing_steps:
                self._plan()
        if self.executing_steps:
            pi = self.executing_steps[0]
            self.env, scored = env_lib.step(self.env, torch.tensor([pi], device=self.device),
                                            respawn=self._respawn())
            if bool(scored[0]):
                self.executing_steps = []  # flush on a scoring event
            else:
                self.executing_steps = self.executing_steps[1:]
        self.t += 1

    @torch.inference_mode()
    def run_round(self) -> torch.Tensor:
        """One round (100 ticks) of a controller with the plan queue on the
        device; the host reads the queue's length once per tick. Starts at
        a round boundary; returns the score after each tick (100,)."""
        if self.t % DURATION_OF_ROUND:
            raise ValueError(f"run_round starts at a round boundary, not at tick {self.t}")
        self._experiment_and_round_boundaries()
        self.executing_steps = []
        queue = torch.full((self.max_queue,), -1, dtype=torch.long, device=self.device)
        qlen = torch.zeros((), dtype=torch.long, device=self.device)
        trace = []
        for _ in range(DURATION_OF_ROUND):
            if int(qlen) == 0:
                queue, qlen, _ = self.plan_queue()
            stepped = qlen > 0
            a = torch.clamp(queue[:1], min=0)
            new, scored = env_lib.step(self.env, a, respawn=self._respawn())
            self.env = env_lib.EnvState(
                torch.where(stepped, new.latents, self.env.latents),
                torch.where(stepped, new.score, self.env.score),
                torch.where(stepped, new.last_r, self.env.last_r))
            flush = stepped & scored[0]
            qlen = torch.where(flush, 0, torch.clamp(qlen - stepped.long(), min=0))
            queue = torch.roll(queue, -1)
            trace.append(self.env.score[0])
            self.t += 1
        return torch.stack(trace)

    # ------------------------------------------------------------- keyboard
    def on_key(self, k: str):
        if k == "m":
            self.mean = not self.mean
            print("Using mean:", self.mean)
        elif k == "s":
            self.manual_action(0)
        elif k == "w":
            self.manual_action(1)
        elif k == "d":
            self.manual_action(2)
        elif k == "a":
            self.manual_action(3)
        elif k == "r":
            self.env = self.env.replace(score=torch.zeros((1,), device=self.device))
            self.t = 0
            print("Restart scoring")
        elif k == "1":
            self.method = "mcts"
            print("Active inference with full-scale planner (all G terms)")
        elif k == "2":
            self.method = "ai"
            print("1-step active inference (all G terms)")
        elif k == "3":
            self.method = "habit"
            print("Habitual mode")
        elif k == "4":
            self.method = "no"
            print("Stopped. You control the agent (wasd)")
        elif k == "5":
            self.method = "t1"
            print("Term a in control (reward-based agent)")
        elif k == "6":
            self.method = "t12"
            print("Terms a+b in control")
        elif k in ("o", "["):
            self.steps = max(1, self.steps - 1)
            print("STEPS", self.steps)
        elif k in ("p", "]"):
            self.steps += 1
            print("STEPS", self.steps)
        elif k == "8":
            self.temperature = max(self.temperature - 5.0, 1.0)
            print("Temperature:", self.temperature)
        elif k == "9":
            self.temperature += 5.0
            print("Temperature:", self.temperature)


def run_interactive(demo: Demo, duration: int):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    state = {"quit": False}

    def on_key(event):
        if event.key == "q":
            state["quit"] = True
        elif event.key:
            demo.on_key(event.key)

    fig.canvas.mpl_connect("key_press_event", on_key)
    im = ax.imshow(demo.frame(), cmap="gray", vmin=0, vmax=1)
    txt = ax.text(2, 70, "", fontsize=8, color="black")
    ax.set_xticks([])
    ax.set_yticks([])
    while demo.t < duration and not state["quit"]:
        demo.tick()
        im.set_data(demo.frame())
        txt.set_text(f"score: {demo.score:.2f}  method: {demo.method}\n{demo.last_info}")
        plt.pause(0.001)
    plt.close(fig)


def run_headless(demo: Demo, duration: int) -> dict:
    """``duration`` frames without a display. Controllers run whole rounds
    through ``run_round`` (rounded up so at least ``duration`` frames run);
    manual mode runs host ticks. Returns the score trace, the plans made,
    the wall time and the frames per second after the first round."""
    if demo.method not in CONTROLLERS:
        t0 = time.time()
        for _ in range(duration):
            demo.tick()
        wall = time.time() - t0
        print(f"headless done: {duration} frames, score {demo.score:.3f}, "
              f"{duration / wall:.1f} fps, method={demo.method}", flush=True)
        return {"trace": None, "plans": 0, "wall": wall, "fps": duration / wall}
    n_rounds = max(1, -(-duration // DURATION_OF_ROUND))
    if n_rounds * DURATION_OF_ROUND != duration:
        print(f"note: running {n_rounds * DURATION_OF_ROUND} frames ({n_rounds} whole "
              f"rounds) for --headless {duration}")
    plans0 = demo.plans_made
    traces, t_first, t0 = [], None, time.time()
    for r in range(n_rounds):
        traces.append(demo.run_round())
        if r == 0:  # the first round pays cuDNN's algorithm search
            t_first = time.time()
    trace = torch.cat(traces).cpu()
    t_end = time.time()
    steady = n_rounds - 1
    fps = steady * DURATION_OF_ROUND / (t_end - t_first) if steady else (
        DURATION_OF_ROUND / (t_first - t0))
    print(f"headless done: {n_rounds * DURATION_OF_ROUND} frames, score {demo.score:.3f}, "
          f"{fps:.1f} fps ({'after the first round' if steady else 'first round'}), "
          f"{demo.plans_made - plans0} plans, method={demo.method}", flush=True)
    return {"trace": trace, "plans": demo.plans_made - plans0, "wall": t_end - t0, "fps": fps}


def run_record(demo: Demo, duration: int, path: str):
    """Record a demo gif: every composited frame of the host-driven loop
    (sprite + reward strip + center marker + the mcts visit mask),
    upscaled to 256x256."""
    from PIL import Image

    t0 = time.time()
    frames = []
    for _ in range(duration):
        demo.tick()
        f = np.clip(demo.frame() * 255.0, 0.0, 255.0).astype(np.uint8)
        frames.append(Image.fromarray(f, mode="L").resize((256, 256), Image.NEAREST))
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=50, loop=0)
    print(f"recorded {duration} frames -> {path} ({time.time() - t0:.1f}s, final score "
          f"{demo.score:.2f}, method={demo.method})", flush=True)


def run_record_ref(demo: Demo, duration: int, path: str):
    """Record a gif in the reference recording's format: 500x500 frames
    with the running score painted in (``viz/scoretext.py``), decodable by
    ``scripts/gif_score.py --gif``; the exact per-frame score trace goes to
    ``<path>.scores.npz``."""
    from PIL import Image

    from deep_active_inference_mc_torch.viz import scoretext

    t0 = time.time()
    frames, trace = [], []
    for _ in range(duration):
        demo.tick()
        trace.append(demo.score)
        f = np.clip(demo.frame() * 255.0, 0.0, 255.0).astype(np.uint8)
        big = np.asarray(Image.fromarray(f, mode="L").resize((500, 500), Image.NEAREST)).copy()
        rate = DURATION_OF_EXPERIMENT * demo.score / float(max(demo.t, 1))
        scoretext.paint_score(big, demo.score, rate)
        frames.append(Image.fromarray(big, mode="L"))
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=50, loop=0)
    np.savez_compressed(path + ".scores.npz", scores=np.asarray(trace))
    print(f"recorded {duration} ref-style frames -> {path} (+{path}.scores.npz, "
          f"{time.time() - t0:.1f}s, final score {demo.score:.2f}, method={demo.method})",
          flush=True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Interactive demo.")
    parser.add_argument("-n", "--network", type=str, default="",
                        help="Port checkpoint dir (figs_*/checkpoints) or params .npz.")
    parser.add_argument("-m", "--mean", action="store_true")
    parser.add_argument("-d", "--duration", type=int, default=50001)
    parser.add_argument("-method", "--method", type=str, default="mcts",
                        choices=["t1", "t12", "ai", "mcts", "habit", "no"])
    parser.add_argument("-steps", "--steps", type=int, default=7)
    parser.add_argument("-temp", "--temperature", type=float, default=1.0)
    parser.add_argument("-jumps", "--jumps", type=int, default=5)
    parser.add_argument("-C", "--C", type=float, default=1.0)
    parser.add_argument("-repeats", "--repeats", type=int, default=300)
    parser.add_argument("-threshold", "--threshold", type=float, default=0.5)
    parser.add_argument("-depth", "--depth", type=int, default=3)
    parser.add_argument("-no_habit", "--no_habit", action="store_true",
                        help="Disable the habit short-circuit (phase A).")
    parser.add_argument("--headless", type=int, default=0,
                        help="Run N frames without a display.")
    parser.add_argument("--record", type=str, default="",
                        help="Record --duration frames to this gif.")
    parser.add_argument("--record_ref", type=str, default="",
                        help="Record --duration frames to this gif in the reference "
                        "recording's format (500x500, score painted in, decodable by "
                        "scripts/gif_score.py --gif) plus <gif>.scores.npz.")
    parser.add_argument("--prior_explore", action="store_true",
                        help="Habit-prior-weighted selection bonus.")
    parser.add_argument("--fused", action="store_true",
                        help="The planner's fused expand+simulate evaluator.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    compcache.enable_persistent_cache()
    agent = sweep_app.build_agent(Config(), args.network, device)
    if args.network:
        print(f"Loaded checkpoint from {args.network}")
    else:
        print("No checkpoint given (-n); using untrained weights.")
    demo = Demo(agent, args)
    if args.record_ref:
        run_record_ref(demo, args.duration, args.record_ref)
    elif args.record:
        run_record(demo, args.duration, args.record)
    elif args.headless:
        return run_headless(demo, args.headless)
    else:
        run_interactive(demo, args.duration)
    return None


if __name__ == "__main__":
    main(sys.argv[1:])
