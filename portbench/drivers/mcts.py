"""The MCTS sweep: ``train/sweep.py`` ``make_sweep(method="mcts")``, one
macro step at a time.

The traffic: episodes of ``episode`` macro steps over ``envs`` envs from
seeded starts (``yardstick/traffic.py``), one macro step per unit of work,
as ``run_sweep`` runs them: each macro step renders every env (K1), plans
for the whole batch with the sweep's planner (``plan/mcts.py``
``make_jit_planner`` at the configuration's ``planner`` knobs, one graph
replay per search iteration), takes the first action of each env's trimmed
visit-max path and runs it ``jumps`` times. A new plan every macro step.
The noise of each macro step (the respawns, the root's, the phase-A draw's,
each search iteration's: ``yardstick/search.py``) is the benchmark's, drawn
from the step's own generator as the planner asks for it (span
``search.draws``) and handed in as ``MacroDraws.search``.

``correct``, after the window: the reference steps every macro step's envs
from their start with the program's actions and must reproduce its end
states exactly (``end_state``); the program plans sampled macro steps again
with ``collect_paths`` and ``return_tree`` and the same noise, which must
reproduce the timed run's actions, root visits and ``repeats_done``; then
the reference (``reference/mcts.py``) reads the phase-A decisions and
habit actions of every env of those steps (``habit_gap``) and replays the
search of sampled envs that searched (``expand_gap``, ``choice_gap``,
``sim_gap`` and, with the re-plans' disagreements, ``mismatches``).

A program whose planner keeps no counters (``utils/profiling.py``
``counters``) cannot run this cell: this module raises at once."""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from portbench.drivers import common
from portbench.yardstick import search, seeds, traffic

WARM = 5  # the set-up step's stream
COUNTERS = ("mcts.iterations", "mcts.env_iterations", "mcts.short_circuits")


class StepNoise:
    """Macro step ``tag``'s draws: at the start the respawns, the root's
    and the phase-A noise; then, in order, each search iteration's."""

    def __init__(self, drv: "Driver", *tag: int):
        self.drv = drv
        self.g = seeds.generator(drv.dev, drv.seed, *tag)
        n = search.step_noise(self.g, drv.wl["envs"], drv.cfg, drv.wl["jumps"], drv.dev)
        self.respawns, self.root, self.habit_gumbel = n["respawns"], n["root"], n["habit_gumbel"]
        self.drawn = 0

    def iteration(self) -> dict:
        with self.drv.tr.span("search.draws"):
            self.drawn += 1
            return search.iteration_noise(self.g, self.drv.wl["envs"], self.drv.cfg,
                                          self.drv.params.simulation_depth, self.drv.dev)

    def macro(self):
        """The program's MacroDraws: the search's iterations drawn lazily,
        each once, in the order the planner asks for them."""
        from deep_active_inference_mc_torch.infer import efe
        from deep_active_inference_mc_torch.plan import mcts
        from deep_active_inference_mc_torch.train.sweep import MacroDraws
        noise = self

        class Iterations:
            def __getitem__(self, i: int):
                if i != noise.drawn:
                    raise IndexError(f"iteration {i} asked for after {noise.drawn}")
                n = noise.iteration()
                e, r, t = n["expand"], n["rollout"], n["trajectory"]
                return mcts.IterationDraws(
                    expand=efe.GDraws(e["masks1"], e["masks2"], e["eps_fixed"]),
                    simulate=efe.SimulateDraws(
                        efe.HabitRolloutDraws(r["gumbel"], r["masks"], r["eps"]),
                        efe.TrajectoryDraws(t["masks"], t["eps"], t["eps_fixed"])))

        r = self.root
        draws = mcts.SearchDraws(efe.GDraws(r["masks1"], r["masks2"], r["eps_fixed"]),
                                 Iterations(), habit_gumbel=self.habit_gumbel)
        return MacroDraws(None, self.respawns, None, draws)


def executed(actions: torch.Tensor, lengths: torch.Tensor, root_N: torch.Tensor):
    """The action a macro step runs (``train/sweep.py`` ``_mcts_plan``): the
    plan's first, or the root's visit-max where the plan is empty."""
    return torch.where(lengths > 0, actions[:, 0], torch.argmax(root_N, dim=-1))


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, tracer, dtype: str):
        from deep_active_inference_mc_torch.utils import profiling
        if not hasattr(profiling, "counters"):
            raise RuntimeError("this program's planner keeps no counters "
                               "(utils/profiling.py counters): it cannot run an mcts cell")
        from deep_active_inference_mc_torch.envs import raster
        from deep_active_inference_mc_torch.plan import mcts
        from deep_active_inference_mc_torch.train.sweep import make_sweep

        self.cfg, self.wl, self.seed, self.dev, self.tr = cfg, wl, seed, device, tracer
        self.params = mcts.MCTSParams(**cfg["planner"])
        with tracer.span("setup.agent"):
            self.pcfg, self.agent = common.program_agent(cfg, device, dtype)
            self.lut = raster.build_sprite_lut(device)
        self.sweep = make_sweep(self.agent, self.pcfg, self.lut, method="mcts",
                                n_macro_steps=1, jumps=wl["jumps"], mcts_params=self.params,
                                zero_score=False)
        self.units = self.attempted = self.failed = 0
        self.steps = []  # per unit: (unit, start, end, the plan's result)
        self.env = None
        self.base = {}

    def _start(self, *tag):
        from deep_active_inference_mc_torch.envs.dsprites import EnvState
        return EnvState(*traffic.episode_start(seeds.generator(self.dev, self.seed, *tag),
                                               self.wl["envs"], self.dev))

    def _counters(self) -> dict:
        from deep_active_inference_mc_torch.utils import profiling
        now = profiling.counters()
        return {k: now.get(k, 0) for k in COUNTERS}

    def warm(self) -> None:
        with self.tr.span("setup.warm"):
            self.sweep(None, self._start(WARM), draws=[StepNoise(self, WARM, 0).macro()])
            self.base = self._counters()

    def unit(self) -> None:
        w = self.wl
        if self.units % w["episode"] == 0:
            self.env = self._start(seeds.EPISODE, self.units // w["episode"])
        start = self.env
        with self.tr.span("sweep.chunk"):
            out = self.sweep(None, start, draws=[StepNoise(self, seeds.CHUNK, self.units).macro()])
        res = self.sweep.planner.last
        self.env = out["env"]
        self.steps.append((self.units, start, self.env,
                           (res.actions, res.lengths, res.root_N, res.repeats_done)))
        self.attempted += w["envs"]
        if not math.isfinite(out["score_mean"]):
            self.failed += w["envs"]
        self.tr.count("macro_steps", 1)
        self.units += 1

    def end_to_end(self, window_s: float) -> dict:
        w = self.wl
        return {"env_steps_per_s": self.units * w["envs"] * w["jumps"] / window_s}

    def trace_extras(self) -> dict:
        """The planner's counters over the window (the port's, less those of
        set-up), the batch's envs, and the FLOPs of the window's plans."""
        now = self._counters()
        out = {k: now[k] - self.base.get(k, 0) for k in COUNTERS}
        out["mcts.envs"] = self.wl["envs"]
        out["flops"] = search.plan_flops(self.cfg, self.wl["envs"], self.units,
                                         out["mcts.short_circuits"],
                                         out["mcts.env_iterations"],
                                         self.params.simulation_depth)
        return out

    def release(self) -> None:
        """The sweep and its planner's graphs go; the agent stays for the
        check's re-plans."""
        del self.sweep
        common.free_device()

    def _replan(self, k: int):
        """Macro step ``k`` of the window planned again by the program with
        its paths and tree: (the result, the envs whose actions, plan
        lengths, root visits or ``repeats_done`` differ from the timed run's)."""
        from deep_active_inference_mc_torch.envs import dsprites
        from deep_active_inference_mc_torch.plan import mcts
        unit, start, _, timed = self.steps[k]
        res = mcts.active_inference_mcts(self.agent, dsprites.render(self.lut, start),
                                         self.params,
                                         draws=StepNoise(self, seeds.CHUNK, unit).macro().search,
                                         collect_paths=True, return_tree=True, graphed=None)
        again = (res.actions, res.lengths, res.root_N, res.repeats_done)
        differ = torch.zeros(self.wl["envs"], dtype=torch.bool, device=self.dev)
        for a, b in zip(timed, again):
            differ |= (a != b).reshape(a.shape[0], -1).any(-1)
        return res, differ.cpu().numpy()

    def check(self) -> dict:
        from portbench.reference import env as ref_env
        from portbench.reference import mcts as ref
        from portbench.reference import nets

        c, w, A = self.cfg, self.wl, self.cfg["pi_dim"]
        kn = ref.Knobs.of(c["planner"], c["dropout"], A)
        rng = seeds.numpy_rng(self.seed, seeds.SAMPLE)
        picks = sorted(rng.choice(len(self.steps), min(w["check_steps"], len(self.steps)),
                                  replace=False).tolist())
        replans, replay_differs = {}, 0
        with torch.inference_mode():
            for k in picks:
                res, differ = self._replan(k)
                replay_differs += int(differ.sum())
                searched = np.nonzero(res.repeats_done.cpu().numpy() > 0)[0]
                envs = sorted(rng.choice(searched, min(w["check_envs"], len(searched)),
                                         replace=False).tolist())
                replans[k] = (res, envs)
        del self.agent
        common.free_device()

        P = nets.Params(common.ROOT / c["weights_file"], self.dev)
        table = ref_env.lut(self.dev)
        ends_off, habit_gap = 0, 0.0
        gaps = dict.fromkeys(("expand_gap", "G_gap", "state_gap", "root_gap", "choice_gap",
                              "own_choice_gap"), 0.0)
        mismatches, sim_gaps, sim_ties, replayed = [], [], 0, 0
        with nets.exact_float32(), torch.inference_mode():
            for unit, start, end, timed in self.steps:
                respawns = StepNoise(self, seeds.CHUNK, unit).respawns
                lat, score, last_r = ref_env.step_repeated(
                    start.latents, start.score, start.last_r, executed(*timed[:3]), respawns)
                ends_off += int((~((lat == end.latents).all(-1) & (score == end.score)
                                   & (last_r == end.last_r))).sum())
            for k in picks:
                unit, start, _, timed = self.steps[k]
                res, envs = replans[k]
                noise = StepNoise(self, seeds.CHUNK, unit)
                o = ref_env.render(table, start.latents, start.last_r)
                s0, _ = nets.encode(P, o)
                _, Qpi = nets.habit(P, s0)
                habit_gap = max(habit_gap, self._habit_gap(ref, Qpi, noise.habit_gumbel, timed,
                                                           kn.threshold))
                if not envs:
                    continue
                idx = torch.as_tensor(envs, device=self.dev)
                prog = self._program(ref, res, idx)

                def noise_of(i):  # asked for in order, each once
                    assert i == noise.drawn
                    return ref.select_rows(noise.iteration(), idx, A)

                out = ref.replay(P, prog, s0[idx], Qpi[idx], ref.g_rows(noise.root, idx, A),
                                 noise_of, kn, w["G_floor"], w["s_floor"])
                replayed += len(envs)
                gaps = {k: max(v, out[k]) for k, v in gaps.items()}
                mismatches += out["mismatches"]
                sim_gaps += out["sim_gaps"]
                sim_ties += out["sim_ties"]
        kinds = sorted({m[2] for m in mismatches})
        # The batch runs one iteration past its last env's decision (the
        # flag read one iteration late), within the budget.
        iters = Counter(min(int(t[3].max()) + 1, self.params.repeats) for _, _, _, t in self.steps)
        self.detail = (f"plans by iterations run: "
                       f"{', '.join(f'{n} x {k}' for n, k in sorted(iters.items()))}\n"
                       f"reference: {len(self.steps)} macro steps stepped, {ends_off} end states "
                       f"off; {len(picks)} re-planned, {replay_differs} envs differ from the "
                       f"timed run; {replayed} searches replayed: mismatches "
                       f"{len(mismatches)} ({', '.join(kinds) or 'none'}); expand G gap "
                       f"{gaps['G_gap']:.4g}, child state gap {gaps['state_gap']:.4g}, root "
                       f"state gap {gaps['root_gap']:.4g}, own choice gap "
                       f"{gaps['own_choice_gap']:.4g}, simulation G gap median "
                       f"{float(np.median(sim_gaps)) if sim_gaps else 0.0:.4g} max "
                       f"{max(sim_gaps, default=0.0):.4g} over {len(sim_gaps)} rollouts "
                       f"({sim_ties} left out for a near tie)")
        lim = w["limits"]
        return {"expand_gap": common.check(gaps["expand_gap"], lim["expand_gap"]),
                "choice_gap": common.check(gaps["choice_gap"], lim["choice_gap"]),
                "sim_gap": common.check(max(sim_gaps, default=0.0), lim["sim_gap"]),
                "habit_gap": common.check(habit_gap, lim["habit_gap"]),
                "mismatches": common.check(len(mismatches) + replay_differs, lim["mismatches"]),
                "end_state": common.check(ends_off, lim["end_state"])}

    @staticmethod
    def _habit_gap(ref, Qpi, gumbel, timed, threshold) -> float:
        """Over every env of a step: where the program's phase-A decision
        (no search) differs from the reference's, the distance of the
        reference's confidence from the threshold; where both took the
        habit's action and the actions differ, the reference's score margin
        between its action and the program's."""
        short, action, score, conf = ref.phase_a(Qpi, gumbel, threshold)
        prog_short = timed[3] == 0
        prog_action = executed(*timed[:3])
        gap = torch.where(short != prog_short, (conf - threshold).abs(), 0.0)
        both = short & prog_short & (action != prog_action)
        at = lambda a: score.gather(1, a[:, None])[:, 0]
        margin = at(action) - at(prog_action)
        gap = torch.maximum(gap, torch.where(both, margin, 0.0))
        return float(gap.max())

    @staticmethod
    def _program(ref, res, idx: torch.Tensor):
        """The re-plan's search of envs ``idx`` as the reference reads it."""
        tree = res.tree
        host = lambda x: x.index_select(0, idx).cpu().numpy()
        f64 = lambda x: host(x.double())
        return ref.Program(paths=res.all_paths.index_select(1, idx).cpu().numpy(),
                           sim_G=res.all_paths_G.index_select(1, idx).double().cpu().numpy(),
                           W=f64(tree.W), N=f64(tree.N), children=host(tree.children),
                           s=tree.s.index_select(0, idx), repeats_done=host(res.repeats_done),
                           root_N=f64(res.root_N),
                           action=host(executed(res.actions, res.lengths, res.root_N)))
