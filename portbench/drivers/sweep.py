"""The evaluation sweep: ``train/sweep.py`` ``make_sweep``, chunk by chunk.

The traffic: episodes of ``episode`` macro steps over ``envs`` envs from
seeded starts (``yardstick/traffic.py``), run in graphed chunks of
``chunk`` macro steps, as ``run_sweep`` runs them, until the window is
full. Every macro step renders each env (K1), picks one action per env with
the workload's controller and runs it ``jumps`` times. The noise of every
macro step is the benchmark's, drawn from the chunk's own generator and
handed to the sweep as its draws; the reference draws it again after the
window. ``correct``: the reference replays sampled envs of sampled chunks
from the program's chunk-start state and must reproduce the program's end
state with flips only where the two precisions tie (``reference/sweep.py``,
``flip_gap``)."""

from __future__ import annotations

import math

import torch

from portbench.drivers import common
from portbench.yardstick import flops, k1_bytes, seeds, traffic

WARM = 5  # the set-up chunk's stream


class ChunkNoise:
    """The ``chunk`` macro steps' draws of chunk ``tag``, made as the sweep
    asks for them (in order), as the program's ``MacroDraws``."""

    def __init__(self, drv: "Driver", *tag: int):
        self.drv, self.n = drv, drv.wl["chunk"]
        self.g = seeds.generator(drv.dev, drv.seed, *tag)
        self.made = []

    def raw(self) -> dict:
        c, w = self.drv.cfg, self.drv.wl
        return traffic.macro_noise(self.g, w["method"], w["envs"], c["pi_dim"], c["s_dim"],
                                   c["transition_hidden"], c["dropout"], w["jumps"],
                                   self.drv.dev)

    def _draws(self):
        from deep_active_inference_mc_torch.infer import efe
        from deep_active_inference_mc_torch.train.sweep import MacroDraws
        n = self.raw()
        rollout = None
        if "masks1" in n:
            rollout = efe.RolloutDraws(None, [efe.GDraws(n["masks1"], n["masks2"],
                                                         n["eps_fixed"])])
        return MacroDraws(n["gumbel"], n["respawns"], rollout)

    def __getitem__(self, t: int):
        while len(self.made) <= t:
            self.made.append(self._draws())
        return self.made[t]

    def __iter__(self):
        for _ in range(self.n):
            yield self._draws()


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, tracer, dtype: str):
        from deep_active_inference_mc_torch.envs import raster
        from deep_active_inference_mc_torch.train.sweep import make_sweep

        self.cfg, self.wl, self.seed, self.dev, self.tr = cfg, wl, seed, device, tracer
        with tracer.span("setup.agent"):
            self.pcfg, self.agent = common.program_agent(cfg, device, dtype)
            self.lut = raster.build_sprite_lut(device)
        self.sweep = make_sweep(self.agent, self.pcfg, self.lut, method=wl["method"],
                                n_macro_steps=wl["chunk"], steps=1, samples=1,
                                jumps=wl["jumps"], temperature=wl["temperature"],
                                calc_mean=True, zero_score=False)
        self.units = self.attempted = self.failed = 0
        self.chunks = []  # (chunk index, start state, end state)
        self.traced_starts = []
        self.env = None
        self.episode = 0

    def _start(self, *tag):
        from deep_active_inference_mc_torch.envs.dsprites import EnvState
        return EnvState(*traffic.episode_start(seeds.generator(self.dev, self.seed, *tag),
                                               self.wl["envs"], self.dev))

    def warm(self) -> None:
        with self.tr.span("setup.warm"):
            self.sweep(None, self._start(WARM), draws=ChunkNoise(self, WARM, 0))

    def unit(self) -> None:
        w = self.wl
        per_episode = w["episode"] // w["chunk"]
        if self.units % per_episode == 0:
            self.env = self._start(seeds.EPISODE, self.units // per_episode)
        start = self.env
        if self.tr.profiling:
            self.traced_starts.append(start.latents)
        with self.tr.span("sweep.chunk"):
            out = self.sweep(None, start, draws=ChunkNoise(self, seeds.CHUNK, self.units))
        self.env = out["env"]
        self.chunks.append((self.units, start, self.env))
        steps = w["envs"] * w["chunk"]
        self.attempted += steps
        if not math.isfinite(out["score_mean"]):
            self.failed += steps
        self.tr.count("macro_steps", w["chunk"])
        self.tr.count("flops", w["chunk"] * flops.macro_step(self.cfg, w["method"], w["envs"]))
        self.units += 1

    def end_to_end(self, window_s: float) -> dict:
        w = self.wl
        return {"env_steps_per_s": self.units * w["chunk"] * w["envs"] * w["jumps"] / window_s}

    def trace_extras(self) -> dict:
        """The K1 bytes of a render of the traced chunks' states and, for
        ``ai``, ``efe_ms``: CUDA events around 20 graphed calls of the G
        estimator at the cell's shapes, after the window."""
        out = {}
        if self.traced_starts:
            out["k1_bytes_per_call"] = (sum(k1_bytes.bound_bytes(x) for x in self.traced_starts)
                                        / len(self.traced_starts))
        if self.wl["method"] == "ai" and self.dev.type == "cuda":
            out["efe_ms"] = self._time_efe(20)
        return out

    @torch.inference_mode()
    def _time_efe(self, n: int) -> float:
        from deep_active_inference_mc_torch.envs import dsprites
        from deep_active_inference_mc_torch.infer import efe
        from deep_active_inference_mc_torch.utils.graphs import Graphs, module_deps

        o = dsprites.render(self.lut, self.env)
        d = ChunkNoise(self, WARM, 1)[0].rollout
        agent, graphs = self.agent, Graphs()

        def g4(o, d):
            return efe.calculate_G_4_repeated(agent, o, steps=1, calc_mean=True, samples=1,
                                              draws=d)[0]

        deps = lambda: module_deps(agent)
        for _ in range(3):  # eager warm-up and capture, then a replay
            graphs.call(g4, (o, d), deps=deps)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            graphs.call(g4, (o, d), deps=deps)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / n

    def release(self) -> None:
        del self.sweep, self.agent, self.lut
        common.free_device()

    def check(self) -> dict:
        from portbench.reference import env as ref_env
        from portbench.reference import nets
        from portbench.reference.sweep import flip_gap

        c, w = self.cfg, self.wl
        rng = seeds.numpy_rng(self.seed, seeds.SAMPLE)
        picks = sorted(rng.choice(len(self.chunks), min(w["check_chunks"], len(self.chunks)),
                                  replace=False).tolist())
        P = nets.Params(common.ROOT / c["weights_file"], self.dev)
        table = ref_env.lut(self.dev)
        readings = []
        with nets.exact_float32(), torch.inference_mode():
            for k in picks:
                idx, start, end = self.chunks[k]
                envs = torch.as_tensor(sorted(rng.choice(w["envs"], w["check_envs"],
                                                         replace=False).tolist()),
                                       device=self.dev)
                noise = ChunkNoise(self, seeds.CHUNK, idx)
                steps = [self._rows(noise.raw(), envs) for _ in range(w["chunk"])]
                pick = lambda s: (s.latents[envs], s.score[envs], s.last_r[envs])
                readings += flip_gap(P, table, pick(start), pick(end), steps.__getitem__,
                                     w["chunk"], w["method"], w["temperature"], c["dropout"],
                                     c["pi_dim"])
        worst = max(readings)
        self.detail = (f"reference: {len(readings)} envs of {len(picks)} chunks compared, "
                       f"{sum(0 < r < math.inf for r in readings)} reproduced with flips, "
                       f"{sum(r == math.inf for r in readings)} not reproduced")
        return {"flip_gap": common.check(worst if math.isfinite(worst)
                                         else common.NOT_REPRODUCED, w["limits"]["flip_gap"])}

    def _rows(self, n: dict, envs: torch.Tensor) -> dict:
        """The sampled envs' rows of one macro step's noise (row j: env j)."""
        A = self.cfg["pi_dim"]
        out = {"gumbel": n["gumbel"][envs], "respawns": n["respawns"][:, envs]}
        if "masks1" in n:
            rows = (envs[:, None] * A + torch.arange(A, device=envs.device)).reshape(-1)
            for k in ("masks1", "masks2"):
                out[k] = [m[rows] for m in n[k]]
            out["eps_fixed"] = n["eps_fixed"][rows]
        return out
