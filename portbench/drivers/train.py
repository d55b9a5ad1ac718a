"""Phase-3 training resumed from a committed agent: ``train/loop.py``'s
graphed epoch, one round per call.

The traffic: the trainer CLI's ``--resume`` of the configuration's
checkpoint with the run's flags (``flags``: the run's ``config.json``),
each round's noise the benchmark's, drawn from the round's own generator.
A call is ``make_epoch_fn``'s epoch of one round, so that each round's
losses reach the host (the CLI's epoch of 1000 rounds syncs once). The
per-epoch eval pass, sweep and save are left out. ``correct``: set-up runs
the first three rounds through the window's own call, and the reference
follows them from the same weights and noise (``reference/train.py``):
each round's three losses, each leaf's first gradient as Adam holds it
after round 1, and each leaf's change after round 3."""

from __future__ import annotations

import json
import math

import torch

from portbench.drivers import common
from portbench.yardstick import flops, seeds, traffic

STEPS_CHECKED = 3


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device, tracer, dtype: str):
        from deep_active_inference_mc_torch.config import Config
        from deep_active_inference_mc_torch.envs import raster
        from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
        from deep_active_inference_mc_torch.train import loop
        from deep_active_inference_mc_torch.utils import checkpoint, compcache

        self.cfg, self.wl, self.seed, self.dev, self.tr = cfg, wl, seed, device, tracer
        with open(common.ROOT / wl["flags"]) as f:
            flags = json.load(f)
        flags.update(batch=wl["batch"], bf16=dtype == "bfloat16", mesh_shape=None)
        self.pcfg = pcfg = Config(**flags)
        with tracer.span("setup.agent"):
            compcache.enable_persistent_cache()
            agent = ActiveInferenceAgent(pcfg.s_dim, pcfg.pi_dim, pcfg.colour_channels,
                                         pcfg.resolution, common.DTYPES[dtype])
            gen = torch.Generator(device=device)
            state = loop.create_train_state(pcfg, agent, gen, device)
            self.state, _ = checkpoint.load_all(common.ROOT / cfg["weights_dir"], state, gen)
            self.lut = raster.build_sprite_lut(device)
        self.epoch = loop.make_epoch_fn(pcfg, self.lut, rounds=1)
        self.units = self.attempted = self.failed = 0
        self.losses, self.first_grads, self.changes = [], {}, {}

    def _draws(self, k: int):
        from deep_active_inference_mc_torch.envs import data
        from deep_active_inference_mc_torch.infer import efe
        from deep_active_inference_mc_torch.train import losses, loop
        c, b = self.cfg, self.wl["batch"]
        n = traffic.round_noise(seeds.generator(self.dev, self.seed, seeds.CHUNK, k), b,
                                c["pi_dim"], c["s_dim"], c["transition_hidden"], c["dropout"],
                                self.pcfg.repeats, self.dev)
        gen = data.GeneratorDraws(
            env=(n["latents"], n["score"], n["last_r"]), edge=(n["edge_u"], n["edge_posy"]),
            rollout=efe.RolloutDraws(None, [efe.GDraws(**n["G"])]), gumbel=n["gumbel"],
            respawns=n["respawns"])
        staged = losses.StagedDraws(eps_s0=n["eps_s0"],
                                    mid=losses.MidDraws(n["mid_masks"], n["mid_eps"]),
                                    down=losses.DownDraws(n["down_eps"]))
        return loop.RoundDraws(gen, staged)

    def _round(self, k: int) -> dict:
        with self.tr.span("train.round"):
            _, out = self.epoch(self.state, None, draws=[self._draws(k)])
        return out

    def warm(self) -> None:
        """Rounds 0-2, the first the graph's warm-up and capture: each
        round's losses, Adam's first moments after round 0, and the weights
        before round 0 and after round 2."""
        agent = self.state.agent
        theta0 = {n: p.detach().clone() for n, p in agent.named_parameters()}
        with self.tr.span("setup.warm"):
            for k in range(STEPS_CHECKED):
                out = self._round(k)
                self.losses.append({n: out[n] for n in ("F_top", "F_mid", "F_down")})
                if k == 0:  # a layer whose Adam did not step holds no moment: 0
                    for layer, opt in self.state.opts.items():
                        b1 = opt.param_groups[0]["betas"][0]
                        for name, p in getattr(agent, layer).named_parameters():
                            m = opt.state[p]["exp_avg"] if p in opt.state else torch.zeros(1)
                            self.first_grads[f"{layer}.{name}"] = float(
                                torch.linalg.vector_norm(m) / (1.0 - b1))
        self.changes = {n: float(torch.linalg.vector_norm(p.detach() - theta0[n]))
                        for n, p in agent.named_parameters()}

    def unit(self) -> None:
        out = self._round(STEPS_CHECKED + self.units)
        self.attempted += self.wl["batch"]
        if not all(math.isfinite(v) for v in out.values()):
            self.failed += self.wl["batch"]
        self.tr.count("flops", flops.train_round(self.cfg, self.wl["batch"]))
        self.units += 1

    def end_to_end(self, window_s: float) -> dict:
        return {"train_env_steps_per_s": self.units * self.wl["batch"] / window_s}

    def trace_extras(self) -> dict:
        return {}

    def release(self) -> None:
        del self.epoch, self.state, self.lut
        common.free_device()

    def check(self) -> dict:
        from portbench.reference import env as ref_env
        from portbench.reference import train as ref_train

        c, w = self.cfg, self.wl
        with open(common.ROOT / w["flags"]) as f:
            flags = json.load(f)
        noise = [traffic.round_noise(seeds.generator(self.dev, self.seed, seeds.CHUNK, k),
                                     w["batch"], c["pi_dim"], c["s_dim"],
                                     c["transition_hidden"], c["dropout"], flags["repeats"],
                                     self.dev) for k in range(STEPS_CHECKED)]
        got, self.detail = ref_train.follow(common.ROOT / c["weights_file"], ref_env.lut(self.dev), flags,
                               noise, self.losses, self.first_grads, self.changes, c["dropout"],
                               self.dev)
        return {k: common.check(v if math.isfinite(v) else common.NOT_REPRODUCED,
                                w["limits"][k]) for k, v in got.items()}
