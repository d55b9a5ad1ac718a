"""Single-dataclass configuration, the port's own copy of the JAX package's
``Config`` (same field names, same defaults; a test holds them equal).

The comments name the option; the JAX package's ``config.py`` holds the
measurements behind each non-reference default. The run-folder, save/load
and CLI-override helpers come with the trainer that uses them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # --- model dims ---
    s_dim: int = 10
    pi_dim: int = 4
    colour_channels: int = 1
    resolution: int = 64

    # --- omega sigmoid ---
    var_a: float = 1.0
    var_b: float = 25.0
    var_c: float = 5.0
    var_d: float = 1.5

    # --- precisions & annealing ---
    beta_s: float = 1.0
    beta_o: float = 1.0
    gamma: float = 0.0
    gamma_rate: float = 0.01
    gamma_max: float = 0.8
    gamma_delay: int = 30

    # --- EFE data generation ---
    deepness: int = 1
    samples: int = 1
    repeats: int = 5
    temperature: float = 10.0  # softmax(-G) temperature
    crn: bool = False  # common random numbers across the 4 candidate actions
    gen_mean: bool = False  # mean G estimator in the on-policy generator
    explore_eps: float = 0.0  # exploration floor on the executed action
    edge_frac: float = 0.0  # fraction of generator envs pinned to the edge
    gen_habit_mix: float = 0.0  # habit-policy mixing in the behaviour policy

    # --- MCTS-visit distillation (0 = off) ---
    distill_every: int = 0
    distill_envs: int = 256
    distill_macro: int = 40
    distill_repeats: int = 100
    distill_expand_k: int = 4
    distill_batch: int = 2048
    distill_passes: int = 4
    distill_temp: float = 1.0

    # VAE encoder/decoder dropout during the training losses (0/1).
    vae_train_dropout: int = 0

    # --- optimization ---
    l_rate_top: float = 1e-4
    l_rate_mid: float = 1e-4
    l_rate_down: float = 1e-3
    clip_grad: float = 0.0  # global-norm clip per layer optimizer; 0 = off
    freeze_top: bool = False  # skip the habit net's update

    # --- training volume ---
    batch: int = 50
    rounds: int = 1000
    test_size: int = 1000
    epochs: int = 1000

    # --- checkpoint cadence ---
    save_every: int = 2
    archive_every: int = 25

    # --- per-epoch behavioral sweep ---
    sweep_envs: int = 512
    sweep_steps: int = 100

    # --- artifact cadence ---
    viz_every: int = 1

    # --- execution ---
    bf16: bool = False
    mesh_shape: Optional[int] = None
    tp: int = 1

    # --- run identity ---
    prefix: str = "final_model_"
    out_root: str = "runs"

    @property
    def signature(self) -> str:
        """Run-folder signature."""
        return (
            f"{self.prefix}{self.gamma_rate}_{self.gamma_delay}_{self.var_a}_"
            f"{self.batch}_{self.s_dim}_{self.repeats}"
        )
