"""Training statistics registry.

The port's own copy of ``deep_active_inference_mc_tpu/utils/stats.py`` (a
test holds the key list equal to the JAX one): ~70 named series, appended
once per epoch by the trainer and pickled into every checkpoint.
"""

from __future__ import annotations

from typing import Dict, List

STATS_KEYS = [
    "F", "F_top", "F_mid", "F_down", "mse_o", "TC",
    "kl_div_s", "kl_div_s_anal", "omega", "learning_rate",
    "current_lr", "mse_r", "omega_std", "kl_div_pi",
    "kl_div_pi_min", "kl_div_pi_max", "kl_div_pi_med",
    "kl_div_pi_std", "kl_div_pi_anal", "deep_mse_o",
    "var_beta_o", "var_beta_s", "var_gamma", "var_a",
    "var_b", "var_c", "var_d", "kl_div_s_naive",
    "kl_div_s_naive_anal", "score", "train_scores_m",
    "train_scores_std", "train_scores_sem", "train_scores_min",
    "train_scores_max", "mse_o_clean",
    # On-policy (training) habit KL against the softmax(-G) targets: the
    # series omega responds to. The eval kl_div_pi is taken against one-hot
    # random-policy actions, which pins it near 24.5 for a near-uniform habit.
    "kl_div_pi_train",
    # Behavioural series: the per-epoch sweeps run on a fixed seed, so they
    # are paired across epochs; split by object class, beside constant
    # expert/random baselines on the same seed, a habit-controller sweep and
    # the scoring-edge discrimination probes.
    "train_scores_habit_m", "train_scores_habit_sem",
    "train_events_sq", "train_events_other",
    "train_scores_sq", "train_scores_other",
    "train_scores_expert", "train_scores_random",
    "edge_habit_correct", "edge_habit_wrong",
    "edge_g_correct", "edge_g_wrong",
    "edge_g_gap_nats", "edge_g_sq_gap_nats", "edge_g_oth_gap_nats",
    # Per-layer gradient global norms (last round of the epoch and the
    # epoch's worst round) and the worst per-round F_down.
    "gnorm_top", "gnorm_mid", "gnorm_down",
    "gnorm_top_max", "gnorm_mid_max", "gnorm_down_max",
    "F_down_round_max",
    # MCTS-visit distillation series; zero on epochs without a phase.
    "distill_kl_first", "distill_kl_last",
    "distill_match_first", "distill_match_last",
    "distill_target_entropy",
]


def new_stats() -> Dict[str, List]:
    return {k: [] for k in STATS_KEYS}


def pad_missing(stats: Dict[str, List]) -> Dict[str, List]:
    """Resume-padding: add any missing keys and pad short series with zeros
    to the length of ``stats['F']``."""
    n = len(stats.get("F", []))
    for k in STATS_KEYS:
        stats.setdefault(k, [])
        while len(stats[k]) < n:
            stats[k].append(0.0)
    return stats
