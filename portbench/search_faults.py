"""Faults planted in the planner (``plan/mcts.py``), for the check that
``correct`` comes out false in the MCTS cell (``tests/``, and the control
runs). Each is a context manager that patches the program in this process
and restores it, as ``faults.py``'s do.

    python -m portbench.search_faults --workload flagship-mcts-256 \
        --seconds <s> --seeds 1,2,3 --mode fault:<name>[,...]

runs ``control.py`` with these faults beside ``faults.py``'s."""

from __future__ import annotations

import importlib
import sys

import torch

from portbench import faults

MCTS = "deep_active_inference_mc_torch.plan.mcts"
EFE = "deep_active_inference_mc_torch.infer.efe"


def _argmin(orig):
    return lambda W, N, Qpi, C, use_prior: -orig(W, N, Qpi, C, use_prior)


def _no_exploration(orig):
    return lambda W, N, Qpi, C, use_prior: orig(W, N, Qpi, 0.0, use_prior)


def _term_dropped(orig):
    def G_mean(*a, **k):
        G, terms, ps1_mean, po1 = orig(*a, **k)
        return G - terms[1], terms, ps1_mean, po1
    return G_mean


def _rollout_means(orig):
    def simulate(*a, **k):
        return orig(*a, **dict(k, use_means=True))
    return simulate


def _sim_term_dropped(orig):
    state_entropy = importlib.import_module(EFE)._state_entropy

    def G_given_trajectory(agent, s0, ps1, ps1_mean, ps1_logvar, pi0, **k):
        _, qs1_logvar = agent.encode(agent.decode(ps1))
        return (orig(agent, s0, ps1, ps1_mean, ps1_logvar, pi0, **k)
                + state_entropy(ps1_logvar, qs1_logvar))
    return G_given_trajectory


def _init(change):
    def wrap(orig):
        def init(*a, **k):
            carry = orig(*a, **k)
            change(carry)
            carry.done = carry.tree.done
            return carry
        return init
    return wrap


def _all_short(carry):
    carry.habit_done = torch.ones_like(carry.habit_done)
    carry.tree.done = torch.ones_like(carry.tree.done)


def _none_short(carry):
    carry.habit_done = torch.zeros_like(carry.habit_done)
    carry.tree.done = torch.zeros_like(carry.tree.done)  # no root expand decides


def _root_visited_twice(carry):
    carry.tree.N[:, 0] += 1.0


FAULTS = {
    # the selection walk takes the child of least UCB
    "argmin_walk": lambda: faults._patched(MCTS, "_probs_for_selection", _argmin),
    # the walk's exploration term taken out (C = 0)
    "no_exploration": lambda: faults._patched(MCTS, "_probs_for_selection", _no_exploration),
    # the state-epistemic term (b) dropped from every expand's G
    "G_term_dropped": lambda: faults._patched(EFE, "calculate_G_mean", _term_dropped),
    # the simulation's habit rollout threads the transition's means, not its samples
    "sim_rollout_means": lambda: faults._patched(EFE, "mcts_step_simulate", _rollout_means),
    # the state-epistemic term (b) dropped from the simulation's trajectory G
    "sim_term_dropped": lambda: faults._patched(EFE, "calculate_G_given_trajectory",
                                                _sim_term_dropped),
    # phase A's habit short-circuit taken for every env
    "short_circuit_on": lambda: faults._patched(MCTS, "_init_search", _init(_all_short)),
    # phase A's habit short-circuit never taken
    "short_circuit_off": lambda: faults._patched(MCTS, "_init_search", _init(_none_short)),
    # the root's edges seeded with two visits where the expand gives one
    "root_visits_altered": lambda: faults._patched(MCTS, "_init_search",
                                                   _init(_root_visited_twice)),
}


def main(argv=None) -> int:
    from portbench import control
    faults.FAULTS.update(FAULTS)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
