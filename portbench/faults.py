"""Faults planted under the timed path, for the check that ``correct``
comes out false (``tests/``, ``control.py``). Each is a context manager that
patches the program in this process and restores it."""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _patched(module: str, attr: str, make):
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def _unchanged(orig):
    def step(state, action, repeats, generator=None, respawns=None):
        return state, torch.zeros(state.batch, dtype=torch.bool, device=state.device)
    return step


def _half_stepped(orig):
    def step(state, action, repeats, generator=None, respawns=None):
        from deep_active_inference_mc_torch.envs.dsprites import EnvState
        n = max(state.batch // 2, 1)
        s, d = orig(state.select(slice(0, n)), action[:n], repeats, generator,
                    None if respawns is None else respawns[:, :n])
        rest = state.select(slice(n, None))
        return (EnvState(*(torch.cat([getattr(s, f), getattr(rest, f)])
                           for f in ("latents", "score", "last_r"))),
                torch.cat([d, torch.zeros(state.batch - n, dtype=torch.bool,
                                          device=state.device)]))
    return step


def _altered(orig):
    def categorical(logits, generator=None, noise=None):
        a = orig(logits, generator, noise).clone()
        a[0] = (a[0] + 1) % logits.shape[-1]
        return a
    return categorical


def _no_update(orig):
    return lambda opt, loss, clip, apply=True, mesh=None: orig(opt, loss, clip, False, mesh)


def _twice(orig):
    def step(self, *a, **k):
        orig(self, *a, **k)
        return orig(self, *a, **k)
    return step


def _half_mean(orig):
    def loss(*a, **k):
        F, rest = orig(*a, **k)
        n = F.shape[0] // 2
        return torch.cat([F[:n], F[:n].mean().expand(F.shape[0] - n)]), rest
    return loss


@contextlib.contextmanager
def _both(*cms):
    with contextlib.ExitStack() as stack:
        for cm in cms:
            stack.enter_context(cm)
        yield


ENV = "deep_active_inference_mc_torch.envs.dsprites"
FAULTS = {
    # an env step that returns its state unchanged
    "state_unchanged": lambda: _patched(ENV, "step_repeated", _unchanged),
    # half of the batch left out of the step
    "half_batch": lambda: _patched(ENV, "step_repeated", _half_stepped),
    # one action altered where it is drawn
    "action_altered": lambda: _patched("deep_active_inference_mc_torch.utils.random",
                                       "categorical", _altered),
    # training: every Adam step withheld (the state unchanged)
    "no_update": lambda: _patched("deep_active_inference_mc_torch.train.loop", "_step",
                                  _no_update),
    # training: every Adam step taken twice (an update altered where it is made)
    "update_doubled": lambda: _patched("torch.optim", "Adam", lambda cls: type(
        "AdamTwice", (cls,), {"step": _twice(cls.step)})),
    # training: the losses' mean over half of the rows
    "half_batch_mean": lambda: _both(
        _patched("deep_active_inference_mc_torch.train.losses", "compute_loss_mid", _half_mean),
        _patched("deep_active_inference_mc_torch.train.losses", "compute_loss_down",
                 _half_mean)),
}
