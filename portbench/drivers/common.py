"""What every driver shares: the program's agent from a configuration, and
freeing the program's state before the reference runs."""

from __future__ import annotations

import gc
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NOT_REPRODUCED = 1e9  # a reading with no finite value (JSON has no infinity)


def program_agent(cfg: dict, device, dtype: str):
    """The port's agent at the configuration's widths and compute dtype,
    its weights loaded through the sweep CLI's ``-n`` path from the
    configuration's checkpoint directory; the kernel cache where the run
    points it (``DAIF_COMP_CACHE``)."""
    from deep_active_inference_mc_torch.apps.sweep import build_agent
    from deep_active_inference_mc_torch.config import Config
    from deep_active_inference_mc_torch.utils import compcache

    compcache.enable_persistent_cache()
    pcfg = Config(s_dim=cfg["s_dim"], pi_dim=cfg["pi_dim"],
                  colour_channels=cfg["colour_channels"], resolution=cfg["resolution"])
    agent = build_agent(pcfg, str(ROOT / cfg["weights_dir"]), device, DTYPES[dtype])
    return pcfg, agent.eval()


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}
