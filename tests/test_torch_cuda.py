"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions on a card, and the training round, the checkpoint, the MCTS
sweeps, the distillation replay, the demo, the causal round and the
benchmark's env steps on a card.
Marked ``cuda``; without a card they skip. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import argparse

import numpy as np
import pytest
import torch

from deep_active_inference_mc_torch.apps import demo as demo_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
from deep_active_inference_mc_torch.ops.cuda import render as k_render
from deep_active_inference_mc_torch.infer.agent import ActiveInferenceAgent
from deep_active_inference_mc_torch.models.causal import StructuralCausalModel
from deep_active_inference_mc_torch.train import causal as causal_lib
from deep_active_inference_mc_torch.train import distill as distill_lib
from deep_active_inference_mc_torch.plan.mcts import MCTSParams
from deep_active_inference_mc_torch.train import sweep as sweep_lib
from deep_active_inference_mc_torch.train import loop as train_loop
from deep_active_inference_mc_torch.utils import checkpoint as ckpt
from deep_active_inference_mc_torch.utils import stats as stats_lib
from deep_active_inference_mc_torch.utils.device import seeded_generator

LAST_R = np.asarray([-1.0, -0.3, 0.0, 0.4], np.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py` on one")
    return torch.device("cuda")


def make_latents(B, seed):
    """Uniform latents with posX/posY pinned to 0 and 31 on the first envs."""
    rng = np.random.default_rng(seed)
    lat = np.stack([rng.integers(0, n, B) for n in tenv.LATENT_SIZES], -1)
    edges = np.asarray([[0, 0], [31, 31], [0, 31], [31, 0]])[:B]
    lat[: len(edges), 4:] = edges
    return lat, LAST_R[np.arange(B) % len(LAST_R)]


# Latents off the grid, as tests/test_torch_render.py holds the plain
# version's clamps against XLA's: offsets beyond 32 and below 0 (counted
# once from the end of the axis), sprites beyond 719 and below 0.
OFF_GRID = np.asarray([[0, 3, 5, 39, 40, 45], [0, 2, 5, 39, -3, -7], [0, 5, 0, 0, 33, 32],
                       [0, 1, 2, 3, 96, 97], [0, 0, 1, 2, 128, 129], [0, -1, 0, 0, 31, 0],
                       [0, -4, 0, 0, 0, 31], [0, 4, 9, 99, 100, -100]])


def card_inputs(B, seed, device):
    """make_latents on ``device``, with the off-grid rows over the last envs."""
    lat, last_r = make_latents(B, seed)
    k = min(B - 1, len(OFF_GRID))  # keep env 0 on the grid
    if k:
        lat[B - k:] = OFF_GRID[:k]
    last_r = last_r.copy()
    last_r[B // 2] = np.float32(-0.0)
    return torch.from_numpy(lat).to(device), torch.from_numpy(last_r).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 256, 1000, 1024, 2048, 4096])
def test_render_kernel_matches_plain(cuda_device, B):
    """K1 bit for bit against its plain version on the card and on the CPU,
    off-grid latents included."""
    latents, last_r = card_inputs(B, B, cuda_device)
    lut = traster.build_sprite_lut(cuda_device)
    before = LAUNCHES["render"]
    got = k_render.render_frames(lut, latents, last_r)
    torch.cuda.synchronize()
    assert LAUNCHES["render"] == before + 1
    assert torch.equal(got, k_render.render_frames_plain(lut, latents, last_r))
    cpu = k_render.render_frames_plain(traster.build_sprite_lut("cpu"), latents.cpu(),
                                       last_r.cpu())
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2048, 1])
def test_render_kernel_at_the_replay_and_demo_batches(cuda_device, B):
    """K1 at the distillation replay's batch (2048 at the defaults) and at
    the demo's single env, bit for bit against its plain version."""
    lat, last_r = make_latents(B, seed=B + 7)
    latents = torch.from_numpy(lat).to(cuda_device)
    last_r = torch.from_numpy(last_r).to(cuda_device)
    lut = traster.build_sprite_lut(cuda_device)
    assert torch.equal(k_render.render_frames_cuda(lut, latents, last_r),
                       k_render.render_frames_plain(lut, latents, last_r))


@pytest.mark.cuda
def test_render_kernel_reads_each_lut_it_is_given(cuda_device):
    """Tensor maps are cached by LUT address: LUTs of different contents in
    turn, more of them than the cache holds, each render from its own."""
    latents, last_r = card_inputs(512, 3, cuda_device)
    base = traster.build_sprite_lut(cuda_device)
    luts = [base * (k + 1) for k in range(10)] + [base.flip(-1).contiguous(), base]
    for _ in range(2):
        for lut in luts:
            assert torch.equal(k_render.render_frames_cuda(lut, latents, last_r),
                               k_render.render_frames_plain(lut, latents, last_r))


@pytest.mark.cuda
def test_env_render_is_one_device_kernel(cuda_device):
    """``envs.dsprites.render`` on a card is one launch: the profiler sees
    exactly one device kernel in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = tenv.randomize(tenv.reset(gen, 512, cuda_device), gen)
    lut = traster.build_sprite_lut(cuda_device)
    tenv.render(lut, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tenv.render(lut, state)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    assert sum(e.count for e in rows) == 1, [(e.key, e.count) for e in rows]
    assert "render_frames_tma" in rows[0].key


@pytest.mark.cuda
def test_distill_replay_launches_the_kernel_once_per_step(cuda_device):
    cfg = Config(distill_envs=8, distill_macro=2, distill_repeats=4, distill_expand_k=2,
                 distill_batch=8, distill_passes=2)
    gen = seeded_generator(cuda_device, 0)
    state = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen, cuda_device)
    distiller = distill_lib.Distiller(state.agent, cfg, traster.build_sprite_lut(cuda_device))
    before = LAUNCHES["render"]
    state, metrics = distiller(state, gen)
    # One render per collected decision, one per replay step.
    assert LAUNCHES["render"] == before + cfg.distill_macro + metrics["distill_steps"] == (
        before + 2 + 4)
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["habit", "mcts"])
def test_demo_round_on_card_renders_once_per_plan(cuda_device, method):
    args = argparse.Namespace(mean=False, method=method, steps=3, temperature=1.0, jumps=5,
                              C=1.0, repeats=4, threshold=0.5, depth=2, no_habit=False, seed=0)
    agent = ActiveInferenceAgent().init(torch.Generator().manual_seed(0)).to(cuda_device)
    demo = demo_app.Demo(agent, args)
    before = LAUNCHES["render"]
    trace = demo.run_round()
    assert LAUNCHES["render"] == before + demo.plans_made and demo.plans_made >= 2
    assert trace.is_cuda and bool(torch.isfinite(trace).all())


@pytest.mark.cuda
def test_causal_round_on_card_launches_the_kernel_twice(cuda_device):
    cfg = Config(batch=64)
    gen = seeded_generator(cuda_device, 0)
    state = causal_lib.create_causal_state(cfg, StructuralCausalModel(), gen, cuda_device)
    before = LAUNCHES["render"]
    state, metrics = causal_lib.causal_round(cfg, state, traster.build_sprite_lut(cuda_device),
                                             gen)
    assert LAUNCHES["render"] == before + 2
    assert all(v.is_cuda and bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.cuda
def test_env_render_on_card_launches_the_kernel(cuda_device):
    """``envs.dsprites.render`` on CUDA tensors always goes through K1."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = tenv.randomize(tenv.reset(gen, 64, cuda_device), gen)
    lut = traster.build_sprite_lut(cuda_device)
    before = LAUNCHES["render"]
    frames = tenv.render(lut, state)
    torch.cuda.synchronize()
    assert LAUNCHES["render"] == before + 1
    assert frames.shape == (64, 1, 64, 64) and frames.is_cuda


@pytest.mark.cuda
def test_train_round_on_card_launches_the_kernel_twice(cuda_device):
    """One training round renders o0 and o1 through K1 and steps all three
    Adams, with every metric finite and still on the card."""
    cfg = Config(batch=64, crn=True, gen_mean=True, edge_frac=0.3)
    gen = seeded_generator(cuda_device, 0)
    state = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen, cuda_device)
    round_fn = train_loop.make_round_fn(cfg, traster.build_sprite_lut(cuda_device))
    before = LAUNCHES["render"]
    state, metrics = round_fn(state, gen)
    assert LAUNCHES["render"] == before + 2
    assert set(metrics) == set(train_loop.METRIC_KEYS)
    assert all(v.is_cuda and bool(torch.isfinite(v)) for v in metrics.values())
    assert all(int(o.state_dict()["state"][0]["step"]) == 1 for o in state.opts.values())


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A resumed run continues the CUDA generator's stream, with weights,
    moments, precisions and envs on the card and Adam's step counters
    where a fresh optimizer keeps them (on the card: the Adams are
    capturable there)."""
    cfg = Config(batch=4)
    gen = seeded_generator(cuda_device, 1)
    state = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen, cuda_device)
    round_fn = train_loop.make_round_fn(cfg, traster.build_sprite_lut(cuda_device))
    state, _ = round_fn(state, gen)
    ckpt.save_all(tmp_path / "checkpoints", state, stats_lib.new_stats(), gen)
    gen2 = seeded_generator(cuda_device, 2)
    template = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen2, cuda_device)
    restored, _ = ckpt.load_all(tmp_path / "checkpoints", template, gen2)
    assert all(p.is_cuda for p in restored.agent.parameters())
    assert restored.env.latents.is_cuda and restored.precision.gamma.is_cuda
    for layer, opt in restored.opts.items():
        fresh = state.opts[layer].state_dict()["state"][0]
        got = opt.state_dict()["state"][0]
        assert got["step"].device == fresh["step"].device and int(got["step"]) == 1
        assert got["exp_avg"].is_cuda and torch.equal(got["exp_avg"], fresh["exp_avg"])
    assert torch.equal(torch.rand(8, generator=gen2, device=cuda_device),
                       torch.rand(8, generator=gen, device=cuda_device))
    restored, metrics = round_fn(restored, gen2)
    assert bool(torch.isfinite(metrics["F_down"]))


@pytest.mark.cuda
@pytest.mark.parametrize("bucketed", [False, True])
def test_mcts_sweep_on_card_renders_once_per_macro(cuda_device, bucketed):
    """The planner's sweeps on a card: one K1 launch per macro step and
    finite scores, still on the card."""
    cfg = Config()
    agent = ActiveInferenceAgent().init(torch.Generator().manual_seed(0)).to(cuda_device)
    lut = traster.build_sprite_lut(cuda_device)
    p = MCTSParams(repeats=4, simulation_depth=2, max_depth=8)

    def run():
        if bucketed:
            return sweep_lib.run_sweep_bucketed(agent, cfg, lut, seed=3, n_envs=32,
                                                n_macro_steps=2, mcts_params=p, min_bucket=8)
        return sweep_lib.run_sweep(agent, cfg, lut, seed=3, n_envs=32, n_macro_steps=2,
                                   method="mcts", mcts_params=p)

    before = LAUNCHES["render"]
    out = run()
    assert LAUNCHES["render"] == before + 2
    assert out["scores"].is_cuda and bool(torch.isfinite(out["scores"]).all())
    assert out["env"].latents.shape == (32, 6)


def _rel_rms(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).square().mean().sqrt() / want.square().mean().sqrt())


@pytest.mark.cuda
def test_bf16_forwards_on_card_match_the_cpu(cuda_device):
    """bf16 forwards on the card and on the CPU round at different places:
    each is held to the CPU's float32, the card's error at most twice the
    CPU's (TF32 off), and every head is float32."""
    g = torch.Generator().manual_seed(0)
    cpu32 = ActiveInferenceAgent().init(g)
    cpu16 = ActiveInferenceAgent(dtype=torch.bfloat16)
    cpu16.load_state_dict(cpu32.state_dict())
    card16 = ActiveInferenceAgent(dtype=torch.bfloat16).to(cuda_device)
    card16.load_state_dict(cpu32.state_dict())
    lat, last_r = make_latents(64, seed=3)
    state = tenv.EnvState(torch.from_numpy(lat), torch.zeros(64), torch.from_numpy(last_r))
    o = tenv.render(traster.build_sprite_lut("cpu"), state)
    s = torch.randn((64, 10), generator=g)
    pi = torch.eye(4)[torch.randint(0, 4, (64,), generator=g)]

    def outs(agent, d):
        with torch.inference_mode():
            mean, logvar = agent.encode(o.to(d))
            return {"enc_mean": mean, "enc_logvar": logvar, "decode": agent.decode(s.to(d)),
                    "transition": agent.transition(pi.to(d), s.to(d))[0],
                    "habit": agent.habit(s.to(d))[0]}

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want, cpu, card = outs(cpu32, "cpu"), outs(cpu16, "cpu"), outs(card16, cuda_device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    for k in want:
        assert card[k].dtype == torch.float32 and card[k].is_cuda, k
        err_card, err_cpu = _rel_rms(card[k], want[k]), _rel_rms(cpu[k], want[k])
        assert err_card <= 2.0 * err_cpu, (k, err_card, err_cpu)


def _collectives(mesh):
    """Rank body: a gather, a sum and Megatron's f on this rank's card."""
    from deep_active_inference_mc_torch.parallel import comm

    x = torch.full((2, 3), float(mesh.rank + 1), device=mesh.device)
    w = torch.ones(3, device=mesh.device, requires_grad=True)
    comm.copy_to_model(w * (mesh.rank + 1), None).sum().backward()
    return {"backend": mesh.backend, "device": str(mesh.device),
            "gather": comm.gather_rows(x), "sum": comm.all_reduce_(x.clone()),
            "reduced": comm.reduce_from_model(x, None), "grad": w.grad}


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [1, 2], ids=["gloo-one-card", "nccl-two-cards"])
def test_collectives_between_two_ranks_on_cards(cuda_device, cards):
    """Two ranks sharing one card talk over gloo; on two cards, over NCCL."""
    from deep_active_inference_mc_torch.parallel import mesh as mesh_lib

    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards")
    if cards == 1 and torch.cuda.device_count() >= 2:
        pytest.skip("with two cards the two ranks get one each (NCCL)")
    ranks = mesh_lib.launch(_collectives, world=2, device="cuda")
    assert [r["backend"] for r in ranks] == ["gloo" if cards == 1 else "nccl"] * 2
    assert len({r["device"] for r in ranks}) == cards
    for rank, r in enumerate(ranks):
        assert torch.equal(r["gather"], torch.tensor([[1.0] * 3] * 2 + [[2.0] * 3] * 2))
        assert torch.equal(r["sum"], torch.full((2, 3), 3.0))
        assert torch.equal(r["reduced"], torch.full((2, 3), 3.0))
        # f sums the output's gradient (ones) over the 2 ranks: 2 x (rank + 1).
        assert torch.equal(r["grad"], torch.full((3,), 2.0 * (rank + 1)))


@pytest.mark.cuda
def test_flagship_export_on_the_card(cuda_device):
    """The committed flagship through ``-n``'s loader on the card: the
    weights equal the export bit for bit, and the habit net's edge policy
    sorts squares left and the others right."""
    from pathlib import Path

    from deep_active_inference_mc_torch.apps import sweep as sweep_app
    from deep_active_inference_mc_torch.train import evaluate
    from deep_active_inference_mc_torch.utils import convert

    flagship = Path(__file__).resolve().parent.parent / "artifacts" / "run512" / "checkpoints"
    agent = sweep_app.build_agent(Config(), str(flagship), cuda_device)
    want = convert.load_export(flagship / ckpt.EXPORT_FILE)["agent"]
    assert all(torch.equal(v.cpu(), want[k]) for k, v in agent.state_dict().items())
    left, right = evaluate.habit_edge_policy(agent, traster.build_sprite_lut(cuda_device))
    assert left[0] > 2 * right[0] + 1e-3 and right[0] < 0.08
    assert all(right[c] > 2 * left[c] + 1e-3 and left[c] < 0.08 for c in (1, 2))


@pytest.mark.cuda
def test_bench_env_steps_launches_k1_once_per_step(cuda_device):
    """``bench.bench_env_steps`` at 4096 envs, 4 steps and 1 timed run
    after the warm-up: K1 launches once per step, 8 times."""
    import math

    from deep_active_inference_mc_torch import bench

    lut = traster.build_sprite_lut(cuda_device)
    LAUNCHES.clear()
    rate = bench.bench_env_steps(lut, batch=4096, iters=4, reps=1)
    assert LAUNCHES["render"] == 8
    assert math.isfinite(rate) and rate > 0
