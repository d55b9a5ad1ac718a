"""PyTorch port: the hand-written CUDA kernels (K1, the decoder's
transposed convs and the encoder's convs) against their plain PyTorch
versions on a card, and the training round, the checkpoint, the MCTS
sweeps, the distillation replay, the demo, the causal round and the
benchmark's env steps on a card.
Marked ``cuda``; without a card they skip. The file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import argparse
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_active_inference_mc_torch.apps import demo as demo_app
from deep_active_inference_mc_torch.config import Config
from deep_active_inference_mc_torch.envs import dsprites as tenv
from deep_active_inference_mc_torch.envs import raster as traster
from deep_active_inference_mc_torch.models import networks
from deep_active_inference_mc_torch.ops import cuda as cuda_ops
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES
from deep_active_inference_mc_torch.ops.cuda import conv as k_conv
from deep_active_inference_mc_torch.ops.cuda import deconv as k_deconv
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
                                                n_macro_steps=2, mcts_params=p)
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


# ---- the decoder's transposed convs (ops/cuda/deconv.py) --------------------

DECONV_LAUNCHES = 4  # per decode: one per layer


def deconv_decoder(resolution, colours, device, seed=0) -> networks.Decoder:
    """A seeded decoder with nonzero biases on ``device``."""
    g = torch.Generator().manual_seed(seed)
    dec = networks.Decoder(colour_channels=colours, resolution=resolution)
    networks.he_uniform_init_(dec, g)
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 1:
                p.uniform_(-0.1, 0.1, generator=g)
    return dec.to(device)


def deconv_layer_input(i, B, width, cin, device, seed):
    """A layer's NHWC input: the first layer's before the dense ReLU (half
    negative); the others after a ReLU and in TF32, as the layer before
    writes them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, width, width, cin), generator=g)
    return (x if i == 0 else k_deconv.tf32_round(F.relu(x))).to(device)


DECONV_CASES = [(B, res, c) for B in (1, 33, 512) for res, c in
                ((64, 1), (64, 3), (32, 1), (32, 3))] + [(4096, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,resolution,colours", DECONV_CASES)
def test_deconv_kernel_layers_match_plain(cuda_device, B, resolution, colours):
    """Each layer's launch against ``layer_tf32``, that layer in float64
    with the kernel's TF32 operands: beyond the half TF32 unit of its own
    output rounding, within FP32 summation's bound (``layer_tf32_share``).
    The whole stack's frame within ``FRAME_ATOL`` of ``decode_frames_tf32``.
    Both also near the plain version in float64, whose distance from the
    TF32 model is TF32's own error."""
    dec = deconv_decoder(resolution, colours, cuda_device, seed=B)
    layers = list(dec.deconv)
    layers64 = [copy.deepcopy(layer).double() for layer in layers]
    width = 16
    with torch.no_grad():
        for i, layer in enumerate(layers):
            first, last = i == 0, i == len(layers) - 1
            x = deconv_layer_input(i, B, width, layer.weight.shape[0], cuda_device, seed=B + i)
            before = LAUNCHES["deconv"]
            got = k_deconv.layer_cuda(x, layer, first, last)
            torch.cuda.synchronize()
            assert LAUNCHES["deconv"] == before + 1
            plain = k_deconv.layer_plain(x.double(), layers64[i], first, last)
            assert got.shape == plain.shape, (i, got.shape, plain.shape)
            share = k_deconv.layer_tf32_share(got, x, layer, first, last)
            assert float(share.max()) <= 1.0, (i, float(share.max()))
            assert float((got.double() - plain).abs().max()) < 2.0 ** -6 * float(plain.abs().max())
            width = got.shape[1]
        x = deconv_layer_input(0, B, 16, 64, cuda_device, seed=B + 10)
        got = k_deconv.decode_frames(x, layers)
        want = k_deconv.decode_frames_tf32(x, layers)
        plain = k_deconv.decode_frames_plain(x.double(), layers64)
    assert got.shape == (B, colours, resolution, resolution)
    assert float((got.double() - want).abs().max()) <= k_deconv.FRAME_ATOL
    assert float((got.double() - plain).abs().max()) <= 2.0 ** -8


@pytest.mark.cuda
def test_deconv_kernel_rows_are_independent(cuda_device):
    """A row decoded alone gives the bits it gets inside a 4096-row batch,
    and two runs give the same bits (no atomics, no split-K)."""
    dec = deconv_decoder(64, 1, cuda_device)
    x = deconv_layer_input(0, 4096, 16, 64, cuda_device, seed=5)
    with torch.no_grad():
        full = k_deconv.decode_frames(x, dec.deconv)
        assert torch.equal(full, k_deconv.decode_frames(x, dec.deconv))
        for i in (0, 1, 2047, 4095):
            alone = k_deconv.decode_frames(x[i:i + 1].contiguous(), dec.deconv)
            assert torch.equal(alone[0], full[i]), i
        assert torch.equal(k_deconv.decode_frames(x[:33].contiguous(), dec.deconv), full[:33])


@pytest.mark.cuda
def test_deconv_graphed_decode_equals_eager(cuda_device):
    """A decode captured in a CUDA graph and replayed on new input gives
    the eager launches' bits; the capture counts its launches once."""
    dec = deconv_decoder(64, 1, cuda_device)
    x = deconv_layer_input(0, 512, 16, 64, cuda_device, seed=1)
    x2 = deconv_layer_input(0, 512, 16, 64, cuda_device, seed=2)
    with torch.no_grad():
        k_deconv.decode_frames(x, dec.deconv)  # the first launch, outside any capture
        static = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k_deconv.decode_frames(static, dec.deconv)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = LAUNCHES["deconv"]
        with torch.cuda.graph(graph):
            out = k_deconv.decode_frames(static, dec.deconv)
        assert LAUNCHES["deconv"] == before + DECONV_LAUNCHES
        static.copy_(x2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k_deconv.decode_frames(x2, dec.deconv))
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k_deconv.decode_frames(x, dec.deconv))


@pytest.mark.cuda
def test_graphed_ai_sweep_launches_the_deconv_kernel_per_decode(cuda_device):
    """A graphed ai sweep decodes three times per macro step through the
    kernel: 12 launches a macro step, warm-up, capture and replays alike."""
    cfg = Config()
    agent = ActiveInferenceAgent().init(torch.Generator().manual_seed(0)).to(cuda_device)
    lut = traster.build_sprite_lut(cuda_device)
    before = LAUNCHES["deconv"]
    out = sweep_lib.run_sweep(agent, cfg, lut, seed=3, n_envs=64, n_macro_steps=4,
                              method="ai")
    assert LAUNCHES["deconv"] == before + 3 * DECONV_LAUNCHES * 4
    assert bool(torch.isfinite(out["scores"]).all())


@pytest.mark.cuda
def test_train_round_launches_the_deconv_kernel_from_the_generator(cuda_device):
    """A crn + gen_mean round: the generator's 4 action columns x 3 decodes
    go through the kernel (48 launches); the losses' decode, with its
    backward, does not."""
    cfg = Config(batch=64, crn=True, gen_mean=True, edge_frac=0.3)
    gen = seeded_generator(cuda_device, 0)
    state = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen, cuda_device)
    round_fn = train_loop.make_round_fn(cfg, traster.build_sprite_lut(cuda_device))
    before = LAUNCHES["deconv"]
    state, metrics = round_fn(state, gen)
    assert LAUNCHES["deconv"] == before + 4 * 3 * DECONV_LAUNCHES
    assert all(v.is_cuda and bool(torch.isfinite(v)) for v in metrics.values())


def _decoder_chain(dec, s):
    """The decoder through ``networks.deconv_chain``, cuDNN's NCHW chain:
    dense layers, transposed convs, the SAME crop, ReLU, sigmoid."""
    x = s
    for i in range(4):
        x = F.relu(dec.fc[i](x))
    x = x.reshape(x.shape[0], 16, 16, 64).permute(0, 3, 1, 2).contiguous()
    return networks.deconv_chain(dec.deconv, x, dec.compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grad", "bf16", "tf32_off"])
def test_other_decodes_keep_cudnn(cuda_device, case):
    """With autograd, in bf16 and with TF32 off the decoder launches no
    kernel of its own; under autograd its frame and gradients equal the
    chain it ran before (cuDNN deterministic, so the bits are stable)."""
    dec = deconv_decoder(64, 1, cuda_device)
    s = torch.randn((64, 10), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = case != "tf32_off"
    try:
        before = LAUNCHES["deconv"]
        if case == "grad":
            got = dec(s)
            grads = torch.autograd.grad(got.square().sum(), list(dec.parameters()))
            want = _decoder_chain(dec, s)
            want_grads = torch.autograd.grad(want.square().sum(), list(dec.parameters()))
            assert torch.equal(got, want)
            assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
        else:
            if case == "bf16":
                dec16 = networks.Decoder(dtype=torch.bfloat16).to(cuda_device)
                dec16.load_state_dict(dec.state_dict())
                dec = dec16
            with torch.no_grad():
                got = dec(s)
            assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
            if case == "tf32_off":
                with torch.no_grad():
                    assert torch.equal(got, _decoder_chain(dec, s))
        assert LAUNCHES["deconv"] == before
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved


# ---- the encoder's convs (ops/cuda/conv.py) ---------------------------------

CONV_LAUNCHES = len(k_conv.STAGES)  # per encode


def conv_encoder(resolution, colours, device, seed=0) -> networks.Encoder:
    """A seeded encoder with nonzero biases on ``device``."""
    g = torch.Generator().manual_seed(seed)
    enc = networks.Encoder(colour_channels=colours, resolution=resolution)
    networks.he_uniform_init_(enc, g)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 1:
                p.uniform_(-0.1, 0.1, generator=g)
    return enc.to(device)


def conv_frames(B, colours, resolution, device, seed):
    """Frames in [0, 1) with half their pixels 0, as sprites on a black field."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((B, colours, resolution, resolution), generator=g)
    return torch.where(torch.rand(x.shape, generator=g) < 0.5, 0.0, x).to(device)


CONV_CASES = [(B, res, c) for B in (1, 33, 512) for res, c in
              ((64, 1), (64, 3), (32, 1), (32, 3))] + [(4096, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,resolution,colours", CONV_CASES)
def test_conv_kernel_launches_match_the_model(cuda_device, B, resolution, colours):
    """Each launch on its own input (the launch before's output) against
    ``stage_tf32``, the launch in float64 with the kernel's operands:
    beyond the half TF32 unit of its own output rounding, within FP32
    summation's bound (``stage_tf32_share``); the flatten within
    ``encode_tf32``'s bound. Both also near the plain version in float64,
    whose distance from the model is TF32's own error."""
    enc = conv_encoder(resolution, colours, cuda_device, seed=B)
    layers64 = copy.deepcopy(enc.conv).double()
    o = conv_frames(B, colours, resolution, cuda_device, seed=B)
    with torch.no_grad():
        x = o
        for stage in range(CONV_LAUNCHES):
            before = LAUNCHES["conv"]
            got = k_conv.stage_cuda(x, enc.conv, stage)
            torch.cuda.synchronize()
            assert LAUNCHES["conv"] == before + 1
            plain = k_conv.stage_plain(x.double(), layers64, stage)
            assert got.shape == plain.shape, (stage, got.shape, plain.shape)
            share = k_conv.stage_tf32_share(got, x, enc.conv, stage)
            assert float(share.max()) <= 1.0, (stage, float(share.max()))
            assert float((got.double() - plain).abs().max()) < 2.0 ** -6 * float(plain.abs().max())
            x = got
        flat = k_conv.encode_flat(o, enc.conv)
        value, bound = k_conv.encode_tf32(o, enc.conv)
        plain = k_conv.encode_flat_plain(o.double(), layers64)
    assert torch.equal(flat, x.reshape(B, -1))
    assert float(k_conv.tf32_share(flat, value, bound, rounded=False).max()) <= 1.0
    assert float((flat.double() - plain).abs().max()) <= 2.0 ** -8


def _dense_interval(enc, value, bound):
    """The encoder's dense layers and heads in float64 on a flatten known
    to lie within ``bound`` of ``value``: (mean, logvar) and how far each
    may move (an interval through each ReLU, the clip and the heads)."""
    mid, half = value, bound
    for i in range(4):
        w, b = enc.fc[i].weight.double(), enc.fc[i].bias.double()
        mid, half = mid @ w.T + b, half @ w.abs().T
        if i < 3:
            lo, hi = F.relu(mid - half), F.relu(mid + half)
            mid, half = (lo + hi) / 2, (hi - lo) / 2
    mean, logvar = torch.chunk(mid, 2, dim=-1)
    h_mean, h_logvar = torch.chunk(half, 2, dim=-1)
    lo, hi = (torch.clamp(logvar + s * h_logvar, -networks.LOGVAR_CLIP, networks.LOGVAR_CLIP)
              for s in (-1, 1))
    return (mean, h_mean), ((lo + hi) / 2, (hi - lo) / 2)


# The FP32 dense layers' own error on the card, beyond the flatten's: their
# sums of 1024 and 256 products in float32 differ from float64 by a few
# 1e-6 at the heads' magnitudes (|mean|, |logvar| < 10).
CONV_HEAD_ATOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("resolution,colours", [(64, 1), (32, 3)])
def test_conv_encoder_heads_within_the_model(cuda_device, resolution, colours):
    """``Encoder.forward`` on the card takes the kernel (3 launches), and
    its mean and logvar lie within ``encode_tf32``'s bound carried through
    the dense layers in float64, plus ``CONV_HEAD_ATOL`` for the dense
    layers' own FP32 sums."""
    enc = conv_encoder(resolution, colours, cuda_device, seed=3)
    o = conv_frames(1024, colours, resolution, cuda_device, seed=4)
    with torch.no_grad():
        before = LAUNCHES["conv"]
        mean, logvar = enc(o)
        assert LAUNCHES["conv"] == before + CONV_LAUNCHES
        value, bound = k_conv.encode_tf32(o, enc.conv)
        (m, hm), (lv, hlv) = _dense_interval(enc, value, bound)
    assert float(((mean.double() - m).abs() - hm).max()) <= CONV_HEAD_ATOL
    assert float(((logvar.double() - lv).abs() - hlv).max()) <= CONV_HEAD_ATOL


@pytest.mark.cuda
def test_conv_kernel_rows_are_independent(cuda_device):
    """A row encoded alone, or among 256, gives the bits it gets inside a
    4096-row batch, and two runs give the same bits (no atomics, no
    split-K, no sum across frames)."""
    enc = conv_encoder(64, 1, cuda_device)
    o = conv_frames(4096, 1, 64, cuda_device, seed=5)
    with torch.no_grad():
        full = k_conv.encode_flat(o, enc.conv)
        assert torch.equal(full, k_conv.encode_flat(o, enc.conv))
        for i in (0, 1, 2047, 4095):
            alone = k_conv.encode_flat(o[i:i + 1].contiguous(), enc.conv)
            assert torch.equal(alone[0], full[i]), i
        assert torch.equal(k_conv.encode_flat(o[256:512].contiguous(), enc.conv), full[256:512])
    enc32 = conv_encoder(32, 3, cuda_device)
    o32 = conv_frames(257, 3, 32, cuda_device, seed=6)  # tiles of 4 frames, one part-filled
    with torch.no_grad():
        full = k_conv.encode_flat(o32, enc32.conv)
        for i in (0, 255, 256):
            assert torch.equal(k_conv.encode_flat(o32[i:i + 1].contiguous(), enc32.conv)[0],
                               full[i]), i


@pytest.mark.cuda
def test_conv_graphed_encode_equals_eager(cuda_device):
    """An encode captured in a CUDA graph and replayed on new frames gives
    the eager launches' bits; the capture counts its launches once."""
    enc = conv_encoder(64, 1, cuda_device)
    o = conv_frames(512, 1, 64, cuda_device, seed=1)
    o2 = conv_frames(512, 1, 64, cuda_device, seed=2)
    with torch.no_grad():
        k_conv.encode_flat(o, enc.conv)  # the first launch, outside any capture
        static = o.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k_conv.encode_flat(static, enc.conv)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = LAUNCHES["conv"]
        with torch.cuda.graph(graph):
            out = k_conv.encode_flat(static, enc.conv)
        assert LAUNCHES["conv"] == before + CONV_LAUNCHES
        static.copy_(o2)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k_conv.encode_flat(o2, enc.conv))
        static.copy_(o)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k_conv.encode_flat(o, enc.conv))


@pytest.mark.cuda
@pytest.mark.parametrize("method,encodes", [("habit", 1), ("ai", 2)])
def test_graphed_sweeps_launch_the_conv_kernel_per_encode(cuda_device, method, encodes):
    """A graphed sweep encodes through the kernel: the habit once a macro
    step (the frame), ai twice (the frame, and G's re-encode of its
    decode), warm-up, capture and replays alike."""
    cfg = Config()
    agent = ActiveInferenceAgent().init(torch.Generator().manual_seed(0)).to(cuda_device)
    lut = traster.build_sprite_lut(cuda_device)
    before = LAUNCHES["conv"]
    out = sweep_lib.run_sweep(agent, cfg, lut, seed=3, n_envs=64, n_macro_steps=4,
                              method=method)
    assert LAUNCHES["conv"] == before + encodes * CONV_LAUNCHES * 4
    assert bool(torch.isfinite(out["scores"]).all())


@pytest.mark.cuda
def test_train_round_launches_the_conv_kernel_without_autograd(cuda_device):
    """A crn + gen_mean round: the generator's 4 action columns x 2 encodes
    and the round's two no-grad encodes of o0 and o1 go through the kernel
    (30 launches); the losses' encodes, with their backward, do not."""
    cfg = Config(batch=64, crn=True, gen_mean=True, edge_frac=0.3)
    gen = seeded_generator(cuda_device, 0)
    state = train_loop.create_train_state(cfg, ActiveInferenceAgent(), gen, cuda_device)
    round_fn = train_loop.make_round_fn(cfg, traster.build_sprite_lut(cuda_device))
    before = LAUNCHES["conv"]
    state, metrics = round_fn(state, gen)
    assert LAUNCHES["conv"] == before + (4 * 2 + 2) * CONV_LAUNCHES
    assert all(v.is_cuda and bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cpu", "strided", "float64", "misshapen"])
def test_conv_kernel_refuses_what_it_does_not_take(cuda_device, case):
    """``encode_flat_cuda`` raises, and launches nothing, for frames on the
    CPU, strided, in float64 or of a shape no instantiation covers."""
    enc = conv_encoder(64, 1, cuda_device)
    o = conv_frames(8, 1, 64, cuda_device, seed=0)
    if case == "cpu":
        o, enc = o.cpu(), enc.cpu()
    elif case == "strided":
        o = conv_frames(8, 1, 128, cuda_device, seed=0)[:, :, ::2, ::2]
    elif case == "float64":
        o = o.double()
    else:
        o = conv_frames(8, 1, 48, cuda_device, seed=0)
    before = LAUNCHES["conv"]
    with pytest.raises(ValueError):
        k_conv.encode_flat_cuda(o, enc.conv)
    assert LAUNCHES["conv"] == before


def _encoder_chain(enc, o):
    """The encoder through ``networks.conv_chain``, cuDNN's NCHW chain."""
    x = networks.conv_chain(enc.conv, o, enc.compute_dtype)
    x = x.permute(0, 2, 3, 1).reshape(o.shape[0], -1)
    for i in range(3):
        x = F.relu(enc.fc[i](x))
    mean, logvar = torch.chunk(enc.fc[3](x).float(), 2, dim=-1)
    return mean, torch.clamp(logvar, -networks.LOGVAR_CLIP, networks.LOGVAR_CLIP)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grad", "bf16", "tf32_off"])
def test_other_encodes_keep_cudnn(cuda_device, case):
    """With autograd, in bf16 and with TF32 off the encoder launches no
    kernel of its own; under autograd and with TF32 off its heads equal the
    chain it ran before (cuDNN deterministic, so the bits are stable)."""
    enc = conv_encoder(64, 1, cuda_device)
    o = conv_frames(64, 1, 64, cuda_device, seed=0)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = case != "tf32_off"
    try:
        before = LAUNCHES["conv"]
        if case == "grad":
            got = enc(o)
            grads = torch.autograd.grad(sum(t.square().sum() for t in got), list(enc.parameters()))
            want = _encoder_chain(enc, o)
            want_grads = torch.autograd.grad(sum(t.square().sum() for t in want),
                                             list(enc.parameters()))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
        else:
            if case == "bf16":
                enc16 = networks.Encoder(dtype=torch.bfloat16).to(cuda_device)
                enc16.load_state_dict(enc.state_dict())
                enc = enc16
            with torch.no_grad():
                got = enc(o)
            assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in got)
            if case == "tf32_off":
                with torch.no_grad():
                    assert all(torch.equal(a, b) for a, b in zip(got, _encoder_chain(enc, o)))
        assert LAUNCHES["conv"] == before
        assert not cuda_ops.use_kernel(o.device, enc.compute_dtype)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved
