"""PyTorch port: the CPU side of the encoder's conv kernel
(``ops/cuda/conv.py``).

The plain version (the frames in, the NHWC flatten out) and each launch's
plain function against the encoder's NCHW chain, the route predicate that
the encoder shares with the decoder, ``Encoder.forward``'s kernel route run
on the CPU through the plain version, the TF32 model against the kernel's
arithmetic emulated in float32 (and against three planted faults), and the
wrapper's refusals. The kernel itself is held against the model in
tests/test_torch_cuda.py."""

import contextlib
import copy

import pytest
import torch
import torch.nn.functional as F

from deep_active_inference_mc_torch.models import networks
from deep_active_inference_mc_torch.ops import cuda as cuda_ops
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES, conv, deconv

SPECS = [(64, 1), (64, 3), (32, 1), (32, 3)]  # (resolution, colour channels)


def make_encoder(resolution: int, colours: int, seed: int) -> networks.Encoder:
    """A seeded encoder with nonzero biases, so the fused bias is exercised."""
    g = torch.Generator().manual_seed(seed)
    enc = networks.Encoder(colour_channels=colours, resolution=resolution)
    networks.he_uniform_init_(enc, g)
    with torch.no_grad():
        for p in enc.parameters():
            if p.dim() == 1:
                p.uniform_(-0.1, 0.1, generator=g)
    return enc


def make_frames(B: int, colours: int, resolution: int, seed: int) -> torch.Tensor:
    """Frames in [0, 1) with half their pixels 0, as sprites on a black field."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((B, colours, resolution, resolution), generator=g)
    return torch.where(torch.rand(x.shape, generator=g) < 0.5, 0.0, x)


def chain_flat(enc: networks.Encoder, o: torch.Tensor) -> torch.Tensor:
    """The encoder's convs as cuDNN's NCHW chain, then the NHWC flatten."""
    y = networks.conv_chain(enc.conv, o, enc.compute_dtype)
    return y.permute(0, 2, 3, 1).reshape(o.shape[0], -1)


@contextlib.contextmanager
def tf32_allowed(on: bool):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("resolution,colours", SPECS)
def test_plain_version_equals_the_encoder_chain(resolution, colours):
    """The frames in and the NHWC flatten out, bit for bit the encoder's
    NCHW chain; the three launches' plain functions chained give the same
    bits; the CPU dispatch takes it without a launch."""
    enc = make_encoder(resolution, colours, seed=resolution + colours)
    o = make_frames(5, colours, resolution, seed=1)
    with torch.no_grad():
        want = chain_flat(enc, o)
        before = LAUNCHES[conv.NAME]
        got = conv.encode_flat(o, enc.conv)
        x = o
        for stage in range(len(conv.STAGES)):
            x = conv.stage_plain(x, enc.conv, stage)
    assert LAUNCHES[conv.NAME] == before
    assert got.shape == (5, enc.fc[0].in_features) == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(x.reshape(5, -1), want, rtol=0, atol=0)


def test_stages_cover_each_layer_once():
    """The launches take the layers in order, each once, and each layer's
    output channels are the encoder's."""
    assert [i for stage in conv.STAGES for i in stage] == [0, 1, 2, 3]
    for resolution, colours in SPECS:
        enc = networks.Encoder(colour_channels=colours, resolution=resolution)
        assert tuple(layer.out_channels for layer in enc.conv) == conv.CHANNELS


@pytest.mark.parametrize("device,dtype,grad,tf32,want", [
    ("cuda", torch.float32, False, True, True),
    ("cpu", torch.float32, False, True, False),
    ("cuda", torch.bfloat16, False, True, False),
    ("cuda", torch.float32, True, True, False),
    ("cuda", torch.float32, False, False, False),
])
def test_route_predicate(device, dtype, grad, tf32, want):
    """The kernels only for a card, float32, no grad and TF32 on; cuDNN's
    chain for bf16, for autograd and with TF32 off."""
    with tf32_allowed(tf32), torch.set_grad_enabled(grad):
        assert cuda_ops.use_kernel(torch.device(device), dtype) is want
    if want:
        with tf32_allowed(True), torch.inference_mode():
            assert cuda_ops.use_kernel(device, dtype)


@pytest.mark.parametrize("route", [False, True])
def test_encoder_and_decoder_share_one_predicate(monkeypatch, route):
    """Both halves of the VAE ask ``ops.cuda.use_kernel``, so one answer
    routes both: forced on, the CPU runs both plain versions; forced off,
    neither is called."""
    vae = networks.VAE()
    calls = []
    monkeypatch.setattr(cuda_ops, "use_kernel", lambda device, dtype: calls.append(dtype) or route)
    seen = []
    real_enc, real_dec = conv.encode_flat, deconv.decode_frames
    monkeypatch.setattr(conv, "encode_flat", lambda o, layers: seen.append("conv") or
                        real_enc(o, layers))
    monkeypatch.setattr(deconv, "decode_frames", lambda x, layers: seen.append("deconv") or
                        real_dec(x, layers))
    with torch.no_grad():
        vae.encode(make_frames(2, 1, 64, seed=0))
        vae.decode(torch.zeros(2, 10))
    assert calls == [torch.float32, torch.float32]
    assert seen == (["conv", "deconv"] if route else [])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("resolution,colours", SPECS)
def test_encoder_kernel_route_equals_its_chain(monkeypatch, resolution, colours, masked):
    """Encoder.forward's kernel route (forced on here, so the CPU runs its
    plain version) gives the chain's mean and logvar bit for bit, and hands
    the kernel the frames as they came."""
    enc = make_encoder(resolution, colours, seed=7 * resolution + colours)
    g = torch.Generator().manual_seed(3)
    o = make_frames(4, colours, resolution, seed=3)
    masks = enc.draw_masks(4, g, "cpu") if masked else None
    with torch.no_grad():
        want = enc(o, masks)
        monkeypatch.setattr(cuda_ops, "use_kernel", lambda device, dtype: True)
        calls = []
        real = conv.encode_flat
        monkeypatch.setattr(conv, "encode_flat", lambda x, layers: calls.append(x) or
                            real(x, layers))
        got = enc(o, masks)
    assert len(calls) == 1 and torch.equal(calls[0], o) and calls[0].is_contiguous()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- the TF32 model ---------------------------------------------------------

def tf32_layers(enc: networks.Encoder):
    """The encoder's convs with the tensor-core layers' weights already in
    TF32, so that a float32 run on the CPU sums the kernel's operands."""
    layers = copy.deepcopy(enc.conv)
    with torch.no_grad():
        for layer in layers[1:]:
            layer.weight.copy_(deconv.tf32_round(layer.weight))
    return layers


def emulate_stage(x: torch.Tensor, layers, stage: int, pad=(0, 1, 0, 1)) -> torch.Tensor:
    """One launch's arithmetic in float32 on the CPU (exact products, FP32
    sums), each output rounded to TF32 where a tensor-core layer reads it;
    ``pad`` puts the SAME pad where the kernel is told to."""
    x = x if stage == 0 else x.permute(0, 3, 1, 2)
    for i in conv.STAGES[stage]:
        layer = layers[i]
        x = F.relu(F.conv2d(F.pad(x, pad), layer.weight, layer.bias, 2))
        if i < 3:
            x = deconv.tf32_round(x)
    return x.permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("fault", [None, "bf16", "tap", "leading_pad"])
@pytest.mark.parametrize("stage", range(3))
@pytest.mark.parametrize("resolution,colours", [(64, 1), (32, 3)])
def test_stage_tf32_bounds_the_fp32_stage_and_no_fault(resolution, colours, stage, fault):
    """Each launch's arithmetic emulated in float32 on the CPU lies within
    ``stage_tf32_share``'s bound of ``stage_tf32``, the launch in float64
    (with layer 1's written output carried as an interval into layer 2).
    The bound is tight enough to refuse bf16 operands, a dropped tap, and
    the SAME pad on the leading edge instead of the trailing one."""
    enc = make_encoder(resolution, colours, seed=resolution + stage)
    layers = tf32_layers(enc)
    x = make_frames(2, colours, resolution, seed=stage)
    with torch.no_grad():
        for s in range(stage):  # the stage's own input: the launches before it, emulated
            x = emulate_stage(x, layers, s)
        faulty, y, pad = copy.deepcopy(layers), x, (0, 1, 0, 1)
        if fault == "bf16":
            y = x.bfloat16().float()
            for layer in faulty:
                layer.weight.copy_(layer.weight.bfloat16().float())
        elif fault == "tap":
            for i in conv.STAGES[stage]:
                faulty[i].weight[:, :, 0, 0] = 0
        elif fault == "leading_pad":
            pad = (1, 0, 1, 0)
        out = emulate_stage(y, faulty, stage, pad)
        share = conv.stage_tf32_share(out, x, layers, stage)
    assert (float(share.max()) <= 1.0) == (fault is None), float(share.max())


@pytest.mark.parametrize("resolution,colours", SPECS)
def test_layer_tf32_is_the_layer_in_float64(resolution, colours):
    """``layer_tf32``'s value is the plain layer in float64 on the kernel's
    operands (FP32 weights in layer 1, TF32 in the others), and its bound
    is FP32 summation's: ``FMA_ACCUMULATION`` in layer 1, ``ACCUMULATION``
    in the tensor-core layers, of sum |x| |w| + |bias|."""
    enc = make_encoder(resolution, colours, seed=3 * resolution + colours)
    x = make_frames(2, colours, resolution, seed=4).permute(0, 2, 3, 1)
    with torch.no_grad():
        for i, layer in enumerate(enc.conv):
            value, bound = conv.layer_tf32(x, layer, first=i == 0)
            w = (layer.weight if i == 0 else deconv.tf32_round(layer.weight)).double()
            xc = x.double().permute(0, 3, 1, 2)
            want = F.relu(F.conv2d(F.pad(xc, (0, 1, 0, 1)), w, layer.bias.double(), 2))
            torch.testing.assert_close(value, want.permute(0, 2, 3, 1), rtol=1e-12, atol=1e-12)
            share = conv.FMA_ACCUMULATION if i == 0 else deconv.ACCUMULATION
            s = F.conv2d(F.pad(xc.abs(), (0, 1, 0, 1)), w.abs(), layer.bias.double().abs(), 2)
            torch.testing.assert_close(bound, share * s.permute(0, 2, 3, 1), rtol=1e-12, atol=0)
            x = deconv.tf32_round(value.float())


@pytest.mark.parametrize("fault", [None, "tap", "leading_pad"])
@pytest.mark.parametrize("resolution,colours", SPECS)
def test_encode_tf32_bounds_the_fp32_encoder(resolution, colours, fault):
    """The four layers emulated in float32, launch after launch, give a
    flatten within ``encode_tf32``'s bound, and a dropped tap of layer 3 or
    the pad on the leading edge in layer 4 lands outside it. The bound
    carries every TF32 rounding that FP32 summation's worst case may tip,
    layer after layer, so it is wider than bf16 operands' error (2^-9 a
    product): ``stage_tf32`` refuses those launch by launch."""
    enc = make_encoder(resolution, colours, seed=11 * resolution + colours)
    layers = tf32_layers(enc)
    o = make_frames(3, colours, resolution, seed=5)
    with torch.no_grad():
        value, bound = conv.encode_tf32(o, layers)
        faulty, pad = copy.deepcopy(layers), (0, 1, 0, 1)
        x = o
        for stage in range(len(conv.STAGES)):
            if fault == "tap" and stage == 1:
                faulty[2].weight[:, :, 1, 1] = 0
            x = emulate_stage(x, faulty, stage, (1, 0, 1, 0) if fault == "leading_pad"
                              and stage == 2 else pad)
        share = conv.tf32_share(x.reshape(3, -1), value, bound, rounded=False)
    assert (float(share.max()) <= 1.0) == (fault is None), float(share.max())


# ---- the wrapper's refusals -------------------------------------------------

@pytest.mark.parametrize("case", ["cpu", "strided", "float64", "resolution", "colours",
                                  "square", "weights"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(case):
    """``encode_flat_cuda`` raises before any launch on CPU tensors, strided
    or float64 frames, shapes no instantiation covers and weights not as
    the encoder holds them; it never falls back to the plain version."""
    enc = make_encoder(64, 1, seed=0)
    o = make_frames(2, 1, 64, seed=0)
    layers = enc.conv
    if case == "strided":
        o = make_frames(2, 1, 128, seed=0)[:, :, ::2, ::2]
    elif case == "float64":
        o = o.double()
    elif case == "resolution":
        o = make_frames(2, 1, 48, seed=0)
    elif case == "colours":
        o = make_frames(2, 2, 64, seed=0)
    elif case == "square":
        o = o[:, :, :32].contiguous()
    elif case == "weights":
        layers = copy.deepcopy(enc.conv)
        layers[2].weight = torch.nn.Parameter(layers[2].weight.double())
    before = LAUNCHES[conv.NAME]
    with pytest.raises(ValueError):
        conv.encode_flat_cuda(o, layers)
    assert LAUNCHES[conv.NAME] == before
