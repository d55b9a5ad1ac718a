"""PyTorch port: the CPU side of the decoder's transposed-conv kernel
(``ops/cuda/deconv.py``).

The plain version (NHWC in, frame out) against the decoder's NCHW chain,
the sub-pixel phase tables the kernel reads against ``conv_transpose2d`` and
the SAME crop, the route predicate, and ``Decoder.forward``'s kernel route
run on the CPU through the plain version. The kernel itself is held against
the plain version in tests/test_torch_cuda.py."""

import contextlib
import copy

import pytest
import torch
import torch.nn.functional as F

from deep_active_inference_mc_torch.models import networks
from deep_active_inference_mc_torch.ops import cuda as cuda_ops
from deep_active_inference_mc_torch.ops.cuda import LAUNCHES, deconv

SPECS = [(64, 1), (64, 3), (32, 1), (32, 3)]  # (resolution, colour channels)


def make_decoder(resolution: int, colours: int, seed: int) -> networks.Decoder:
    """A seeded decoder with nonzero biases, so the fused bias is exercised."""
    g = torch.Generator().manual_seed(seed)
    dec = networks.Decoder(colour_channels=colours, resolution=resolution)
    networks.he_uniform_init_(dec, g)
    with torch.no_grad():
        for p in dec.parameters():
            if p.dim() == 1:
                p.uniform_(-0.1, 0.1, generator=g)
    return dec


def dense_out(dec: networks.Decoder, s: torch.Tensor) -> torch.Tensor:
    """The last dense layer's output before its ReLU, as the kernel reads it."""
    x = s
    for i in range(3):
        x = F.relu(dec.fc[i](x))
    return dec.fc[3](x).reshape(s.shape[0], *deconv.DENSE_SHAPE)


@contextlib.contextmanager
def tf32_allowed(on: bool):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("resolution,colours", SPECS)
def test_plain_version_equals_the_decoder_chain(resolution, colours):
    """NHWC in and the frame out, bit for bit the decoder's NCHW chain, and
    the CPU dispatch takes it without a launch."""
    dec = make_decoder(resolution, colours, seed=resolution + colours)
    s = torch.randn(5, 10, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = dec(s)
        x = dense_out(dec, s)
        before = LAUNCHES[deconv.NAME]
        got = deconv.decode_frames(x, dec.deconv)
    assert LAUNCHES[deconv.NAME] == before
    assert got.shape == (5, colours, resolution, resolution)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(deconv.decode_frames_plain(x, dec.deconv), want, rtol=0, atol=0)


@pytest.mark.parametrize("stride,n,cin,cout", [
    (1, 16, 64, 64), (2, 16, 64, 64), (2, 32, 64, 32), (1, 32, 64, 32), (1, 64, 32, 3),
    (2, 5, 3, 2),
])
def test_phase_tables_equal_conv_transpose_and_crop(stride, n, cin, cout):
    """Each output phase summing only its taps, as the kernel does, gives
    the SAME transposed conv: conv_transpose2d (padding 1 at stride 1, 0 at
    stride 2) cropped to s n x s n."""
    g = torch.Generator().manual_seed(stride * 1000 + n)
    x = torch.randn(3, cin, n, n, generator=g, dtype=torch.float64)
    w = torch.randn(cin, cout, 3, 3, generator=g, dtype=torch.float64)
    want = F.conv_transpose2d(x, w, None, stride, 1 if stride == 1 else 0)
    want = want[..., : stride * n, : stride * n]
    torch.testing.assert_close(deconv.phase_conv_plain(x, w, stride), want,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("stride,taps_per_phase", [(1, [9]), (2, [4, 2, 2, 1])])
def test_packed_table_is_the_kernels_layout(stride, taps_per_phase):
    """The 50 int32 the kernel reads: phases in order, begin offsets, and
    every kernel position (ky, kx) once, which the kernel's weight load
    relies on."""
    packed = deconv.packed_taps(stride)
    assert len(packed) == 50
    n = packed[0]
    py, px, begin = packed[1:5], packed[5:9], packed[9:14]
    dy, dx, ky, kx = (packed[14 + 9 * i:23 + 9 * i] for i in range(4))
    ph = deconv.phases(stride)
    assert n == len(ph) == len(taps_per_phase)
    assert [len(t) for _, _, t in ph] == taps_per_phase
    for p, (qy, qx, taps) in enumerate(ph):
        assert (py[p], px[p]) == (qy, qx)
        assert list(zip(dy, dx, ky, kx))[begin[p]:begin[p + 1]] == taps
    assert begin[n] == 9 and sorted(zip(ky, kx)) == [(a, b) for a in range(3) for b in range(3)]


@pytest.mark.parametrize("device,dtype,grad,tf32,want", [
    ("cuda", torch.float32, False, True, True),
    ("cpu", torch.float32, False, True, False),
    ("cuda", torch.bfloat16, False, True, False),
    ("cuda", torch.float32, True, True, False),
    ("cuda", torch.float32, False, False, False),
])
def test_route_predicate(device, dtype, grad, tf32, want):
    """The kernel only for a card, float32, no grad and TF32 on; cuDNN's
    chain for bf16, for autograd and with TF32 off. The predicate is the
    one the encoder's kernel shares, ``ops.cuda.use_kernel``."""
    with tf32_allowed(tf32), torch.set_grad_enabled(grad):
        assert cuda_ops.use_kernel(torch.device(device), dtype) is want
    if want:
        with tf32_allowed(True), torch.inference_mode():
            assert cuda_ops.use_kernel(device, dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("resolution,colours", SPECS)
def test_decoder_kernel_route_equals_its_chain(monkeypatch, resolution, colours, masked):
    """Decoder.forward's kernel route (forced on here, so the CPU runs its
    plain version) gives the chain's frame bit for bit: the last dense
    ReLU moved after the dropout, into the kernel's load, changes nothing."""
    dec = make_decoder(resolution, colours, seed=7 * resolution + colours)
    g = torch.Generator().manual_seed(3)
    s = torch.randn(4, 10, generator=g)
    masks = dec.draw_masks(4, g, "cpu") if masked else None
    with torch.no_grad():
        want = dec(s, masks)
        monkeypatch.setattr(cuda_ops, "use_kernel", lambda device, dtype: True)
        calls = []
        real = deconv.decode_frames
        monkeypatch.setattr(deconv, "decode_frames", lambda x, layers: calls.append(x) or
                            real(x, layers))
        got = dec(s, masks)
    assert len(calls) == 1 and calls[0].shape == (4, *deconv.DENSE_SHAPE)
    assert bool((calls[0] < 0).any())  # the ReLU was left to the kernel
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_first_load_builds_every_kernel_together(monkeypatch):
    """Loading any kernel's library starts every missing build at once,
    so a checkout's first run waits for the longer nvcc and not for the
    sum; the load stays the ``k1.load`` span that ``load_s`` reads."""
    from deep_active_inference_mc_torch.ops.cuda import KERNELS, build
    from deep_active_inference_mc_torch.utils import profiling

    calls = []
    monkeypatch.setattr(build, "build", lambda names: calls.append(list(names)) or {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    before = profiling.totals().get("k1.load")
    assert build.load(deconv.NAME) == str(build.library_path(deconv.NAME))
    assert len(calls) == 1 and set(calls[0]) == set(KERNELS) == {"render", deconv.NAME, "conv"}
    after = profiling.totals()["k1.load"]
    assert after.count == (before.count if before else 0) + 1


def test_tf32_round_is_nearest_with_ties_away():
    """``tf32_round`` keeps 10 mantissa bits, rounding to nearest and ties
    away from zero (``cvt.rna``), and is idempotent."""
    u = 2.0 ** -10
    x = torch.tensor([1 + u / 2, 1 + u / 2 - 2.0 ** -23, 1 + 1.5 * u, 1 + u / 4, 3.0,
                      0.0], dtype=torch.float32)
    want = torch.tensor([1 + u, 1, 1 + 2 * u, 1, 3.0, 0.0], dtype=torch.float32)
    for sign in (1, -1):
        got = deconv.tf32_round(sign * x)
        torch.testing.assert_close(got, sign * want, rtol=0, atol=0)
        assert torch.equal(deconv.tf32_round(got), got)
        assert not bool((got.view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("fault", [None, "bf16", "tap"])
@pytest.mark.parametrize("i", range(4))
@pytest.mark.parametrize("resolution", [64, 32])
def test_layer_tf32_bounds_the_fp32_layer_and_no_fault(resolution, i, fault):
    """With operands already in TF32, the plain layer in float32 on the CPU
    (the kernel's arithmetic: exact products, FP32 sums), its output rounded
    to TF32 as the kernel rounds it, lies within ``layer_tf32_share``'s
    bound of ``layer_tf32``'s value, which is the plain layer in float64.
    The bound is tight enough to refuse bf16 operands and a dropped tap."""
    dec = make_decoder(resolution, 1, seed=resolution + i)
    layer = dec.deconv[i]
    first, last = i == 0, i == 3
    width = {64: (16, 16, 32, 64), 32: (16, 16, 32, 32)}[resolution][i]
    g = torch.Generator().manual_seed(i)
    x = torch.randn(2, width, width, layer.weight.shape[0], generator=g)
    with torch.no_grad():
        if not last:
            layer.weight.copy_(deconv.tf32_round(layer.weight))
        x = deconv.tf32_round(x if first else F.relu(x))
        value, _ = deconv.layer_tf32(x, layer, first, last)
        exact = deconv.layer_plain(x.double(), copy.deepcopy(layer).double(), first, last)
        torch.testing.assert_close(value, exact, rtol=1e-12, atol=1e-12)
        faulty = copy.deepcopy(layer)
        y = x
        if fault == "bf16":
            y = x.bfloat16().float()
            faulty.weight.copy_(layer.weight.bfloat16().float())
        elif fault == "tap":
            faulty.weight[:, :, 0, 0] = 0
        out = deconv.layer_plain(y, faulty, first, last)
        if not last:
            out = deconv.tf32_round(out)
        share = deconv.layer_tf32_share(out, x, layer, first, last)
    assert (float(share.max()) <= 1.0) == (fault is None), float(share.max())
