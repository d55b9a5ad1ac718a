"""Weight bridge: the JAX agent's Flax ``params`` -> the port's state_dict.

``params_from_jax`` takes the params tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), laid out as ``top/Dense_{0..2}``,
``mid/Dense_{0..3}``, ``down/encoder/{Conv_0..3, Dense_0..3}`` and
``down/decoder/{Dense_0..3, ConvTranspose_0..3}``. The conversions:

  - Dense kernel (in, out) -> Linear weight (out, in);
  - Conv kernel HWIO -> Conv2d weight OIHW;
  - ConvTranspose kernel HWIO -> ConvTranspose2d weight (in, out, kh, kw),
    spatially flipped: Flax's transposed conv does not flip its kernel,
    ``conv_transpose2d`` does.

``causal_params_from_jax`` does the same for the structural causal model
(``enc_convs_{0..2}``, ``enc_fc``, ``dec_fc``, ``dec_convs_{0,1}``,
``dec_out``), whose convs have kernel 4 at stride 2. The rules there, held
layer by layer against Flax in tests/test_torch_causal.py (float32, CPU):

  - stride-2 SAME Conv, kernel 4, even input = ``conv2d(stride=2,
    padding=1)`` with HWIO -> OIHW: max abs error <= 4.5e-6 (the
    asymmetric pad ``(2, 1, 2, 1)`` is off by 4.9-7.4);
  - stride-2 SAME ConvTranspose, kernel 4 = ``conv_transpose2d(stride=2,
    padding=1)`` with HWIO -> (in, out, kh, kw) and the kernel spatially
    flipped: max abs error <= 9.5e-7 (unflipped it is off by 2.8-5.0).

``load_npz`` reads a flat ``.npz`` keyed by the tree path
(``"down/decoder/Dense_3/kernel"``, ...); the README shows how to write one
from a JAX checkpoint.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _layers(node: dict, kind: str):
    """(index, leaf dict) of ``kind_0, kind_1, ...`` in index order."""
    idx = sorted(int(k.rsplit("_", 1)[1]) for k in node if k.rsplit("_", 1)[0] == kind)
    return [(i, node[f"{kind}_{i}"]) for i in idx]


def _conv(leaf) -> torch.Tensor:
    """Flax Conv kernel HWIO -> Conv2d weight OIHW."""
    return _t(np.transpose(leaf["kernel"], (3, 2, 0, 1)))


def _conv_transpose(leaf) -> torch.Tensor:
    """Flax ConvTranspose kernel HWIO -> ConvTranspose2d weight (in, out,
    kh, kw), spatially flipped."""
    return _t(np.transpose(leaf["kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1])


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """The port's ``ActiveInferenceAgent`` state_dict from Flax params."""
    sd: Dict[str, torch.Tensor] = {}

    def dense(prefix: str, node: dict) -> None:
        for i, leaf in _layers(node, "Dense"):
            sd[f"{prefix}.fc.{i}.weight"] = _t(np.asarray(leaf["kernel"]).T)
            sd[f"{prefix}.fc.{i}.bias"] = _t(leaf["bias"])

    dense("top", tree["top"])
    dense("mid", tree["mid"])
    enc, dec = tree["down"]["encoder"], tree["down"]["decoder"]
    dense("down.encoder", enc)
    for i, leaf in _layers(enc, "Conv"):
        sd[f"down.encoder.conv.{i}.weight"] = _conv(leaf)
        sd[f"down.encoder.conv.{i}.bias"] = _t(leaf["bias"])
    dense("down.decoder", dec)
    for i, leaf in _layers(dec, "ConvTranspose"):
        sd[f"down.decoder.deconv.{i}.weight"] = _conv_transpose(leaf)
        sd[f"down.decoder.deconv.{i}.bias"] = _t(leaf["bias"])
    return sd


def causal_params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """The port's ``StructuralCausalModel`` state_dict from Flax params."""
    sd: Dict[str, torch.Tensor] = {}
    for name, kind in (("enc_fc", "dense"), ("dec_fc", "dense"), ("enc_convs_0", "conv"),
                       ("enc_convs_1", "conv"), ("enc_convs_2", "conv"),
                       ("dec_convs_0", "deconv"), ("dec_convs_1", "deconv"),
                       ("dec_out", "deconv")):
        leaf = tree[name]
        target = {"dec_out": "dec_convs.2"}.get(name, name.replace("_convs_", "_convs."))
        if kind == "dense":
            sd[f"{target}.weight"] = _t(np.asarray(leaf["kernel"]).T)
        else:
            sd[f"{target}.weight"] = (_conv if kind == "conv" else _conv_transpose)(leaf)
        sd[f"{target}.bias"] = _t(leaf["bias"])
    return sd


def load_npz(path) -> Dict[str, torch.Tensor]:
    """State_dict from a flat ``.npz`` of the Flax params tree."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_jax(tree)
