"""FLOPs of the agent's networks, counted from the configuration's widths.

A dense layer of ``i`` inputs and ``o`` outputs costs ``2*i*o`` per row; a
convolution ``2 * out pixels * Cin * Cout * k*k``; a transposed convolution
``2 * in pixels * Cin * Cout * k*k`` (every input pixel scatters a k x k
patch; the stride-2 layers' one cropped row and column included, as the
program computes them). These are the products
``torch.utils.flop_counter.FlopCounterMode`` counts; element-wise work is
not counted. Rows are what the program issues per unit of work."""

from __future__ import annotations

from typing import Dict


def _dense(widths) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def per_row(c: Dict) -> Dict[str, int]:
    """Forward FLOPs per row of each network of configuration ``c``."""
    s, a, ch, res = c["s_dim"], c["pi_dim"], c["colour_channels"], c["resolution"]
    enc_ch = [ch] + list(c["encoder_channels"])
    k = c["kernel"]
    enc, n = 0, res
    for cin, cout in zip(enc_ch[:-1], enc_ch[1:]):  # SAME, stride 2
        n = -(-n // 2)
        enc += 2 * n * n * cin * cout * k * k
    enc += _dense([n * n * enc_ch[-1]] + list(c["encoder_dense"]) + [2 * s])
    side, dch = c["decoder_grid"], c["decoder_grid_channels"]
    dec = _dense([s] + list(c["decoder_dense"]) + [side * side * dch])
    n, cin = side, dch
    for cout, stride in c["decoder_deconvs"]:
        dec += 2 * n * n * cin * cout * k * k
        n, cin = n * stride, cout
    trans = _dense([s + a] + [c["transition_hidden"]] * c["transition_layers"] + [2 * s])
    habit = _dense([s] + [c["habit_hidden"]] * c["habit_layers"] + [a])
    return {"encoder": enc, "decoder": dec, "transition": trans, "habit": habit}


def macro_step(c: Dict, method: str, envs: int) -> int:
    """FLOPs of one sweep macro step over ``envs`` envs. ``ai`` (one-step
    mean G over every action): the observation's encode (envs rows); per
    (env, action) row two transition passes, three decodes and the
    re-encode of the imagined frame. ``habit``: the encode and the habit
    net."""
    f, a = per_row(c), c["pi_dim"]
    if method == "ai":
        rows = envs * a
        return (envs * f["encoder"] + rows * (2 * f["transition"] + 3 * f["decoder"]
                                              + f["encoder"]))
    if method == "habit":
        return envs * (f["encoder"] + f["habit"])
    raise ValueError(f"no FLOP count for method {method!r}")


def _first_layer(c: Dict) -> Dict[str, int]:
    """Forward FLOPs per row of each network's first layer, whose input
    needs no gradient in training (its backward computes the weights'
    gradient only)."""
    s, a, k = c["s_dim"], c["pi_dim"], c["kernel"]
    n = -(-c["resolution"] // 2)
    return {"encoder": 2 * n * n * c["colour_channels"] * c["encoder_channels"][0] * k * k,
            "decoder": 2 * s * c["decoder_dense"][0],
            "transition": 2 * (s + a) * c["transition_hidden"],
            "habit": 2 * s * c["habit_hidden"]}


def train_round(c: Dict, batch: int) -> int:
    """FLOPs of one training round over ``batch`` envs (the flagship run's
    generator: common random numbers over the actions, the mean estimator,
    the habit mix): per action column the frame's encode and the mean G
    (two transition passes, three decodes, a re-encode); the habit mix's
    encode and habit net; the losses' encodes of o0 and o1, their habit,
    transition, encode and decode forwards; and their backwards: twice the
    forward of each trained network but its first layer's input gradient
    (F_top's habit too, whose gradient is computed when its update is
    withheld)."""
    f, first, a = per_row(c), _first_layer(c), c["pi_dim"]
    generator = a * (f["encoder"] + 2 * f["transition"] + 3 * f["decoder"] + f["encoder"])
    generator += f["encoder"] + f["habit"]
    forward = 2 * f["encoder"] + f["habit"] + f["transition"] + f["encoder"] + f["decoder"]
    backward = sum(2 * f[n] - first[n] for n in ("habit", "transition", "encoder"))
    backward += 2 * f["decoder"]
    return batch * (generator + forward + backward)
