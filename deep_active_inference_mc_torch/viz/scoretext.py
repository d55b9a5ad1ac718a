"""Deterministic score-text overlay for demo recordings.

The port's own copy of ``deep_active_inference_mc_tpu/viz/scoretext.py``
(numpy only; a test holds ``paint_score`` and ``templates`` equal to the JAX
package's). The reference ships its behavioural ground truth as a demo
recording with the running score drawn into every frame, and
``scripts/gif_score.py`` decodes that overlay mechanically: white glyphs
(>= 220) inside frame rows 24:48 of the 500x500 recording, the first number
after x = 88, glyph bitmaps matched by exact equality. The demo's
``--record_ref`` mode paints the score with the pixel font below, which is
bit-deterministic, and the decoder matches against :func:`templates`, built
from the same tables.

Glyph geometry satisfies the decoder's invariants: glyphs live in frame
rows 26..40 (band rows 2..16 < 19), the number starts at x = 90 (> 88),
characters are separated by 3 blank columns (< the 12-column group gap),
and nothing else is painted within 12 columns after the number.
"""

from __future__ import annotations

import numpy as np

# 5x7 pixel font for the score readout. Strokes are 4-connected within
# every glyph (the decoder segments on blank columns and matches whole
# contiguous-column spans; a glyph that fell apart under thresholding
# would decode as None).
_FONT_5X7 = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00110", "01000", "10000", "11111"),
    "3": ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
    ".": ("00000", "00000", "00000", "00000", "00000", "01100", "01100"),
    "-": ("00000", "00000", "00000", "01110", "00000", "00000", "00000"),
    # Letters for the cosmetic "score:" prefix (ends before x=88, outside
    # the decoder's crop).
    "s": ("01111", "10000", "10000", "01110", "00001", "00001", "11110"),
    "c": ("01110", "10001", "10000", "10000", "10000", "10001", "01110"),
    "o": ("01110", "10001", "10001", "10001", "10001", "10001", "01110"),
    "r": ("10110", "11001", "10000", "10000", "10000", "10000", "10000"),
    "e": ("01110", "10001", "10001", "11111", "10000", "10001", "01110"),
    ":": ("00000", "01100", "01100", "00000", "01100", "01100", "00000"),
    " ": ("00000", "00000", "00000", "00000", "00000", "00000", "00000"),
}

SCALE = 2          # 5x7 -> 10x14 pixels
GAP = 3            # blank columns between glyphs
PITCH = 5 * SCALE + GAP
TEXT_ROW = 26      # glyph top row; 26..40 stays under band row 19
NUMBER_X = 90      # first number column (> the decoder's 88 crop)
PREFIX = "score:"
PREFIX_X = NUMBER_X - len(PREFIX) * PITCH  # 12; ink ends before x=88
# The decoder cuts the number at the first >= 12-blank-column gap and
# derives cleanliness from the cut span's width, so SOMETHING must follow
# the number (the reference prints a "(rate)" group; test_demo.py:221).
# The rate readout is painted RATE_GAP (>= 12) columns after the number.
RATE_GAP = 16


def _glyph(ch: str) -> np.ndarray:
    rows = _FONT_5X7[ch]
    g = np.array([[c == "1" for c in r] for r in rows], dtype=bool)
    return np.kron(g, np.ones((SCALE, SCALE), dtype=bool))


def templates() -> dict:
    """Decoder templates: 24-row band bitmaps (band = frame rows 24:48),
    one per character, exactly as painted by :func:`paint_score`."""
    out = {}
    for ch in "0123456789.-":
        g = _glyph(ch)
        band = np.zeros((24, g.shape[1]), dtype=np.uint8)
        band[TEXT_ROW - 24:TEXT_ROW - 24 + g.shape[0]] = g
        # Trim to the ink's column span (the decoder segments glyphs on
        # blank columns, so leading/trailing blanks never reach matching).
        cols = np.nonzero(band.sum(0))[0]
        out[ch] = band[:, cols[0]:cols[-1] + 1]
    return out


def format_score(value: float) -> str:
    """The reference overlay prints the raw float; scores are multiples of
    1/16 = 0.0625 (game_environment.py:123-134), so 4 decimals is exact."""
    return f"{value:.4f}".rstrip("0").rstrip(".") or "0"


def paint_score(
    frame: np.ndarray, value: float, rate: float = 0.0
) -> np.ndarray:
    """Paint ``score: <value>  <rate>`` in white into a (500, 500[, C])
    uint8 frame (in place) and return it. ``rate`` mirrors the reference
    overlay's parenthesized per-run rate (test_demo.py:221) and doubles as
    the group terminator the decoder's gap cut needs."""
    text = format_score(value)
    rate_x = NUMBER_X + len(text) * PITCH + RATE_GAP
    groups = (
        (PREFIX_X, PREFIX),
        (NUMBER_X, text),
        (rate_x, format_score(rate)),
    )
    for x0, s in groups:
        x = x0
        for ch in s:
            g = _glyph(ch)
            h, w = g.shape
            if x + w <= frame.shape[1]:
                region = frame[TEXT_ROW:TEXT_ROW + h, x:x + w]
                region[...] = np.where(
                    g[..., None] if region.ndim == 3 else g, 255, region
                )
            x += PITCH
    return frame
