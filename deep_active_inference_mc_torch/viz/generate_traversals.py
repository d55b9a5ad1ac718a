"""Latent traversal grid + disentanglement panels.

The port's own copy of ``deep_active_inference_mc_tpu/viz/generate_traversals.py``.
Per latent dimension: a decoder sweep between histogram-derived bounds, the
sample histogram, and Spearman-correlation / mutual-information curves of
that latent against the 6 ground-truth factors [shape, scale, orientation,
posX, posY, reward]. matplotlib, scipy and scikit-learn are imported at the
first figure.
"""

from __future__ import annotations

import numpy as np

from deep_active_inference_mc_torch.viz import pyplot

FACTOR_LABELS = ["shape", "scale", "orientation", "posX", "posY", "reward"]


def generate_traversals(
    decode_fn,
    s_dim,
    s_sample,
    S_real,
    filenames=(),
    naive=False,
    colour=False,
    elements=10,
):
    """Args:
    decode_fn: callable (N, s_dim) -> (N, H, W, C) decoded frames.
    s_sample: (N, s_dim) posterior samples from the eval batch.
    S_real: (N, 6) ground-truth factors (empty to skip correlation panels).
    """
    from matplotlib import gridspec
    from scipy.stats import spearmanr
    from sklearn.feature_selection import mutual_info_regression

    plt = pyplot()
    s_sample = np.asarray(s_sample)
    S_real = np.asarray(S_real)

    fig = plt.figure(figsize=(8, 10))
    gs = gridspec.GridSpec(s_dim, 3, width_ratios=[5, 1, 1])

    mode_val = np.zeros(s_dim)
    start_val = np.zeros(s_dim)
    end_val = np.zeros(s_dim)
    for i in range(s_dim):
        ax = plt.subplot(gs[i * 3 + 1])
        counts, edges, _ = ax.hist(s_sample[:, i])
        ax.set_xticks([])
        ax.set_yticks([])
        if naive:
            mode_val[i], start_val[i], end_val[i] = 0.0, -3.0, 3.0
        else:
            k = int(np.argmax(counts))
            mode_val[i] = (edges[k] + edges[k + 1]) / 2.0
            start_val[i] = (edges[0] + edges[1]) / 2.0
            end_val[i] = (edges[-2] + edges[-1]) / 2.0

    if len(S_real) > 0:
        corr = np.zeros((s_dim, 6))
        mi = np.zeros((s_dim, 6))
        for f in range(6):
            for i in range(s_dim):
                r, _ = spearmanr(s_sample[:, i], S_real[:, f])
                corr[i, f] = abs(r)
                mi[i, f] = mutual_info_regression(
                    s_sample[:, i].reshape(-1, 1), S_real[:, f]
                )[0]
        for i in range(s_dim):
            ax = plt.subplot(gs[i * 3 + 2])
            ax.plot(corr[i, 1:], label="|spearman|")
            ax.plot(mi[i], label="MI")
            if corr[i, 1:].max() < 0.5:
                ax.set_ylim(0.0, 0.5)
            ax.set_xticks(range(len(FACTOR_LABELS) - 1))
            if i == s_dim - 1:
                ax.set_xticklabels(FACTOR_LABELS[1:], rotation="vertical", fontsize=5)
            else:
                ax.set_xticklabels([])
            ax.tick_params(labelsize=5)

    for i in range(s_dim):
        ax = plt.subplot(gs[i * 3])
        s = np.tile(mode_val, (elements, 1)).astype(np.float32)
        s[:, i] = np.linspace(start_val[i], end_val[i], elements)
        imgs = np.asarray(decode_fn(s))
        if colour:
            strip = np.hstack(list(imgs[:, :, :, :3]))
            ax.imshow(strip, vmin=0, vmax=1)
        else:
            strip = np.hstack(list(imgs[:, :, :, 0]))
            ax.imshow(strip, cmap="gray", vmin=0, vmax=1)
        ax.set_ylabel(rf"$s_{{{i}}}$")
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_xlabel(
            f"{start_val[i]:.2f} <-- {mode_val[i]:.2f} --> {end_val[i]:.2f}",
            fontsize=6,
        )

    fig.set_tight_layout(True)
    for filename in filenames:
        plt.savefig(filename)
    plt.close(fig)
