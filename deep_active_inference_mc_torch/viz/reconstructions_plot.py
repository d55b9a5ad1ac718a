"""3-row reconstruction strip: o0 / o1 / imagined-or-reconstructed o1 for
the first 7 samples (NHWC numpy arrays). The port's own copy of
``deep_active_inference_mc_tpu/viz/reconstructions_plot.py``; matplotlib is
imported at the first figure."""

from __future__ import annotations

import numpy as np

from deep_active_inference_mc_torch.viz import pyplot


def reconstructions_plot(o0, o1, po1, filename, colour=False):
    plt = pyplot()
    o0, o1, po1 = (np.asarray(x) for x in (o0, o1, po1))
    if colour:
        rows = [o0[:7], o1[:7], po1[:7]]
    else:
        rows = [o0[:7, :, :, 0], o1[:7, :, :, 0], po1[:7, :, :, 0]]
    fig = plt.figure(figsize=(10, 5))
    for i, (row, label) in enumerate(zip(rows, ["o0", "o1", "o1 reconstr"])):
        ax = plt.subplot(3, 1, i + 1)
        img = np.hstack(list(row))
        if colour:
            ax.imshow(img, vmin=0, vmax=1)
        else:
            ax.imshow(img, cmap="gray", vmin=0, vmax=1)
        ax.set_ylabel(label)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.set_tight_layout(True)
    plt.savefig(filename)
    plt.close(fig)
