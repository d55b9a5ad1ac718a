"""15-panel training dashboard and the behavioural dashboard.

The port's own copy of ``deep_active_inference_mc_tpu/viz/stats_plot.py``:
the per-epoch stats series (lists of floats and numpy arrays) to PNG + SVG,
with the published pixel-NLL quality guide lines (acceptable 80 nats,
perfect 60 nats). matplotlib is imported at the first figure.
"""

from __future__ import annotations

import numpy as np

from deep_active_inference_mc_torch.viz import pyplot

NLL_ACCEPTABLE = 80.0
NLL_PERFECT = 60.0


def stats_plot(stats, filename):
    plt = pyplot()
    fig = plt.figure(figsize=(14, 12))

    def logpanel(i, ylabel):
        ax = plt.subplot(4, 4, i)
        ax.set_yscale("log")
        ax.set_ylabel(ylabel)
        ax.grid(True)
        return ax

    ax = logpanel(1, "F")
    ax.plot(np.asarray(stats["kl_div_s"]) + np.asarray(stats["mse_o"]), "k", label="F")
    ax.plot(np.asarray(stats["F"]), "k--", label="F (weighted)")
    ax.legend()

    for i, key in ((2, "F_top"), (3, "F_mid"), (4, "F_down")):
        logpanel(i, key).plot(np.asarray(stats[key]), "k--", label=key)

    logpanel(5, "KL(s)").plot(stats["kl_div_s"], "r", label="kl_s")

    for i, key in ((6, "kl_div_s_anal"), (7, "kl_div_s_naive_anal")):
        ax = plt.subplot(4, 4, i)
        ax.set_ylabel("KL s dims" if i == 6 else "KL s (naive) dims")
        ax.set_xlabel("epochs")
        if stats[key]:
            arr = np.asarray(stats[key])
            for d in range(arr.shape[1]):
                ax.plot(arr[:, d], label=str(d) if d < 10 else None)
            ax.legend(fontsize=5)

    ax = logpanel(8, "Variables")
    for name in ["a", "b", "c", "beta_s", "gamma"]:
        ax.plot(np.asarray(stats["var_" + name]), label=name)
    ax.set_xlabel("epochs")
    ax.legend(fontsize=6)

    ax = logpanel(9, "KL(pi)")
    ax.plot(stats["kl_div_pi"], "y", label="kl_pi (eval, one-hot pinned)")
    if stats.get("kl_div_pi_train"):
        # Align resumed-from-old-checkpoint series with the epoch axis: a
        # padded/short series starts at its resume epoch, not x=0.
        kt = stats["kl_div_pi_train"]
        off = max(len(stats["kl_div_pi"]) - len(kt), 0)
        ax.plot(range(off, off + len(kt)), kt, "m",
                label="kl_pi (train targets)")
        n = max(len(stats["kl_div_pi"]), 1)
        b = stats["var_b"][-1] if stats.get("var_b") else 25.0
        ax.plot([0, n], [b] * 2, "k--", lw=0.8, label="omega midpoint b")
    ax.legend(fontsize=5)

    ax = plt.subplot(4, 4, 10)
    ax.set_ylabel("KL pi dims")
    ax.set_xlabel("epochs")
    if stats["kl_div_pi_anal"]:
        arr = np.asarray(stats["kl_div_pi_anal"])
        for d in range(arr.shape[1]):
            ax.plot(arr[:, d], label=str(d))
        ax.legend(fontsize=6)

    ax = logpanel(11, "nats")
    ax.plot(stats["mse_o"], "k", label="H(o,P(o))")
    n = max(len(stats["mse_o"]), 1)
    ax.plot([0, n], [NLL_ACCEPTABLE] * 2, "r--", label="acceptable")
    ax.plot([0, n], [NLL_PERFECT] * 2, "g", label="perfect")
    ax.legend(fontsize=6)

    ax = logpanel(12, "MSE_r")
    ax.plot(stats["mse_r"])
    ax.set_xlabel("iterations(x1000)")

    ax = logpanel(13, "Total correlation")
    ax.plot(stats["TC"], "k")
    ax.set_xlabel("epochs")

    if stats.get("deep_mse_o"):
        ax = logpanel(14, "Deep reconstructions")
        ax.plot(stats["deep_mse_o"], "r", label="mse visual")
        ax.legend(fontsize=6)
    else:  # empty series: linear axis avoids the log-autoscale warning
        ax = plt.subplot(4, 4, 14)
        ax.set_ylabel("Deep reconstructions")
        ax.grid(True)
    ax.set_xlabel("epochs")

    ax = logpanel(15, "omega")
    om = np.asarray(stats["omega"])
    om_std = np.asarray(stats["omega_std"])
    ax.plot(om, "b", label="omega")
    if len(om) == len(om_std):
        ax.plot(om + om_std, "b--")
        ax.plot(om - om_std, "b--")

    # Panel 16 (free slot in the reference's 4x4 grid): the behavioral
    # learning curve — per-epoch paired sweep scores vs the constant
    # random baseline.
    if stats.get("train_scores_m"):
        ax = plt.subplot(4, 4, 16)
        ax.set_ylabel("sweep score")
        ax.set_xlabel("epochs")
        ax.grid(True)
        m = np.asarray(stats["train_scores_m"])
        sem = np.asarray(stats.get("train_scores_sem", np.zeros_like(m)))
        x = np.arange(len(m))
        ax.plot(x, m, "b", lw=0.8, label="ai")
        if len(sem) == len(m):
            ax.fill_between(x, m - sem, m + sem, color="b", alpha=0.2)
        hm = np.asarray(stats.get("train_scores_habit_m", []))
        if len(hm):
            ax.plot(np.arange(len(m) - len(hm), len(m)), hm, "g", lw=0.8,
                    label="habit")
        rb = stats.get("train_scores_random")
        if rb:
            ax.axhline(rb[-1], color="k", ls="--", lw=0.8, label="random")
        ax.legend(fontsize=5)

    fig.set_tight_layout(True)
    plt.savefig(str(filename) + ".png")
    plt.savefig(str(filename) + ".svg")
    plt.close(fig)


def behavior_plot(stats, filename):
    """Round-3 behavioral dashboard: paired sweep scores, per-shape score
    and event splits, and the scoring-edge discrimination probes — the
    instrumentation for the shape->side skill bottleneck."""
    plt = pyplot()
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    n = len(stats.get("train_scores_m", []))

    def offx(series):
        return np.arange(n - len(series), n)

    ax = axes[0, 0]
    m = np.asarray(stats.get("train_scores_m", []))
    sem = np.asarray(stats.get("train_scores_sem", []))
    ax.plot(np.arange(n), m, "b", lw=0.9, label="ai")
    if len(sem) == n:
        ax.fill_between(np.arange(n), m - sem, m + sem, color="b", alpha=0.2)
    hm = np.asarray(stats.get("train_scores_habit_m", []))
    hs = np.asarray(stats.get("train_scores_habit_sem", []))
    if len(hm):
        ax.plot(offx(hm), hm, "g", lw=0.9, label="habit")
        if len(hs) == len(hm):
            ax.fill_between(offx(hm), hm - hs, hm + hs, color="g", alpha=0.2)
    rb = stats.get("train_scores_random", [])
    if rb:
        ax.axhline(rb[-1], color="k", ls="--", lw=0.8, label="random")
    eb = stats.get("train_scores_expert", [])
    if eb:
        ax.set_title(f"sweep score (expert = {eb[-1]:+.2f})", fontsize=9)
    ax.set_ylabel("score (paired sweep)")
    ax.legend(fontsize=7)
    ax.grid(True)

    ax = axes[0, 1]
    for key, c, lbl in (("train_scores_sq", "tab:orange", "squares"),
                        ("train_scores_other", "tab:purple", "ellipse/heart")):
        s = np.asarray(stats.get(key, []))
        if len(s):
            ax.plot(offx(s), s, color=c, lw=0.9, label=lbl)
    ax.axhline(0.0, color="k", lw=0.5)
    ax.set_ylabel("score contribution by class")
    ax.legend(fontsize=7)
    ax.grid(True)

    ax = axes[1, 0]
    for key, c, lbl in (("train_events_sq", "tab:orange", "squares"),
                        ("train_events_other", "tab:purple", "ellipse/heart")):
        s = np.asarray(stats.get(key, []))
        if len(s):
            ax.plot(offx(s), s, color=c, lw=0.9, label=lbl)
    ax.set_ylabel("scoring events by class")
    ax.set_xlabel("epochs")
    ax.legend(fontsize=7)
    ax.grid(True)

    ax = axes[1, 1]
    for key, c, lbl in (("edge_habit_correct", "g", "habit P(up|correct)"),
                        ("edge_habit_wrong", "g", None),
                        ("edge_g_correct", "b", "softmax(-G/T) P(up|correct)"),
                        ("edge_g_wrong", "b", None)):
        s = np.asarray(stats.get(key, []))
        if len(s):
            style = "-" if "correct" in key else "--"
            ax.plot(offx(s), s, style, color=c, lw=0.9, label=lbl)
    ax.axhline(0.25, color="k", ls=":", lw=0.8, label="uniform")
    ax.set_ylabel("P(up) at scoring edge (-- wrong side)")
    ax.set_xlabel("epochs")
    gap = np.asarray(stats.get("edge_g_gap_nats", []))
    if len(gap):
        ax2 = ax.twinx()
        ax2.plot(offx(gap), gap, color="tab:red", lw=0.8, alpha=0.7)
        # Per-class correct-side G gaps: the shape->side discrimination
        # series (both must go positive for true sorting).
        for key, c in (("edge_g_sq_gap_nats", "tab:orange"),
                       ("edge_g_oth_gap_nats", "tab:purple")):
            g = np.asarray(stats.get(key, []))
            if len(g):
                ax2.plot(offx(g), g, color=c, lw=0.6, alpha=0.5)
        ax2.axhline(0.0, color="tab:red", lw=0.4, alpha=0.4)
        ax2.set_ylabel("G gap (nats; red=all, orange=sq, purple=oth)",
                       color="tab:red", fontsize=8)
    ax.legend(fontsize=7)
    ax.grid(True)

    # Grad-norm observability: per-layer last-round norms (solid) and
    # epoch-worst (dashed) on a log axis — loss spikes
    # localize to the layer whose _max series jumps.
    ax = axes[0, 2]
    for key, c in (("gnorm_top", "tab:blue"), ("gnorm_mid", "tab:green"),
                   ("gnorm_down", "tab:red")):
        s = np.asarray(stats.get(key, []))
        mx = np.asarray(stats.get(key + "_max", []))
        if len(s):
            ax.plot(offx(s), s, color=c, lw=0.8, label=key[6:])
        if len(mx):
            ax.plot(offx(mx), mx, color=c, lw=0.6, ls="--", alpha=0.6)
    ax.set_yscale("log")
    ax.set_ylabel("grad global norm (-- epoch max)")
    ax.legend(fontsize=7)
    ax.grid(True)

    # MCTS-visit distillation phases (train/distill.py): KL to the visit
    # targets before/after each phase and the argmax agreement. Zeros =
    # epochs without a phase; plot only the fired ones.
    ax = axes[1, 2]
    kf = np.asarray(stats.get("distill_kl_first", []))
    if len(kf) and np.any(kf != 0.0):
        x_all = offx(kf)
        fired = kf != 0.0
        kl = np.asarray(stats.get("distill_kl_last", []))
        mf = np.asarray(stats.get("distill_match_first", []))
        ml = np.asarray(stats.get("distill_match_last", []))
        ax.plot(x_all[fired], kf[fired], "o-", color="tab:red", lw=0.8,
                ms=2, label="KL pre")
        ax.plot(x_all[fired], kl[fired], "o-", color="tab:blue", lw=0.8,
                ms=2, label="KL post")
        ax2 = ax.twinx()
        ax2.plot(x_all[fired], mf[fired], color="tab:gray", lw=0.6,
                 alpha=0.6)
        ax2.plot(x_all[fired], ml[fired], color="k", lw=0.6, alpha=0.8)
        ax2.set_ylabel("argmax match (gray=pre, black=post)", fontsize=8)
        ax2.set_ylim(0, 1)
        ax.set_ylabel("KL[habit || MCTS visits]")
        ax.legend(fontsize=7)
    else:
        ax.set_axis_off()
        ax.text(0.5, 0.5, "no distill phases", ha="center", va="center",
                color="gray", fontsize=9)
    ax.set_xlabel("epochs")
    ax.grid(True)

    fig.set_tight_layout(True)
    plt.savefig(str(filename) + ".png")
    plt.close(fig)
