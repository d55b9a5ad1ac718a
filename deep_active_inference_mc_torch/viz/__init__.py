"""Figures and overlays of the port (numpy in, files out). matplotlib, scipy and
scikit-learn are imported inside the functions that draw, so the package imports
without them."""


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def nhwc(frames):
    """NCHW device frames (a tensor) -> the NHWC numpy array the figures take."""
    return frames.permute(0, 2, 3, 1).cpu().numpy()
