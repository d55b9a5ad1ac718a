"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``LAUNCHES`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels.
"""

import collections

import torch

LAUNCHES: collections.Counter = collections.Counter()

# Kernel names; each has a ``<name>.cu`` source and a ``<name>.py`` wrapper.
KERNELS = ("render", "deconv", "conv")


def use_kernel(device, dtype) -> bool:
    """Whether an encode or a decode on ``device`` computing in ``dtype``
    takes the conv kernels (``conv``, ``deconv``): a card, float32, no
    autograd recording, cuDNN's TF32 allowed (the precision they compute
    in)."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and not torch.is_grad_enabled() and torch.backends.cudnn.allow_tf32)
