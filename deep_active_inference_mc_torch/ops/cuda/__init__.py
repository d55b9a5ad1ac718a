"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``LAUNCHES`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that its
main path went through the kernels.
"""

import collections

LAUNCHES: collections.Counter = collections.Counter()

# Kernel names; each has a ``<name>.cu`` source and a ``<name>.py`` wrapper.
KERNELS = ("render",)
