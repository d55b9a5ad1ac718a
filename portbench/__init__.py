"""The benchmark of the PyTorch and CUDA port, ``deep_active_inference_mc_torch``.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once on one card and prints one JSON line (``run.py``). What
belongs to one configuration, traffic mix or per-layer metric lives in files
of its own, found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``drivers/<driver>.py``, ``metrics/<metric>.py``.
``yardstick/`` holds the arithmetic the program may not move (traffic, FLOP
and byte counts, peaks, the trace's reduction) and ``reference/`` the plain
PyTorch reference that decides ``correct``.
"""
