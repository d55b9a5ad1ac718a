"""Tests of the benchmark harness. On the CPU they run each driver at a tiny
size; the tests marked ``cuda`` run on a card:
``python -m pytest --noconftest -m cuda portbench/tests``."""

import os

import torch

torch.set_num_threads(min(4, os.cpu_count() or 1))
