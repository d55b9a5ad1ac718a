"""PyTorch + CUDA port of the deep active inference agent.

Mirrors the layout of ``deep_active_inference_mc_tpu`` (the JAX package,
which stays the reference): ``envs/`` (dynamic-dSprites env and renderer),
``models/`` and ``infer/`` (the three-layer agent and the EFE estimators),
``ops/`` (math and the hand-written CUDA kernels), ``train/`` (the batched
controller sweep) and ``apps/`` (CLIs). It imports no JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises.
"""
