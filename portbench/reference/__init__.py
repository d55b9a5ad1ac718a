"""The plain reference that decides ``correct``: float32 PyTorch with TF32
off, written from the published model and the JAX package's semantics (Flax
layouts, SAME padding), importing nothing of the port. It reads the raw
weights file itself and builds its own sprite table."""
