"""Runnable drivers mirroring the reference examples, on the PyTorch port:
``python -m krylovfspssa_tpu_torch.examples.<name>``."""
