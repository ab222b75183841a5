"""training of the PyTorch port (see srgan_tpu_torch/__init__.py)."""
