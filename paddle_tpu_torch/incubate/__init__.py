"""incubate of the PyTorch port (counterpart of ``paddle_tpu/incubate``):
the fused transformer layers of ``incubate.nn``."""
