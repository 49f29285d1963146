"""Utilities of the PyTorch port (counterpart of ``paddle_tpu/utils``):
``native``, the ctypes bindings of the native data path."""
