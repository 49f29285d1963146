"""incubate.distributed of the PyTorch port (counterpart of
``paddle_tpu/incubate/distributed``): the Mixture-of-Experts layer."""
