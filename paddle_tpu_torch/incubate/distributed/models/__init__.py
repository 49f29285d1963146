"""incubate.distributed.models of the PyTorch port: ``moe``."""
