"""Hand-written CUDA kernels for Hopper (``*.cu``) and ``_build``, which
compiles and loads them. Nothing here is compiled at import time."""
