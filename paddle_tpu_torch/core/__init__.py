from .dtype import convert_dtype, dtype_name, numpy_to_torch  # noqa: F401
from .generator import (Generator, default_generator,  # noqa: F401
                        get_rng_state, seed, set_rng_state)
from .place import resolve_device  # noqa: F401
