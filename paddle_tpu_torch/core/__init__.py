from .dtype import convert_dtype, dtype_name, numpy_to_torch  # noqa: F401
from .generator import Generator, default_generator, seed  # noqa: F401
from .place import resolve_device  # noqa: F401
