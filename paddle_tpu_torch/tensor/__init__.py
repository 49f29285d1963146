"""``paddle.tensor`` of the PyTorch port: the functional op surface
(counterpart of ``paddle_tpu/tensor/__init__.py``)."""
from ..core.tensor import Tensor, to_tensor  # noqa: F401
from ..ops.activation import *  # noqa: F401,F403
from ..ops.array_ops import *  # noqa: F401,F403
from ..ops.creation import *  # noqa: F401,F403
from ..ops.linalg import *  # noqa: F401,F403
from ..ops.manipulation import *  # noqa: F401,F403
from ..ops.math import *  # noqa: F401,F403
from ..ops.reduction import *  # noqa: F401,F403
