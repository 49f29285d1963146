"""paddle_tpu_torch.static — the static-graph API of the PyTorch port.

Counterpart of ``paddle_tpu/static/__init__.py`` (``:1-52``). Between
``paddle.enable_static()`` and ``disable_static()``, ops on symbolic
``static.data`` variables are captured into the default main program
(``graph.py``); ``Executor.run`` replays it on the card (or the CPU it is
given) with the gradients ``append_backward`` / ``gradients`` /
``Optimizer.minimize`` ask for and the optimizers' updates
(``executor.py``); ``save_inference_model`` exports it for the predictor
(``io.py``). ``static.nn`` builds layers into the program, ``passes``
holds the graph passes, ``extras`` the strategies, places and
program-state io. ``InputSpec`` is ``jit``'s.

Refused by name: ``static.nn.conv2d_transpose`` / ``conv3d_transpose`` /
``deform_conv2d`` (ROADMAP item 16) and a ZeRO optimizer in the Executor
(item 15).
"""
import contextlib

from ..jit import InputSpec  # noqa: F401
from .graph import (Program, StaticVar, GradVar, data, program_guard,  # noqa
                    default_main_program, default_startup_program,
                    append_backward, gradients, in_static_mode)
from .executor import (Executor, CompiledProgram, Scope, global_scope,  # noqa
                       scope_guard)
from .io import save_inference_model, load_inference_model  # noqa: F401
from . import nn  # noqa: F401
from .extras import (  # noqa: F401
    BuildStrategy, ExecutionStrategy, ExponentialMovingAverage,
    IpuCompiledProgram, IpuStrategy, ParallelExecutor, Print,
    WeightNormParamAttr, accuracy, auc, cpu_places, create_global_var,
    create_parameter, cuda_places, deserialize_persistables,
    deserialize_program, device_guard, ipu_shard_guard, load, load_from_file,
    load_program_state, mlu_places, normalize_program, npu_places, save,
    save_to_file, serialize_persistables, serialize_program,
    set_program_state, xpu_places,
)
from .nn import py_func  # noqa: F401
from . import passes  # noqa: F401
from .passes import apply_pass, register_pass  # noqa: F401

Variable = StaticVar

__all__ = [
    "Program", "StaticVar", "Variable", "GradVar", "data", "program_guard",
    "default_main_program", "default_startup_program", "append_backward",
    "gradients", "Executor", "CompiledProgram", "Scope", "global_scope",
    "scope_guard", "save_inference_model", "load_inference_model", "nn",
    "InputSpec",
]


@contextlib.contextmanager
def name_scope(prefix=None):
    """~ paddle.static.name_scope: accepted, names nothing (the
    reference's)."""
    yield
