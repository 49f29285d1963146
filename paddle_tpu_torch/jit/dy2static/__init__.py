"""dy2static: AST-level dynamic-to-static conversion of the PyTorch port.

Counterpart of ``paddle_tpu/jit/dy2static/__init__.py``
(~ python/paddle/fluid/dygraph/dygraph_to_static/: ifelse_transformer.py,
loop_transformer.py, logical_transformer.py, convert_operators.py,
convert_call_func.py, program_translator.py).

The reference rewrites Python control flow into ProgramDesc cond/while ops.
Here, as in the JAX package, the same AST rewrite turns it into converter
calls, and the converters capture ``torch.cond`` / ``while_loop`` when the
predicate is a tensor of a program being captured (``capturing()``) and
run plain Python control flow otherwise, so one source serves eager runs
AND captured programs with data-dependent branches.

Pipeline (``convert_to_static``):
  source -> ast.parse -> LogicalTransformer (and/or/not -> converter calls)
         -> ForToWhileTransformer (for-range -> while)
         -> WhileTransformer (while -> functional cond_fn/body_fn + carry)
         -> IfElseTransformer (if -> functional branches + carry)
         -> compile + exec in the original closure environment.
"""
from .convert_operators import (  # noqa: F401
    UndefinedVar, capturing, convert_ifelse, convert_logical_and,
    convert_logical_not, convert_logical_or, convert_while_loop,
    is_capturing,
)
from .transformer import code_of, convert_to_static  # noqa: F401
