"""AST transformers rewriting Python control flow into converter calls.

The PyTorch port's own copy of ``paddle_tpu/jit/dy2static/transformer.py``
(pure Python; the port imports nothing of the JAX package). The pass is
the reference's line for line, so ``code_of`` gives the reference's text
for the same function. What differs: the converters it calls
(``convert_operators.py``: ``torch.cond`` / ``while_loop`` under the
port's capture), and, in the code that runs (not in ``code_of``'s
text), the sentinel guards decided from the code (``_resolve_guards``)
and globals without ``__name__``, both for dynamo, which traces
``torch.cond``'s branches.

~ dygraph_to_static/ifelse_transformer.py (functional branch extraction with
an explicit carry of mutated names), loop_transformer.py (while/for-range ->
cond_fn/body_fn + loop vars), logical_transformer.py (and/or/not ->
short-circuit converter lambdas), program_translator.py (source -> code
object in the original closure environment).

Conversion contract (mirrors the reference's):
  * names ASSIGNED inside a branch/loop body form the carry; both if-branches
    must define a name before it is used downstream of a tensor `if`;
  * `break`/`continue` (arbitrarily nested in `if`s) are rewritten into
    carried boolean flags (~ break_continue_transformer.py) so the loop
    still reaches captured control flow; `return` inside a candidate block
    and break/continue under try/with keep the block as native Python
    control flow (fine eagerly; under capture a tensor predicate there
    raises, since it has no value to branch on);
  * `assert`/`print`/`bool|int|float(x)`/`len(x)` lower to converters that
    survive capture (an assert and a print that run with the program,
    dtype casts, static leading-dim len);
  * the rewritten source is compiled in the original function's
    globals+closure, so references to outer objects keep working.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
import types
from typing import List, Set

_JST = "_jst"          # module alias injected into the exec namespace
_COUNTER = [0]


def _uid(base: str) -> str:
    _COUNTER[0] += 1
    return f"__{base}_{_COUNTER[0]}"


import re

_GENERATED = re.compile(
    r"^__(true_fn|false_fn|while_cond|while_body|carry|stop|step)_\d+$")


def _assigned_names(nodes: List[ast.stmt]) -> Set[str]:
    """Names bound by assignment/augassign/for-target within `nodes`
    (not descending into nested function defs); names generated by earlier
    transformer passes are excluded — they are helpers, not data."""
    out: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            out.add(node.name)

        def visit_AsyncFunctionDef(self, node):
            out.add(node.name)

        def visit_Lambda(self, node):
            pass

        def visit_Name(self, node):
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                out.add(node.id)

    v = V()
    for n in nodes:
        v.visit(n)
    return {n for n in out if not _GENERATED.match(n)}


def _has_flow_escape(nodes: List[ast.stmt]) -> bool:
    """True if the block contains return/break/continue/yield at this
    nesting level (nested funcs don't count; nested loops contain their own
    break/continue)."""
    found = [False]

    class V(ast.NodeVisitor):
        def __init__(self):
            self.loop_depth = 0

        def visit_FunctionDef(self, node):
            pass

        def visit_AsyncFunctionDef(self, node):
            pass

        def visit_Lambda(self, node):
            pass

        def visit_Return(self, node):
            found[0] = True

        def visit_Yield(self, node):
            found[0] = True

        def visit_For(self, node):
            self.loop_depth += 1
            self.generic_visit(node)
            self.loop_depth -= 1

        def visit_While(self, node):
            self.loop_depth += 1
            self.generic_visit(node)
            self.loop_depth -= 1

        def visit_Break(self, node):
            if self.loop_depth == 0:
                found[0] = True

        def visit_Continue(self, node):
            if self.loop_depth == 0:
                found[0] = True

    v = V()
    for n in nodes:
        v.visit(n)
    return found[0]


def _load(name):
    return ast.Name(id=name, ctx=ast.Load())


def _store(name):
    return ast.Name(id=name, ctx=ast.Store())


def _carry_tuple(names, ctx):
    return ast.Tuple(
        elts=[ast.Name(id=n, ctx=ctx()) for n in names], ctx=ctx())


def _jst_attr(fn_name):
    return ast.Attribute(value=_load(_JST), attr=fn_name, ctx=ast.Load())


class LogicalTransformer(ast.NodeTransformer):
    """a and b -> _jst.convert_logical_and(lambda: a, lambda: b); not ->
    convert_logical_not. Comparison chains stay (torch handles them)."""

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        conv = ("convert_logical_and" if isinstance(node.op, ast.And)
                else "convert_logical_or")
        expr = node.values[-1]
        for prev in reversed(node.values[:-1]):
            expr = ast.Call(
                func=_jst_attr(conv),
                args=[ast.Lambda(args=_empty_args(), body=prev),
                      ast.Lambda(args=_empty_args(), body=expr)],
                keywords=[])
        return expr

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.Call(func=_jst_attr("convert_logical_not"),
                            args=[node.operand], keywords=[])
        return node


def _empty_args():
    return ast.arguments(posonlyargs=[], args=[], vararg=None,
                         kwonlyargs=[], kw_defaults=[], kwarg=None,
                         defaults=[])


def _one_arg(name):
    return ast.arguments(posonlyargs=[], args=[ast.arg(arg=name)],
                         vararg=None, kwonlyargs=[], kw_defaults=[],
                         kwarg=None, defaults=[])


class ForToWhileTransformer(ast.NodeTransformer):
    """for i in range(a[, b[, c]]): body  ->  explicit counter while loop
    (then WhileTransformer decides whether it compiles)."""

    def visit_For(self, node):
        self.generic_visit(node)
        if not (isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"
                and isinstance(node.target, ast.Name)
                and not node.orelse):
            return node
        r = node.iter.args
        start = r[0] if len(r) >= 2 else ast.Constant(value=0)
        stop = r[1] if len(r) >= 2 else r[0]
        step = r[2] if len(r) == 3 else ast.Constant(value=1)
        i = node.target.id
        stop_name = _uid("stop")
        step_name = _uid("step")
        init = [
            ast.Assign(targets=[_store(i)], value=start),
            ast.Assign(targets=[_store(stop_name)], value=stop),
            ast.Assign(targets=[_store(step_name)], value=step),
        ]
        # condition: i < stop (step > 0 assumed when step is a tensor;
        # mixed-sign python steps still work since comparison is evaluated
        # natively there)
        cond = ast.Compare(left=_load(i), ops=[ast.Lt()],
                           comparators=[_load(stop_name)])
        incr = ast.AugAssign(target=_store(i), op=ast.Add(),
                             value=_load(step_name))
        # BreakContinueTransformer must keep the increment unguarded so
        # `continue` still advances the induction variable
        incr._dy2static_incr = True
        body = node.body + [incr]
        new_while = ast.While(test=cond, body=body, orelse=[])
        return init + [new_while]


def _undefined_guards(carry):
    """For each carry name, bind an UndefinedVar sentinel when not yet a
    local (so temps first assigned inside the block still form a valid
    carry tuple; convert_* partitions them out of the compiled subset)."""
    guards = []
    for n in carry:
        scope = _load("dir")
        scope._dy2static_guard = True
        guards.append(ast.If(
            test=ast.Compare(
                left=ast.Constant(value=n), ops=[ast.NotIn()],
                comparators=[ast.Call(func=scope, args=[],
                                      keywords=[])]),
            body=[ast.Assign(
                targets=[_store(n)],
                value=ast.Call(func=_jst_attr("UndefinedVar"),
                               args=[ast.Constant(value=n)],
                               keywords=[]))],
            orelse=[]))
    return guards


class WhileTransformer(ast.NodeTransformer):
    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _has_flow_escape(node.body):
            return node
        carry = sorted(_assigned_names(node.body))
        if not carry:
            return node
        carry_name = _uid("carry")
        cond_name = _uid("while_cond")
        body_name = _uid("while_body")
        unpack = ast.Assign(targets=[_carry_tuple(carry, ast.Store)],
                            value=_load(carry_name))
        cond_fn = ast.FunctionDef(
            name=cond_name, args=_one_arg(carry_name),
            body=[unpack, ast.Return(value=node.test)],
            decorator_list=[])
        body_fn = ast.FunctionDef(
            name=body_name, args=_one_arg(carry_name),
            body=([ast.Assign(targets=[_carry_tuple(carry, ast.Store)],
                              value=_load(carry_name))]
                  + node.body
                  + [ast.Return(value=_carry_tuple(carry, ast.Load))]),
            decorator_list=[])
        call = ast.Assign(
            targets=[_carry_tuple(carry, ast.Store)],
            value=ast.Call(
                func=_jst_attr("convert_while_loop"),
                args=[_load(cond_name), _load(body_name),
                      _carry_tuple(carry, ast.Load)],
                keywords=[]))
        return _undefined_guards(carry) + [cond_fn, body_fn, call]


def _if_has_return(node) -> bool:
    """A Return somewhere under `node` at this function's level (nested
    function defs don't count)."""
    found = [False]

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, n):
            pass

        def visit_AsyncFunctionDef(self, n):
            pass

        def visit_Lambda(self, n):
            pass

        def visit_Return(self, n):
            found[0] = True

    V().visit(node)
    return found[0]


def _ends_with_return(stmts) -> bool:
    """Every trailing path through `stmts` ends in a Return."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Return):
        return True
    if isinstance(last, ast.If):
        return bool(last.orelse) and _ends_with_return(last.body) \
            and _ends_with_return(last.orelse)
    return False


class ReturnTransformer(ast.NodeTransformer):
    """Early-return canonicalization (~ return_transformer.py): fold the
    implicit else of `if c: return a` into an explicit orelse, then turn
    every Return into an assignment to one return slot with a single
    trailing `return __ret_N`. Both branches of each If then assign the
    slot, so IfElseTransformer compiles tensor-pred early returns as
    torch.cond under capture. Functions where some path falls through
    without returning, or with returns inside loops/try, are left
    unchanged (native Python control flow, matching the reference's
    restriction)."""

    def visit_FunctionDef(self, node):
        self.generic_visit(node)  # nested defs first
        if not any(isinstance(st, ast.If) and _if_has_return(st)
                   for st in node.body):
            return node
        body = self._fold(node.body)
        if not _ends_with_return(body):
            return node  # some path falls through: stays native
        ret_name = _uid("ret")
        new_body, ok = self._replace_returns(body, ret_name)
        if not ok:
            return node
        node.body = new_body + [ast.Return(value=_load(ret_name))]
        return node

    def _fold(self, stmts):
        """Push the continuation of any return-containing If INSIDE it, so
        after folding a Return is always the last statement of its path
        (nothing ever follows a returning path — the property that makes
        Return -> assignment replacement sound)."""
        out = []
        for i, st in enumerate(stmts):
            if isinstance(st, ast.If) and _if_has_return(st):
                b = self._fold(st.body)
                o = self._fold(st.orelse)
                rest = self._fold(stmts[i + 1:])
                out.append(ast.If(test=st.test,
                                  body=self._attach(b, rest),
                                  orelse=self._attach(o, rest)))
                return out
            out.append(st)
        return out

    def _attach(self, branch, cont):
        """Append `cont` to every non-returning leaf path of `branch`."""
        if not cont:
            return branch
        if not branch:
            return list(cont)
        if _ends_with_return(branch):
            return branch
        last = branch[-1]
        if isinstance(last, ast.If) and _if_has_return(last):
            return branch[:-1] + [ast.If(
                test=last.test,
                body=self._attach(last.body, cont) or [ast.Pass()],
                orelse=self._attach(last.orelse, cont))]
        return branch + list(cont)

    @staticmethod
    def _replace_returns(stmts, ret_name):
        ok = [True]

        class R(ast.NodeTransformer):
            def visit_FunctionDef(self, n):
                return n

            def visit_AsyncFunctionDef(self, n):
                return n

            def visit_Lambda(self, n):
                return n

            def _check_no_return(self, n):
                if any(isinstance(x, ast.Return) for x in ast.walk(n)):
                    ok[0] = False
                return n

            visit_For = visit_While = visit_Try = _check_no_return

            def visit_Return(self, n):
                return ast.Assign(
                    targets=[_store(ret_name)],
                    value=n.value if n.value is not None
                    else ast.Constant(value=None))

        new = [R().visit(s) for s in stmts]
        return new, ok[0]


class StmtCallTransformer(ast.NodeTransformer):
    """assert/print/cast/len -> converter calls (~ the reference's
    assert_transformer.py, print_transformer.py, cast_transformer.py and
    convert_len in convert_operators.py)."""

    _CASTS = ("bool", "int", "float")

    def visit_Call(self, node):
        self.generic_visit(node)
        if isinstance(node.func, ast.Name) and not node.keywords:
            name = node.func.id
            if name == "print" and not any(
                    isinstance(a, ast.Starred) for a in node.args):
                return ast.Call(func=_jst_attr("convert_print"),
                                args=node.args, keywords=[])
            if name in self._CASTS and len(node.args) == 1:
                return ast.Call(
                    func=_jst_attr("convert_var_dtype"),
                    args=[node.args[0], ast.Constant(value=name)],
                    keywords=[])
            if name == "len" and len(node.args) == 1:
                return ast.Call(func=_jst_attr("convert_len"),
                                args=node.args, keywords=[])
        return node

    def visit_Assert(self, node):
        self.generic_visit(node)
        args = [node.test] + ([node.msg] if node.msg is not None else [])
        return ast.Expr(value=ast.Call(func=_jst_attr("convert_assert"),
                                       args=args, keywords=[]))


def _contains_bc(node) -> bool:
    """break/continue belonging to the CURRENT loop level somewhere under
    `node` (nested loops own their break/continue; nested functions don't
    count)."""
    found = [False]

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, n):
            pass

        def visit_AsyncFunctionDef(self, n):
            pass

        def visit_Lambda(self, n):
            pass

        def visit_For(self, n):
            pass

        def visit_While(self, n):
            pass

        def visit_Break(self, n):
            found[0] = True

        def visit_Continue(self, n):
            found[0] = True

    V().visit(node)
    return found[0]


def _bc_only_in_ifs(stmts) -> bool:
    """The flag rewrite handles break/continue directly in the body or
    inside (arbitrarily nested) If statements; inside try/with the loop
    stays native Python."""
    for st in stmts:
        if isinstance(st, (ast.Break, ast.Continue)):
            continue
        if isinstance(st, ast.If):
            if not (_bc_only_in_ifs(st.body) and _bc_only_in_ifs(st.orelse)):
                return False
        elif isinstance(st, (ast.For, ast.While, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            continue  # nested loops/functions own theirs
        elif _contains_bc(st):
            return False
    return True


def _not_flags(brk, cont):
    """AST for `not (brk or cont)` via the converters (tensor-safe)."""
    return ast.Call(
        func=_jst_attr("convert_logical_not"),
        args=[ast.Call(
            func=_jst_attr("convert_logical_or"),
            args=[ast.Lambda(args=_empty_args(), body=_load(brk)),
                  ast.Lambda(args=_empty_args(), body=_load(cont))],
            keywords=[])],
        keywords=[])


def _guard_block(stmts, brk, cont):
    """Rewrite one statement list: break/continue become flag sets; the
    statements after a flag-setting If run under `if not (brk or cont)`.
    Statements after a bare break/continue are unreachable and dropped."""
    out = []
    for i, st in enumerate(stmts):
        if isinstance(st, ast.Break):
            out.append(ast.Assign(targets=[_store(brk)],
                                  value=ast.Constant(value=True)))
            return out
        if isinstance(st, ast.Continue):
            out.append(ast.Assign(targets=[_store(cont)],
                                  value=ast.Constant(value=True)))
            return out
        if isinstance(st, ast.If) and _contains_bc(st):
            out.append(ast.If(test=st.test,
                              body=_guard_block(st.body, brk, cont)
                              or [ast.Pass()],
                              orelse=_guard_block(st.orelse, brk, cont)))
            rest = _guard_block(stmts[i + 1:], brk, cont)
            if rest:
                out.append(ast.If(test=_not_flags(brk, cont), body=rest,
                                  orelse=[]))
            return out
        out.append(st)
    return out


class BreakContinueTransformer(ast.NodeTransformer):
    """break/continue -> carried boolean flags so early-exit loops still
    reach compiled control flow (~ break_continue_transformer.py). Runs on
    the while form, innermost loops first; the loop condition gains
    `and not __brk`, each iteration resets `__cont`, and for-range
    increments (tagged by ForToWhileTransformer) stay unguarded so
    `continue` still advances the induction variable."""

    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or not _contains_bc(ast.Module(body=node.body,
                                                      type_ignores=[])):
            return node
        if not _bc_only_in_ifs(node.body):
            return node  # stays native (try/with-nested break)
        brk = _uid("brk")
        cont = _uid("cont")
        body = list(node.body)
        tail = []
        while body and getattr(body[-1], "_dy2static_incr", False):
            tail.insert(0, body.pop())
        if tail:
            # the for-range increment: `continue` must still advance the
            # induction variable, but `break` must NOT (python leaves i at
            # its break value) — guard the tail on `not __brk` only
            tail = [ast.If(
                test=ast.Call(func=_jst_attr("convert_logical_not"),
                              args=[_load(brk)], keywords=[]),
                body=tail, orelse=[])]
        new_body = ([ast.Assign(targets=[_store(cont)],
                                value=ast.Constant(value=False))]
                    + _guard_block(body, brk, cont) + tail)
        test = ast.Call(
            func=_jst_attr("convert_logical_and"),
            args=[ast.Lambda(args=_empty_args(),
                             body=ast.Call(
                                 func=_jst_attr("convert_logical_not"),
                                 args=[_load(brk)], keywords=[])),
                  ast.Lambda(args=_empty_args(), body=node.test)],
            keywords=[])
        init = ast.Assign(targets=[_store(brk)],
                          value=ast.Constant(value=False))
        return [init, ast.While(test=test, body=new_body, orelse=[])]


def _read_names(node) -> Set[str]:
    out: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_Name(self, n):
            if isinstance(n.ctx, ast.Load):
                out.add(n.id)
            self.generic_visit(n)

    V().visit(node)
    return out


def _make_ifelse(test, body, orelse, carry):
    """Emit guards + true_fn/false_fn + convert_ifelse call for one If."""
    carry_name = _uid("carry")
    t_name = _uid("true_fn")
    f_name = _uid("false_fn")

    def branch(name, stmts_in):
        stmts = [ast.Assign(targets=[_carry_tuple(carry, ast.Store)],
                            value=_load(carry_name))]
        stmts += stmts_in if stmts_in else [ast.Pass()]
        stmts.append(ast.Return(value=_carry_tuple(carry, ast.Load)))
        return ast.FunctionDef(name=name, args=_one_arg(carry_name),
                               body=stmts, decorator_list=[])

    call = ast.Assign(
        targets=[_carry_tuple(carry, ast.Store)],
        value=ast.Call(
            func=_jst_attr("convert_ifelse"),
            args=[test, _load(t_name), _load(f_name),
                  _carry_tuple(carry, ast.Load)],
            keywords=[]))
    return _undefined_guards(carry) + [branch(t_name, body),
                                       branch(f_name, orelse), call]


def _convert_ifs_block(stmts, live_after):
    """Convert compilable Ifs in one statement list, walking BACKWARD so
    each If's carry is its assigned names intersected with what is LIVE
    after it (names never read downstream are dead temps — carrying them
    would force both branches to define values nobody uses, the exact
    constraint early-return canonicalization trips over). Conservative:
    reads accumulate, kills are ignored."""
    new = []
    live = set(live_after)
    for st in reversed(stmts):
        if isinstance(st, ast.If) and not _has_flow_escape(st.body) \
                and not _has_flow_escape(st.orelse):
            assigned = _assigned_names(st.body) | _assigned_names(st.orelse)
            carry = sorted(n for n in assigned if n in live)
            if carry:
                body = _convert_ifs_block(st.body, set(carry))
                orelse = _convert_ifs_block(st.orelse, set(carry))
                conv = _make_ifelse(st.test, body, orelse, carry)
                new[:0] = conv
                live |= _read_names(st)
                continue
            # dead/side-effect-only: stays a native if, but inner ifs may
            # still convert
            st = ast.If(test=st.test,
                        body=_convert_ifs_block(st.body, live),
                        orelse=_convert_ifs_block(st.orelse, live))
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # generated while bodies / nested defs: their Return's reads
            # surface while walking their block backward
            st.body = _convert_ifs_block(st.body, set())
        elif isinstance(st, (ast.For, ast.While)):
            # loop-carried liveness: anything read in the loop is live
            st.body = _convert_ifs_block(
                st.body, live | _read_names(st))
        elif isinstance(st, (ast.Try, ast.With, ast.AsyncWith)):
            cons = live | _read_names(st)
            st.body = _convert_ifs_block(st.body, cons)
            for attr in ("orelse", "finalbody"):
                if getattr(st, attr, None):
                    setattr(st, attr,
                            _convert_ifs_block(getattr(st, attr), cons))
            for h in getattr(st, "handlers", []):
                h.body = _convert_ifs_block(h.body, cons)
        new.insert(0, st)
        live |= _read_names(st)
    return new


class IfElseTransformer:
    """Liveness-aware If conversion (see _convert_ifs_block)."""

    def visit(self, tree):
        for st in tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                st.body = _convert_ifs_block(st.body, set())
        return tree


def _strip_decorators(tree: ast.Module):
    fn = tree.body[0]
    fn.decorator_list = []
    return tree


def _stored(node) -> Set[str]:
    """Names a statement binds in its own scope (nested functions,
    lambdas and comprehensions have their own)."""
    out: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, n):
            out.add(n.name)

        visit_AsyncFunctionDef = visit_ClassDef = visit_FunctionDef

        def visit_Lambda(self, n):
            pass

        visit_ListComp = visit_SetComp = visit_DictComp = visit_Lambda
        visit_GeneratorExp = visit_Lambda

        def visit_Name(self, n):
            if isinstance(n.ctx, ast.Store):
                out.add(n.id)

        def visit_alias(self, n):
            out.add((n.asname or n.name).split(".")[0])

    V().visit(node)
    return out


def _guard_test(node):
    """The name a sentinel guard's test (``'n' not in dir()``, made by
    ``_undefined_guards``) asks about, or None."""
    if isinstance(node, ast.Compare):
        scope = node.comparators[0]
        if isinstance(scope, ast.Call) and getattr(
                scope.func, "_dy2static_guard", False):
            return node.left.value
    return None


def _guard_name(st):
    """The name a sentinel guard binds, or None."""
    return _guard_test(st.test) if isinstance(st, ast.If) else None


def _decide(test, name, definite, possible):
    """A guard's test as the constant it must be, or as ``'n' not in
    locals()`` where the code cannot decide it."""
    if name in definite:
        return ast.copy_location(ast.Constant(value=False), test)
    if name not in possible:
        return ast.copy_location(ast.Constant(value=True), test)
    test.comparators[0].func = ast.copy_location(
        _load("locals"), test.comparators[0].func)
    return test


class _GuardTests(ast.NodeTransformer):
    """Decides the guard tests inside one simple statement (the guards
    that ``IfElseTransformer`` turned into ``convert_ifelse`` calls)."""

    def __init__(self, definite, possible):
        self.definite, self.possible = definite, possible

    def visit_Compare(self, node):
        name = _guard_test(node)
        if name is None:
            return self.generic_visit(node)
        return _decide(node, name, self.definite, self.possible)

    def visit_Lambda(self, node):
        return node


def _resolve_guards(stmts, definite, possible):
    """The port's change to the executed code (``code_of`` keeps the
    reference's text). A guard asks ``'n' not in dir()`` at run time;
    ``torch.cond`` / ``while_loop`` trace their branches with dynamo,
    which follows neither ``dir()`` nor, in every PyTorch, ``locals()``.
    So each guard is decided from the code where it can be: dropped where
    ``n`` is bound on every path to it (a parameter, the carry's
    unpacking, an earlier statement of the same or an enclosing block),
    made an unconditional binding where no earlier statement (nor a later
    one in an enclosing loop) binds ``n``; only otherwise does it stay a
    run-time test, on ``locals()``. Returns the rewritten statements and
    the names bound on every path through them."""
    out = []
    definite, possible = set(definite), set(possible)
    for st in stmts:
        name = _guard_name(st)
        if name is not None:
            test = _decide(st.test, name, definite, possible)
            if not isinstance(test, ast.Constant):
                out.append(st)
            elif test.value:
                out.extend(st.body)
            definite.add(name)
            possible.add(name)
            continue
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _resolve_function(st)
        elif isinstance(st, ast.If):
            st.body, d1 = _resolve_guards(st.body, definite, possible)
            st.orelse, d2 = _resolve_guards(st.orelse, definite, possible)
            definite |= d1 & d2
        elif isinstance(st, (ast.For, ast.AsyncFor, ast.While, ast.Try,
                             ast.With, ast.AsyncWith)):
            # a loop's later statements ran on an earlier iteration; a
            # try's handlers follow any prefix of its body
            inner = possible | _stored(st)
            for attr in ("body", "orelse", "finalbody"):
                if getattr(st, attr, None):
                    setattr(st, attr, _resolve_guards(
                        getattr(st, attr), definite, inner)[0])
            for h in getattr(st, "handlers", []):
                h.body = _resolve_guards(h.body, definite, inner)[0]
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            definite.add(st.name)
        elif not isinstance(st, (ast.If, ast.For, ast.AsyncFor, ast.While,
                                 ast.Try, ast.With, ast.AsyncWith)):
            st = _GuardTests(definite, possible).visit(st)
            definite |= _stored(st)
        possible |= _stored(st)
        out.append(st)
    return out, definite


def _resolve_function(fn):
    a = fn.args
    params = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    params |= {x.arg for x in (a.vararg, a.kwarg) if x is not None}
    fn.body = _resolve_guards(fn.body, params, params)[0] or [ast.Pass()]


def convert_to_static(func):
    """Rewrite ``func``'s control flow; returns a new function object closed
    over the same globals/closure (~ program_translator's conversion cache).
    Falls back to the original function when source is unavailable."""
    try:
        src = textwrap.dedent(inspect.getsource(func))
    except (OSError, TypeError):
        return func
    tree = ast.parse(src)
    if not isinstance(tree.body[0], (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
        return func
    _strip_decorators(tree)
    tree = LogicalTransformer().visit(tree)
    tree = StmtCallTransformer().visit(tree)
    tree = ReturnTransformer().visit(tree)
    tree = ForToWhileTransformer().visit(tree)
    tree = BreakContinueTransformer().visit(tree)
    tree = WhileTransformer().visit(tree)
    tree = IfElseTransformer().visit(tree)
    ast.fix_missing_locations(tree)
    fn_name = tree.body[0].name
    source = ast.unparse(tree)
    _resolve_function(tree.body[0])
    ast.fix_missing_locations(tree)

    from . import convert_operators as _ops
    namespace = dict(func.__globals__)
    namespace[_JST] = _ops
    # the copy is no module's dict: without __name__ dynamo (the tracer of
    # torch.cond's branches) reads its globals from this dict, not from
    # the module of that name, which has no _jst
    namespace.pop("__name__", None)
    # rebind the original closure cells
    if func.__closure__:
        freevars = func.__code__.co_freevars
        for var, cell in zip(freevars, func.__closure__):
            try:
                namespace[var] = cell.cell_contents
            except ValueError:
                pass
    code = compile(tree, filename=f"<dy2static {fn_name}>", mode="exec")
    exec(code, namespace)
    converted = namespace[fn_name]
    converted.__wrapped_dygraph__ = func
    converted.__dy2static_source__ = source
    return converted


def code_of(converted) -> str:
    """Transformed source (for jit.set_code_level-style inspection and the
    reference's compiler-golden test style)."""
    return getattr(converted, "__dy2static_source__", None) or \
        inspect.getsource(converted)
