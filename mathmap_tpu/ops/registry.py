"""Builtin-op registry and overload helpers.

Replaces the reference's Lisp op DSL (`ops.lisp`/`builtins.lisp` → generated
`new_builtins.c` [unverified — mount empty, SURVEY.md §0]) and the overload
binder (`overload.c`). Each builtin is a Python function

    fn(ev, args: list[TupleValue], span) -> TupleValue

that performs its own tag/length dispatch (raising MMTypeError on mismatch,
which is the overload-resolution failure path). `ev` is the evaluator,
exposing the array backend `ev.be` (numpy for the oracle interpreter,
jax.numpy for the traced device path) so each op definition serves both
backends — the analog of the reference ops table carrying both a C-emission
template and an interpreter implementation.

Constant folding / CSE are NOT implemented here: under `jax.jit` XLA performs
them on the traced program (SURVEY §7 design decision).
"""

from __future__ import annotations

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError

#: name -> callable(ev, args, span) -> TupleValue
BUILTINS: dict = {}

#: internal operator names -> user-facing spellings for error messages
DISPLAY_NAMES = {
    "__add": "+", "__sub": "-", "__mul": "*", "__div": "/", "__mod": "%",
    "__pow": "^", "__eq": "==", "__ne": "!=", "__lt": "<", "__gt": ">",
    "__le": "<=", "__ge": ">=", "__and": "&&", "__or": "||",
    "__xor": "xor", "__neg": "unary -", "__not": "!",
}


def display(name: str) -> str:
    return DISPLAY_NAMES.get(name, name)


def builtin(name: str, *aliases: str):
    def deco(fn):
        BUILTINS[name] = fn
        for alias in aliases:
            BUILTINS[alias] = fn
        return fn

    return deco


def is_builtin(name: str) -> bool:
    return name in BUILTINS


def lookup(name: str):
    return BUILTINS.get(name)


# ---------------------------------------------------------------------------
# Overload / broadcasting helpers
# ---------------------------------------------------------------------------

def result_tag(a: TupleValue, b: TupleValue) -> str:
    """Tag of an elementwise binary result.

    Rule [unverified — mirrors upstream behavior from the language manual]:
    equal tags keep the tag; a length-1 nil operand adopts the other side's
    tag; otherwise the result is nil.
    """
    if a.tag == b.tag:
        return a.tag
    if a.tag == NIL and a.length == 1:
        return b.tag
    if b.tag == NIL and b.length == 1:
        return a.tag
    return NIL


def broadcast_pair(a: TupleValue, b: TupleValue, span, opname: str):
    """Yield aligned component pairs under MathMap broadcast rules:
    equal lengths zip; length-1 broadcasts against length-n."""
    if a.is_opaque or b.is_opaque:
        raise MMTypeError(
            f"operator {display(opname)!r} not defined on {a.tag}/{b.tag}", span
        )
    la, lb = a.length, b.length
    if la == lb:
        return list(zip(a.arrays, b.arrays))
    if la == 1:
        return [(a.arrays[0], y) for y in b.arrays]
    if lb == 1:
        return [(x, b.arrays[0]) for x in a.arrays]
    raise MMTypeError(
        f"operator {display(opname)!r}: tuple lengths {la} and {lb} do not match", span
    )


def ew2(opname: str, fn) -> None:
    """Register a plain elementwise binary builtin."""

    @builtin(opname)
    def _op(ev, args, span, _fn=fn, _name=opname):
        a, b = need_args(args, 2, _name, span)
        pairs = broadcast_pair(a, b, span, _name)
        out = tuple(_fn(ev.be, x, y) for x, y in pairs)
        return TupleValue(result_tag(a, b), out)


def ew1(opname: str, fn, *aliases: str) -> None:
    """Register a plain elementwise unary builtin."""

    @builtin(opname, *aliases)
    def _op(ev, args, span, _fn=fn, _name=opname):
        (a,) = need_args(args, 1, _name, span)
        if a.is_opaque:
            raise MMTypeError(f"{_name!r} not defined on {a.tag}", span)
        return TupleValue(a.tag, tuple(_fn(ev.be, x) for x in a.arrays))


def need_args(args, n: int, name: str, span):
    if len(args) != n:
        raise MMTypeError(f"{name!r} expects {n} argument(s), got {len(args)}", span)
    return args


def need_tag(v: TupleValue, tag: str, name: str, span) -> TupleValue:
    if v.tag != tag:
        raise MMTypeError(f"{name!r} expects a {tag}: tuple, got {v.tag}:", span)
    return v


def need_length(v: TupleValue, n: int, name: str, span) -> TupleValue:
    if v.is_opaque:
        # name the opaque kind, not "length 1" (TupleValue.length is 1
        # for any payload value — the old message sent users debugging a
        # tuple-arity problem that doesn't exist; review r5)
        raise MMTypeError(
            f"{name!r} expects a length-{n} tuple, got a {v.tag} value",
            span)
    if v.length != n:
        raise MMTypeError(f"{name!r} expects a length-{n} tuple, got length {v.length}", span)
    return v



