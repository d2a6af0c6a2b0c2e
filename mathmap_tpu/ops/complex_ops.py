"""Complex-number builtins on `ri:` tuples.

Reference: complex op rows of the builtins table (GSL-backed in the
reference) [unverified — mount empty, SURVEY.md §0]; op list per SURVEY.md
§2.1: mul/div overloads, conj, arg, complex exp/log/sqrt/trig, gamma.

Complex values are ri:[re, im]; arithmetic stays in split real/imag form so
the whole computation remains elementwise f32 arrays (no complex64: split
form fuses into one elementwise program and lowers inside the Triton loop
kernel, which has no complex types).
"""

from __future__ import annotations

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError
from .registry import builtin, need_args, need_length


def c_mul(ev, a: TupleValue, b: TupleValue) -> TupleValue:
    ar, ai = a.arrays
    br, bi = b.arrays
    return TupleValue("ri", (ar * br - ai * bi, ar * bi + ai * br))


def c_div(ev, a: TupleValue, b: TupleValue) -> TupleValue:
    ar, ai = a.arrays
    br, bi = b.arrays
    d = br * br + bi * bi
    return TupleValue("ri", ((ar * br + ai * bi) / d, (ai * br - ar * bi) / d))


def c_exp(ev, a: TupleValue) -> TupleValue:
    be = ev.be
    re, im = a.arrays
    m = be.exp(re)
    return TupleValue("ri", (m * be.cos(im), m * be.sin(im)))


def c_log(ev, a: TupleValue) -> TupleValue:
    be = ev.be
    re, im = a.arrays
    return TupleValue("ri", (0.5 * be.log(re * re + im * im), be.arctan2(im, re)))


def c_sqrt(ev, a: TupleValue) -> TupleValue:
    be = ev.be
    re, im = a.arrays
    r = be.sqrt(be.sqrt(re * re + im * im))
    th = 0.5 * be.arctan2(im, re)
    return TupleValue("ri", (r * be.cos(th), r * be.sin(th)))


def c_sin(ev, a: TupleValue) -> TupleValue:
    be = ev.be
    re, im = a.arrays
    return TupleValue("ri", (be.sin(re) * be.cosh(im), be.cos(re) * be.sinh(im)))


def c_cos(ev, a: TupleValue) -> TupleValue:
    be = ev.be
    re, im = a.arrays
    return TupleValue("ri", (be.cos(re) * be.cosh(im), -be.sin(re) * be.sinh(im)))


def c_tan(ev, a: TupleValue) -> TupleValue:
    return c_div(ev, c_sin(ev, a), c_cos(ev, a))


def c_pow(ev, a: TupleValue, b: TupleValue) -> TupleValue:
    # z^w = exp(w * log z)
    return c_exp(ev, TupleValue("ri", c_mul(ev, b, c_log(ev, a)).arrays))


@builtin("conj")
def _conj(ev, args, span):
    (a,) = need_args(args, 1, "conj", span)
    need_length(a, 2, "conj", span)
    return TupleValue(a.tag, (a.arrays[0], -a.arrays[1]))


@builtin("arg")
def _arg(ev, args, span):
    (a,) = need_args(args, 1, "arg", span)
    need_length(a, 2, "arg", span)
    return TupleValue(NIL, (ev.be.arctan2(a.arrays[1], a.arrays[0]),))


# -- overload-aware re-registrations of the elementwise trig/exp builtins ----
# (BUILTINS is last-write-wins; ops/__init__ imports math_ops first.)

def _complex_dispatch(name: str, complex_fn, real_fn):
    @builtin(name)
    def _op(ev, args, span, _cfn=complex_fn, _rfn=real_fn, _name=name):
        (a,) = need_args(args, 1, _name, span)
        if a.is_opaque:
            # the ew1 registrations this overload replaces raised here;
            # without the guard an image argument returned an EMPTY
            # non-opaque tuple (review r3)
            raise MMTypeError(f"{_name!r} not defined on {a.tag}", span)
        if a.tag == "ri":
            return _cfn(ev, a)
        return TupleValue(a.tag, tuple(_rfn(ev.be, x) for x in a.arrays))


_complex_dispatch("exp", c_exp, lambda be, x: be.exp(x))
_complex_dispatch("sqrt", c_sqrt, lambda be, x: be.sqrt(x))
_complex_dispatch("sin", c_sin, lambda be, x: be.sin(x))
_complex_dispatch("cos", c_cos, lambda be, x: be.cos(x))
_complex_dispatch("tan", c_tan, lambda be, x: be.tan(x))
