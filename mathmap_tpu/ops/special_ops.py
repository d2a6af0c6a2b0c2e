"""Special functions: gamma, beta, elliptic integrals, Jacobi sn/cn/dn.

Reference: GSL-backed rows of the builtins table [unverified — mount empty,
SURVEY.md §0]; op list per SURVEY.md §2.1 ("special functions (elliptic
integrals, jacobi sn/cn/dn, beta — GSL)").

GSL is not available (and would not run on a GPU); each function is implemented
directly in backend array ops so it vectorizes over the whole grid:
  - gamma: Lanczos approximation (g=7, n=9) with reflection for x < 0.5 —
    also valid for complex arguments in split re/im form.
  - elliptic K/E: AGM iteration (fixed trip count, branch-free).
  - Jacobi sn/cn/dn: ascending-Landen/AGM method with fixed trip count.
"""

from __future__ import annotations

from ..runtime.value import TupleValue
from ..typesys.tags import NIL
from ..utils.errors import MMTypeError
from .registry import builtin, need_args

# Lanczos g=7, n=9 coefficients (Godfrey / Numerical Recipes standard set).
_LANCZOS_G = 7.0
_LANCZOS_C = (
    0.99999999999980993,
    676.5203681218851,
    -1259.1392167224028,
    771.32342877765313,
    -176.61502916214059,
    12.507343278686905,
    -0.13857109526572012,
    9.9843695780195716e-6,
    1.5056327351493116e-7,
)

_PI = 3.141592653589793


def _gamma_real(be, x):
    """Lanczos gamma for real x (vectorized, reflection for x < 0.5)."""
    # reflection: gamma(x) = pi / (sin(pi x) * gamma(1 - x))
    reflect = x < 0.5
    z = be.where(reflect, 1.0 - x, x) - 1.0
    acc = _LANCZOS_C[0]
    for i, c in enumerate(_LANCZOS_C[1:], start=1):
        acc = acc + c / (z + i)
    t = z + _LANCZOS_G + 0.5
    g = be.sqrt(2.0 * _PI) * be.power(t, z + 0.5) * be.exp(-t) * acc
    return be.where(reflect, _PI / (be.sin(_PI * x) * g), g)


def _lgamma_real(be, x):
    """log|gamma(x)| in LOG form (review r3: log(abs(gamma(x))) overflowed
    f32 for x > ~35 where lgamma itself is modest). Same Lanczos series +
    reflection as _gamma_real, summed in logs."""
    reflect = x < 0.5
    z = be.where(reflect, 1.0 - x, x) - 1.0
    acc = _LANCZOS_C[0]
    for i, c in enumerate(_LANCZOS_C[1:], start=1):
        acc = acc + c / (z + i)
    t = z + _LANCZOS_G + 0.5
    lg = (0.5 * be.log(2.0 * _PI) + (z + 0.5) * be.log(t) - t
          + be.log(be.abs(acc)))
    # reflection: log|G(x)| = log(pi) - log|sin(pi x)| - log|G(1-x)|
    return be.where(
        reflect, be.log(_PI) - be.log(be.abs(be.sin(_PI * x))) - lg, lg)


def _gamma_complex(be, re, im):
    """Lanczos gamma in split re/im form (reflection not applied: valid for
    Re(z) >= 0.5; MathMap fractal filters use it in that regime)."""
    zr, zi = re - 1.0, im
    ar = be.zeros_like(zr) + _LANCZOS_C[0]
    ai = be.zeros_like(zr)
    for i, c in enumerate(_LANCZOS_C[1:], start=1):
        dr, di = zr + i, zi
        d2 = dr * dr + di * di
        ar = ar + c * dr / d2
        ai = ai - c * di / d2
    tr, ti = zr + _LANCZOS_G + 0.5, zi
    # t^(z+0.5) = exp((z+0.5) * log t)
    log_tr = 0.5 * be.log(tr * tr + ti * ti)
    log_ti = be.arctan2(ti, tr)
    pr, pi_ = zr + 0.5, zi
    er = pr * log_tr - pi_ * log_ti
    ei = pr * log_ti + pi_ * log_tr
    m = be.exp(er - tr)
    cosv, sinv = be.cos(ei - ti), be.sin(ei - ti)
    sq = be.sqrt(2.0 * _PI)
    gr = sq * m * (cosv * ar - sinv * ai)
    gi = sq * m * (cosv * ai + sinv * ar)
    return gr, gi


@builtin("gamma")
def _gamma(ev, args, span):
    (a,) = need_args(args, 1, "gamma", span)
    if a.tag == "ri":
        gr, gi = _gamma_complex(ev.be, a.arrays[0], a.arrays[1])
        return TupleValue("ri", (gr, gi))
    if a.is_opaque or a.length != 1:
        raise MMTypeError("'gamma' expects a single value or ri: tuple", span)
    return TupleValue(NIL, (_gamma_real(ev.be, a.arrays[0]),))


@builtin("lgamma")
def _lgamma(ev, args, span):
    (a,) = need_args(args, 1, "lgamma", span)
    return TupleValue(NIL, (_lgamma_real(ev.be, a.scalar(span)),))


@builtin("beta")
def _beta(ev, args, span):
    a, b = need_args(args, 2, "beta", span)
    be = ev.be
    x, y = a.scalar(span), b.scalar(span)
    return TupleValue(NIL, (_gamma_real(be, x) * _gamma_real(be, y) / _gamma_real(be, x + y),))


# ---------------------------------------------------------------------------
# elliptic integrals (parameter m = k^2 convention, matching GSL's _comp
# functions with k passed — we take k [unverified which the reference passes])
# ---------------------------------------------------------------------------

_AGM_ITERS = 12  # f32 converges in ~6; fixed count keeps it branch-free


def _agm_ke(be, k):
    """Complete elliptic integrals K(k), E(k) by AGM."""
    a = be.ones_like(k)
    b = be.sqrt(1.0 - k * k)
    c_sum = 0.5 * k * k
    pow2 = 1.0
    for _ in range(_AGM_ITERS):
        an = 0.5 * (a + b)
        bn = be.sqrt(a * b)
        cn = 0.5 * (a - b)
        pow2 = pow2 * 2.0
        c_sum = c_sum + 0.5 * pow2 * cn * cn
        a, b = an, bn
    big_k = _PI / (2.0 * a)
    big_e = big_k * (1.0 - c_sum)
    return big_k, big_e


@builtin("ell_int_Kcomp", "ellK")
def _ell_k(ev, args, span):
    (a,) = need_args(args, 1, "ell_int_Kcomp", span)
    k, _ = _agm_ke(ev.be, a.scalar(span))
    return TupleValue(NIL, (k,))


@builtin("ell_int_Ecomp", "ellE")
def _ell_e(ev, args, span):
    (a,) = need_args(args, 1, "ell_int_Ecomp", span)
    _, e = _agm_ke(ev.be, a.scalar(span))
    return TupleValue(NIL, (e,))


def _jacobi_sn_cn_dn(be, u, k):
    """Jacobi elliptic functions via the AGM / descending Landen chain.

    Fixed-depth (branch-free) variant of Abramowitz & Stegun 16.4/17.6.
    """
    n = _AGM_ITERS
    a = be.ones_like(k)
    b = be.sqrt(1.0 - k * k)
    levels = []  # (a_i, c_i) for i = 1..n (post-update values)
    for _ in range(n):
        an = 0.5 * (a + b)
        c = 0.5 * (a - b)
        b = be.sqrt(a * b)
        a = an
        levels.append((a, c))
    # phi_n = 2^n a_n u, then descend: 2 phi_{i-1} = phi_i + asin(c_i/a_i sin phi_i)
    phi = (2.0 ** n) * a * u
    for a_i, c_i in reversed(levels):
        phi = 0.5 * (phi + be.arcsin(be.clip(c_i / a_i * be.sin(phi), -1.0, 1.0)))
    sn = be.sin(phi)
    cn = be.cos(phi)
    dn = be.sqrt(be.maximum(1.0 - (k * sn) * (k * sn), 0.0))
    return sn, cn, dn


def _jac(name: str, idx: int):
    @builtin(f"ell_jac_{name}", f"jac_{name}")
    def _op(ev, args, span, _idx=idx, _name=name):
        u, k = need_args(args, 2, f"ell_jac_{_name}", span)
        vals = _jacobi_sn_cn_dn(ev.be, u.scalar(span), k.scalar(span))
        return TupleValue(NIL, (vals[_idx],))


_jac("sn", 0)
_jac("cn", 1)
_jac("dn", 2)
