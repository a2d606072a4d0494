"""L-BFGS with a zoom line search, as `optax.lbfgs()` does it at its
defaults (optax 0.2.6: `scale_by_lbfgs(memory_size=10,
scale_init_precond=True)`, then `scale(-1)`, then
`scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy="one")` with slope_rtol 1e-4, curv_rtol 0.9,
approx_dec_rtol 1e-6, increase_factor 2 and stepsize_precision 1e-5).

A plain-torch copy of that algorithm for the port's PSVM, which the JAX
package fits with optax: the same preconditioner (two loops over the last
10 parameter and gradient differences, the identity scaled by
sᵀy/yᵀy, and by min(1, 1/|g|) at the first step), and the same line
search (Nocedal and Wright's algorithms 3.5 and 3.6, with Hager and
Zhang's approximate sufficient decrease, cubic then quadratic
interpolation then bisection, and the safeguarded step when it fails).
The parameters are one flat f32 tensor on the device; every scalar of
the line search is an f32 numpy scalar, as optax's are f32 arrays.
`torch.optim.LBFGS` is a different algorithm.
"""

from __future__ import annotations

import numpy as np
import torch

F = np.float32
_ZERO, _ONE, _TWO = F(0.0), F(1.0), F(2.0)


def _dot(a: torch.Tensor, b: torch.Tensor):
    return F(torch.dot(a, b).item())


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (NaN where there is none)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - F(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (F(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (_TWO * B)


class ZoomLBFGS:
    """optax.lbfgs(): `step(params, value, grad, value_and_grad)` returns
    the next parameters; `value_and_grad(params)` gives the objective (a
    float) and its gradient (a tensor like params)."""

    def __init__(self, n: int, device, memory_size: int = 10,
                 max_linesearch_steps: int = 20):
        self.m = memory_size
        self.max_ls = max_linesearch_steps
        self.count = 0
        self.dw = torch.zeros((memory_size, n), dtype=torch.float32,
                              device=device)
        self.du = torch.zeros_like(self.dw)
        self.rho = np.zeros(memory_size, F)
        self.prev_params = torch.zeros(n, dtype=torch.float32, device=device)
        self.prev_grad = torch.zeros_like(self.prev_params)
        self.linesearch_steps = 0      # value_and_grad calls, over all steps

    # ---- the preconditioned direction (scale_by_lbfgs, then scale(-1)) --
    def _direction(self, params, grad):
        k, m = self.count, self.m
        mem_idx, prev_idx = k % m, (k - 1) % m
        if k > 0:
            dw, du = params - self.prev_params, grad - self.prev_grad
            vd = _dot(du, dw)
            weight = _ZERO if vd == 0 else _ONE / vd
        else:
            dw = du = torch.zeros_like(params)
            weight = _ZERO
        self.dw[prev_idx], self.du[prev_idx] = dw, du
        self.rho[prev_idx] = weight
        if k > 0:
            num, den = _dot(du, dw), F((du * du).sum().item())
            scale = num / den if den > 0 else _ONE
        else:
            gnorm = np.sqrt(F((grad * grad).sum().item()))
            scale = np.minimum(_ONE, _ONE / gnorm)
        order = [(mem_idx + i) % m for i in range(m)]
        vec = grad
        alphas = {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * _dot(self.dw[i], vec)
            vec = vec + float(-alphas[i]) * self.du[i]
        vec = float(scale) * vec
        for i in order:
            beta = self.rho[i] * _dot(self.du[i], vec)
            vec = vec + float(alphas[i] - beta) * self.dw[i]
        self.prev_params, self.prev_grad = params, grad
        self.count += 1
        return -vec

    def step(self, params, value, grad, value_and_grad):
        u = self._direction(params, grad)
        lr = self._zoom(params, u, F(value), grad, value_and_grad)
        return params + float(lr) * u

    # ---- the zoom line search (scale_by_zoom_linesearch) ----------------
    def _zoom(self, params, u, value, grad, value_and_grad):
        slope_rtol, curv_rtol, approx_rtol = F(1e-4), F(0.9), F(1e-6)
        interval_threshold = F(1e-5)
        slope = _dot(u, grad)
        value_init, slope_init = value, slope

        def on_line(stepsize):
            v, g = value_and_grad(params + float(stepsize) * u)
            self.linesearch_steps += 1
            return F(v), g, _dot(g, u)

        def decrease_error(stepsize, v, s):
            err = v - value_init - slope_rtol * stepsize * slope_init
            approx = np.maximum(
                s - F(2 * 1e-4 - 1.0) * slope_init,
                v - value_init - approx_rtol * np.abs(value_init))
            err = np.maximum(np.minimum(approx, err), _ZERO)
            return F(np.inf) if np.isnan(err) else err

        def curvature_error(s):
            err = np.maximum(np.abs(s) - curv_rtol * np.abs(slope_init),
                             _ZERO)
            return F(np.inf) if np.isnan(err) else err

        st = dict(count=0, stepsize=_ZERO, value=value, grad=grad,
                  slope=slope, dec=F(np.inf), found=False, done=False,
                  failed=False, low=_ZERO, v_low=value, s_low=slope,
                  high=_ZERO, v_high=value, s_high=slope, cref=_ZERO,
                  v_cref=value, safe=_ZERO, v_safe=value, g_safe=grad)
        with np.errstate(all="ignore"):
            while not (st["done"] or st["failed"]):
                it = st["count"]
                if not st["found"]:            # algorithm 3.5: the bracket
                    new = _ONE if it == 0 else _TWO * st["stepsize"]
                    v, g, s = on_line(new)
                    dec = decrease_error(new, v, s)
                    err = np.maximum(dec, curvature_error(s))
                    if dec <= 0:
                        st.update(safe=new, v_safe=v, g_safe=g)
                    high_new = bool((dec > 0) or (v >= st["value"]
                                                  and it > 0))
                    low_new = bool(s >= 0) and not high_new
                    prev = (st["stepsize"], st["value"], st["slope"])
                    lo, hi = ((new, v, s), prev) if low_new else \
                        (prev, (new, v, s))
                    st.update(low=lo[0], v_low=lo[1], s_low=lo[2],
                              high=hi[0], v_high=hi[1], s_high=hi[2],
                              cref=lo[0], v_cref=lo[1])
                    st["found"] = high_new or low_new or bool(err <= 0)
                    done = bool(err <= 0)
                    failed = it + 1 >= self.max_ls and not done
                else:                           # algorithm 3.6: zoom
                    low, high = st["low"], st["high"]
                    delta = np.abs(high - low)
                    left, right = np.minimum(high, low), np.maximum(high, low)
                    too_small = bool(delta <= interval_threshold)
                    mc = _cubicmin(low, st["v_low"], st["s_low"], high,
                                   st["v_high"], st["cref"], st["v_cref"])
                    mq = _quadmin(low, st["v_low"], st["s_low"], high,
                                  st["v_high"])
                    if left + F(0.2) * delta < mc < right - F(0.2) * delta:
                        new = mc
                    elif left + F(0.1) * delta < mq < \
                            right - F(0.1) * delta:
                        new = mq
                    else:
                        new = (low + high) / _TWO
                    v, g, s = on_line(new)
                    dec = decrease_error(new, v, s)
                    err = np.maximum(dec, curvature_error(s))
                    if dec <= 0 and v < st["v_safe"]:
                        st.update(safe=new, v_safe=v, g_safe=g)
                    done = bool(err <= 0)
                    high_mid = bool(dec > 0 or v >= st["v_low"])
                    high_low = bool(s * (high - low) >= 0) and not high_mid
                    old_high = (high, st["v_high"], st["s_high"])
                    if high_mid or high_low:
                        st.update(cref=high, v_cref=st["v_high"])
                    else:
                        st.update(cref=low, v_cref=st["v_low"])
                    if high_mid:
                        old_high = (new, v, s)
                    if high_low:
                        old_high = (low, st["v_low"], st["s_low"])
                    if not high_mid:
                        st.update(low=new, v_low=v, s_low=s)
                    st.update(high=old_high[0], v_high=old_high[1],
                              s_high=old_high[2])
                    failed = ((it + 1 >= self.max_ls)
                              or (too_small and st["safe"] > 0)) \
                        and not done
                st.update(count=it + 1, stepsize=new, value=v, grad=g,
                          slope=s, dec=dec, done=done, failed=failed)
                if failed and (st["safe"] > 0 or np.isinf(st["dec"])):
                    st.update(stepsize=st["safe"], value=st["v_safe"],
                              grad=st["g_safe"])
        return st["stepsize"]
