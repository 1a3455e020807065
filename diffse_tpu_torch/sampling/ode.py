"""Adaptive Dormand-Prince RK45 on the device (port of
diffse_tpu/sampling/ode.py).

scipy's RK45 controller, as the JAX package has it: an RMS error norm with
``scale = atol + rtol * max(|y|, |y_new|)``, safety factor 0.9, growth
clamped to [0.2, 10], scipy's initial step, complex states, float32 times.

The JAX package runs the loop as one ``lax.while_loop``. Here the solver is
three phases over a state of device tensors (``RK45State``), so that a
caller can capture each as a CUDA graph: ``start`` (2 evaluations),
``attempt`` (one step attempt, 6 evaluations, accepted or rejected on the
device) and ``done``. Once done (t reached the end, ``max_steps`` attempts,
or a step-size underflow) an attempt changes nothing, so any number of
attempts between two reads of ``done`` gives the same result.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..parallel.sequence import current_frames

# Dormand-Prince (RK45) Butcher tableau, as scipy.integrate.RK45 has it, in
# float32.
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0], dtype=np.float32)
_A = [
    np.array([], dtype=np.float32),
    np.array([1 / 5], dtype=np.float32),
    np.array([3 / 40, 9 / 40], dtype=np.float32),
    np.array([44 / 45, -56 / 15, 32 / 9], dtype=np.float32),
    np.array([19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729], dtype=np.float32),
    np.array([9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656], dtype=np.float32),
]
_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84], dtype=np.float32)
# error weights b - b_hat (5th order less the embedded 4th), with the k7 term
_E = np.array([71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40],
              dtype=np.float32)

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ORDER_EXP = -1 / 5  # error estimator of order 4: exponent -1/(4+1)


class ODEResult(NamedTuple):
    y: torch.Tensor
    nfev: torch.Tensor
    status: torch.Tensor  # 0 = success, 1 = step size underflow


class RK45State(NamedTuple):
    """The loop's carry: 0-d float32 ``t`` and ``h``, the state ``y`` and its
    derivative ``f``, 0-d int32 ``nfev``, ``n`` (attempts) and ``status``."""

    t: torch.Tensor
    y: torch.Tensor
    f: torch.Tensor
    h: torch.Tensor
    nfev: torch.Tensor
    n: torch.Tensor
    status: torch.Tensor


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The RMS of ``|x| / scale``; on a frames shard over every rank's frames."""
    r = torch.abs(x) / scale
    seq = current_frames()
    if seq is None:
        return torch.sqrt(torch.mean(r * r))
    total = seq.sum((r * r).sum(dtype=torch.float64))
    return torch.sqrt(total / (r.numel() * seq.count)).float()


def _lincomb(coeffs, ks):
    """sum_j coeffs[j] * ks[j], summed left to right."""
    acc = float(coeffs[0]) * ks[0]
    for c, k in zip(coeffs[1:], ks[1:]):
        acc = acc + float(c) * k
    return acc


class RK45:
    """Integrate dy/dt = f(t, y) over ``t_span`` (either direction).

    Args:
        f: right-hand side ``(t 0-d float32 tensor, y) -> dy/dt``; y may be
            complex.
        t_span: (t0, t1), taken in float32.
    """

    def __init__(self, f: Callable, t_span: tuple, rtol: float = 1e-5, atol: float = 1e-5,
                 max_steps: int = 10_000):
        t0, t1 = np.float32(t_span[0]), np.float32(t_span[1])
        self.f = f
        self.t0, self.t1 = float(t0), float(t1)
        self.span = float(np.abs(t1 - t0))
        self.direction = float(np.sign(t1 - t0))
        self.rtol, self.atol, self.max_steps = rtol, atol, max_steps

    def _initial_step(self, t0, y0, f0):
        """scipy.integrate._ivp.common.select_initial_step."""
        scale = self.atol + self.rtol * torch.abs(y0)
        d0, d1 = _rms_norm(y0, scale), _rms_norm(f0, scale)
        h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
        y1 = y0 + h0 * self.direction * f0
        f1 = self.f(t0 + h0 * self.direction, y1)
        d2 = _rms_norm(f1 - f0, scale) / h0
        h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), torch.clamp_min(h0 * 1e-3, 1e-6),
                         (0.01 / torch.maximum(d1, d2)) ** 0.2)
        return torch.minimum(100 * h0, h1)

    def start(self, y0: torch.Tensor) -> RK45State:
        """f(t0, y0) and the initial step: 2 evaluations."""
        def scalar(value, dtype):
            return torch.full((), value, dtype=dtype, device=y0.device)

        t0 = scalar(self.t0, torch.float32)
        f0 = self.f(t0, y0)
        h0 = torch.clamp_max(self._initial_step(t0, y0, f0), self.span)
        return RK45State(t0, y0, f0, h0, scalar(2, torch.int32), scalar(0, torch.int32),
                         scalar(0, torch.int32))

    def done(self, state: RK45State) -> torch.Tensor:
        """0-d bool: the end reached, ``max_steps`` attempts made, or status 1."""
        going = ((self.direction * (self.t1 - state.t) > 1e-12) & (state.n < self.max_steps)
                 & (state.status == 0))
        return ~going

    def _step(self, t, y, fk, h):
        """One attempt of size h: (y_new, f_new, err_norm)."""
        hd = h * self.direction
        ks = [fk]
        for i in range(1, 6):
            ks.append(self.f(t + float(_C[i]) * hd, y + hd * _lincomb(_A[i], ks)))
        y_new = y + hd * _lincomb(_B, ks)
        f_new = self.f(t + hd, y_new)
        ks.append(f_new)
        err = hd * _lincomb(_E, ks)
        scale = self.atol + self.rtol * torch.maximum(torch.abs(y), torch.abs(y_new))
        return y_new, f_new, _rms_norm(err, scale)

    def attempt(self, state: RK45State) -> RK45State:
        """One step attempt (6 evaluations), accepted where its error norm is
        at most 1; the step size adapts either way. Once ``done``, the state
        comes back unchanged."""
        t, y, fk, h0, nfev, n, status = state
        active = ~self.done(state)
        h = torch.minimum(h0, torch.abs(self.t1 - t))
        y_new, f_new, err_norm = self._step(t, y, fk, h)
        accept = err_norm <= 1.0
        factor = torch.where(err_norm == 0.0, _MAX_FACTOR,
                             torch.clamp(_SAFETY * err_norm ** _ORDER_EXP, _MIN_FACTOR,
                                         _MAX_FACTOR))
        factor = torch.where(accept, factor, torch.clamp_max(factor, 1.0))
        h_next = h * factor
        status_next = torch.where(h_next < 1e-10, 1, status).to(torch.int32)
        take = active & accept
        return RK45State(
            t=torch.where(take, t + h * self.direction, t),
            y=torch.where(take, y_new, y),
            f=torch.where(take, f_new, fk),
            h=torch.where(active, h_next, h0),
            nfev=nfev + 6 * active.to(torch.int32),
            n=n + active.to(torch.int32),
            status=torch.where(active, status_next, status),
        )


def solve_ivp_rk45(f: Callable, t_span: tuple, y0: torch.Tensor, rtol: float = 1e-5,
                   atol: float = 1e-5, max_steps: int = 10_000,
                   attempts_per_read: int = 1) -> ODEResult:
    """Integrate dy/dt = f(t, y) from t_span[0] to t_span[1] (either
    direction), making ``attempts_per_read`` attempts between two host reads
    of ``done``. Returns ODEResult(y at t1, evaluations, status)."""
    solver = RK45(f, t_span, rtol=rtol, atol=atol, max_steps=max_steps)
    state = solver.start(y0)
    while not bool(solver.done(state)):
        for _ in range(attempts_per_read):
            state = solver.attempt(state)
    return ODEResult(y=state.y, nfev=state.nfev, status=state.status)
