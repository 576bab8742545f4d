"""Ballistic physics simulator (port of `bcnf_tpu/simulation/physics.py`).

Fixed-step RK4 on the velocity ODE, batched over leading axes, in float32
on the caller's device. The JAX package's two `lax.scan`s become loops over
tensors: RK4 velocities on the grid `t = arange(0, T, dt)` (with
`n_substeps` RK4 steps per grid step), then explicit-Euler positions with
the *new* velocity, freezing each row at its interpolated ground crossing
(branch-free, with masks).

The drag term is the reference's elementwise
``v**2 * v / ||v|| - w**2 * w / ||w||`` form with the safe-norm guard for
``||w|| = 0``; it defines the data distribution, so it is kept as is.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from bcnf_tpu_torch.utils.misc import resolve_device

FAR_AWAY = 999.0  # runaway sentinel
IMPACT_TIME_CAP = 120.0
# `point_of_impact` checks every this many steps, with one host sync, whether
# every row has settled, and leaves its loop then (see its docstring)
IMPACT_CHECK_EVERY = 64


def _safe_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """||x|| that is safe to divide by: 1 where the norm underflows.

    The numerator ``x**2 * x`` is exactly 0 when x == 0, so dividing by 1
    instead of 0 gives the right limit 0 (the reference NaNs at w = 0).
    """
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n > eps, n, torch.ones_like(n))


def ballistic_ode(
    v: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    m: torch.Tensor,
    rho: torch.Tensor,
    r: torch.Tensor,
    a: torch.Tensor,
) -> torch.Tensor:
    """dv/dt = gravity - buoyancy - drag + thrust.

    Shapes: `v, g, w, a` are `(..., 3)`; `b, m, rho, r` are `(...,)`.
    """
    b = b[..., None]
    m = m[..., None]
    rho = rho[..., None]
    r = r[..., None]
    buoyancy = g * rho * (4.0 / 3.0) * (math.pi * r**3) / m
    drag = (0.5 * b / m) * (v**2 * v / _safe_norm(v) - w**2 * w / _safe_norm(w))
    return g - buoyancy - drag + a


def _rk4_step(v: torch.Tensor, dt: float, ode_args: tuple) -> torch.Tensor:
    """One classical RK4 step of the (autonomous) velocity ODE."""
    k1 = ballistic_ode(v, *ode_args)
    k2 = ballistic_ode(v + 0.5 * dt * k1, *ode_args)
    k3 = ballistic_ode(v + 0.5 * dt * k2, *ode_args)
    k4 = ballistic_ode(v + dt * k3, *ode_args)
    return v + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def n_steps_for(T: float, dt: float) -> int:
    """Length of the reference time grid `np.arange(0, T, dt)`."""
    return int(math.ceil((T - 1e-12) / dt))


def simulate_trajectory(
    x0: torch.Tensor,
    v0: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    m: torch.Tensor,
    rho: torch.Tensor,
    r: torch.Tensor,
    a: torch.Tensor,
    n_steps: int,
    dt: float,
    break_on_impact: bool = True,
    n_substeps: int = 1,
) -> torch.Tensor:
    """Position trajectories, shape `(..., n_steps, 3)`, on the inputs' device.

    All parameter tensors broadcast over leading axes. The first output row
    is `x0`.
    """
    ode_args = (g, w, b, m, rho, r, a)
    sub_dt = dt / n_substeps
    v = v0
    vs = []
    for _ in range(n_steps - 1):
        for _ in range(n_substeps):
            v = _rk4_step(v, sub_dt, ode_args)
        vs.append(v)

    x = x0
    impacted = torch.zeros(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    xs = [x0]
    for v_i in vs:
        x_new = x + v_i * dt
        below = x_new[..., 2] < 0
        hit = below & ~impacted if break_on_impact else torch.zeros_like(below)
        # interpolated crossing: t* = -z_prev / vz
        vz = v_i[..., 2]
        t_star = -x[..., 2] / torch.where(vz.abs() > 1e-12, vz, torch.ones_like(vz))
        x_impact = x + v_i * t_star[..., None]
        x = torch.where(impacted[..., None], x, torch.where(hit[..., None], x_impact, x_new))
        impacted = impacted | hit
        xs.append(x)
    return torch.stack(torch.broadcast_tensors(*xs), dim=-2)


def _vec(*xs: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(xs, dtype=torch.float32, device=device)


def physics_ODE_simulation(
    x0_x: float, x0_y: float, x0_z: float,
    v0_x: float, v0_y: float, v0_z: float,
    g_x: float, g_y: float, g_z: float,
    w_x: float, w_y: float, w_z: float,
    b: float, m: float, rho: float, r: float,
    a_x: float, a_y: float, a_z: float,
    T: float = 10.0,
    dt: float = 0.1,
    break_on_impact: bool = True,
    *args: Any,
    device: str | torch.device | None = None,
    **kwargs: Any,
) -> np.ndarray:
    """Scalar-argument API: one trajectory, a NumPy array `(n_steps, 3)`.
    Extra arguments are ignored, as in the reference."""
    dev = resolve_device(device)
    out = simulate_trajectory(
        _vec(x0_x, x0_y, x0_z, device=dev), _vec(v0_x, v0_y, v0_z, device=dev),
        _vec(g_x, g_y, g_z, device=dev), _vec(w_x, w_y, w_z, device=dev),
        _vec(b, device=dev)[0], _vec(m, device=dev)[0], _vec(rho, device=dev)[0], _vec(r, device=dev)[0],
        _vec(a_x, a_y, a_z, device=dev),
        n_steps=n_steps_for(T, dt), dt=dt, break_on_impact=break_on_impact,
    )
    return out.cpu().numpy()


def point_of_impact(
    x0: torch.Tensor,
    v0: torch.Tensor,
    g: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    m: torch.Tensor,
    rho: torch.Tensor,
    r: torch.Tensor,
    a: torch.Tensor,
    dt: float = 0.1,
    max_steps: int | None = None,
    stats: dict | None = None,
) -> torch.Tensor:
    """Ground-impact point, shape `(..., 3)`; `[999, 999, 999]` if airborne
    past 120 s.

    Keeps the reference's quirks: the position update uses the velocity at
    the *start* of the step, and so does the impact interpolation
    `t* = -z/vz`.

    The loop leaves early, once every row has settled, and returns exactly
    what the full loop returns: a row that is done no longer changes its
    `x`, `v` or `poi`, and a row whose height or vertical velocity is NaN
    can never hit (its new height stays NaN, and NaN < 0 is false), so it
    ends at the sentinel either way. It checks every `IMPACT_CHECK_EVERY`
    steps (one host sync each). On a CUDA device each run of
    `IMPACT_CHECK_EVERY` steps is a CUDA graph's replay (`_ImpactGraph`),
    with the eager loop's result. `stats`, when given, gets the number of
    steps run under ``"steps"``.
    """
    if max_steps is None:
        max_steps = int(IMPACT_TIME_CAP / dt)
    ode_args = (g, w, b, m, rho, r, a)
    batch_shape = torch.broadcast_shapes(x0.shape[:-1], b.shape)
    state = (
        x0.expand(batch_shape + (3,)),
        v0.expand(batch_shape + (3,)),
        torch.zeros(batch_shape, dtype=torch.bool, device=x0.device),
        torch.full(batch_shape + (3,), FAR_AWAY, dtype=x0.dtype, device=x0.device),
    )
    graph = None
    step = 0
    while step < max_steps:
        n = min(IMPACT_CHECK_EVERY, max_steps - step)
        if n == IMPACT_CHECK_EVERY and x0.is_cuda and state[0].numel() > 0:
            if graph is None:
                graph = _ImpactGraph(state, n, dt, ode_args)
            state = graph.replay()
        else:
            state = _impact_steps(state, n, dt, ode_args)
        step += n
        if n == IMPACT_CHECK_EVERY:
            x, v, done, _ = state
            if bool((done | torch.isnan(x[..., 2]) | torch.isnan(v[..., 2])).all()):
                break
    if stats is not None:
        stats["steps"] = step
    done, poi = state[2], state[3]
    return torch.where(done[..., None], poi, torch.full_like(poi, FAR_AWAY))


def _impact_steps(state: tuple, n: int, dt: float, ode_args: tuple) -> tuple:
    """`n` steps of `point_of_impact`'s loop on its state `(x, v, done, poi)`."""
    x, v, done, poi = state
    for _ in range(n):
        x_new = x + v * dt
        hit = (x_new[..., 2] < 0) & ~done
        vz = v[..., 2]
        t_star = -x[..., 2] / torch.where(vz.abs() > 1e-12, vz, torch.ones_like(vz))
        x_impact = x + v * t_star[..., None]
        poi = torch.where(hit[..., None], x_impact, poi)
        done = done | hit
        v_new = _rk4_step(v, dt, ode_args)
        x = torch.where(done[..., None], x, x_new)
        v = torch.where(done[..., None], v, v_new)
    return x, v, done, poi


class _ImpactGraph:
    """`n` steps of the impact loop captured once as a CUDA graph and
    replayed in place on a static copy of the state. A step is ~130 small
    kernels, so the eager loop is bound by their launches on the host; the
    replay runs the same kernels in the same order, so it returns the eager
    loop's bits. The parameters (`ode_args`) are read in place, and must
    outlive the graph."""

    def __init__(self, state: tuple, n: int, dt: float, ode_args: tuple) -> None:
        self.static = [t.clone() for t in state]
        # warm-up on a side stream, as CUDA graph capture asks (its results are dropped)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _impact_steps(tuple(t.clone() for t in state), 1, dt, ode_args)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = _impact_steps(tuple(self.static), n, dt, ode_args)
            for dst, src in zip(self.static, out):
                dst.copy_(src)

    def replay(self) -> tuple:
        self.graph.replay()
        return tuple(self.static)


def calculate_point_of_impact(
    x0_x: float, x0_y: float, x0_z: float,
    v0_x: float, v0_y: float, v0_z: float,
    g_x: float, g_y: float, g_z: float,
    w_x: float, w_y: float, w_z: float,
    b: float, m: float, rho: float, r: float,
    a_x: float, a_y: float, a_z: float,
    dt: float = 0.1,
    *args: Any,
    device: str | torch.device | None = None,
    **kwargs: Any,
) -> np.ndarray:
    """Scalar-argument API: one impact point, a NumPy array `(3,)`."""
    dev = resolve_device(device)
    out = point_of_impact(
        _vec(x0_x, x0_y, x0_z, device=dev), _vec(v0_x, v0_y, v0_z, device=dev),
        _vec(g_x, g_y, g_z, device=dev), _vec(w_x, w_y, w_z, device=dev),
        _vec(b, device=dev)[0], _vec(m, device=dev)[0], _vec(rho, device=dev)[0], _vec(r, device=dev)[0],
        _vec(a_x, a_y, a_z, device=dev),
        dt=dt,
    )
    return out.cpu().numpy()
