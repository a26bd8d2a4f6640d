"""Test helpers: power-law fitting and the analytic potential-field case.

Ports of the reference's test utilities (utests.py:32-65 and the analytic
case of tests/integration_test/integration_test1.py:57-99).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "power_law_fit",
    "potential_field_case",
    "build_test_mesh",
    "GOLDEN",
    "golden_targets",
    "accuracy_gate",
]

# Golden rows (reference tests/integration_test/results_test1.txt, the
# max-metric table; BASELINE.md): n -> (Ea_max, Eb_max, ref_time_s).
GOLDEN = {
    22: (1.86048e-03, 7.65805e-02, 5.468e-01),
    44: (4.44560e-04, 1.95261e-02, 1.141e00),
    66: (1.94618e-04, 8.72558e-03, 4.344e00),
    77: (1.42398e-04, 6.42133e-03, 7.923e00),
    88: (1.08647e-04, 4.92049e-03, 1.173e01),
    99: (8.56395e-05, 3.89144e-03, 1.587e01),
    160: (3.25317e-05, 1.49319e-03, 6.701e01),
    176: (2.68552e-05, 1.23446e-03, 8.930e01),
    220: (1.71483e-05, 7.90579e-04, 1.741e02),
}

# h^2 prefactors fitted to the golden table (errors = a * dx^2), for
# gating non-golden sizes.
_EA_PREFAC = 1.86048e-03 / 4.76190e-02**2
_EB_PREFAC = 7.65805e-02 / 4.76190e-02**2

#: Relative tolerance of the golden-digit gate and of the h^2-trend gate.
GOLDEN_RTOL = 2e-3
TREND_RTOL = 0.2


def golden_targets(n: int) -> Tuple[float, float, bool]:
    """(Ea_max, Eb_max, is_golden) expected for the analytic case on the
    n^3 integration-test mesh: the golden row when there is one, else
    the fitted h^2 law."""
    if n in GOLDEN:
        return GOLDEN[n][0], GOLDEN[n][1], True
    dx = 1.0 / (n - 1)
    return _EA_PREFAC * dx**2, _EB_PREFAC * dx**2, False


def accuracy_gate(n: int, ea_max: float, eb_max: float) -> Tuple[bool, str]:
    """The benchmark's accuracy gate: golden sizes must match the golden
    digits within 2e-3 relative; other sizes must lie within 20% of the
    h^2 trend.  Returns (ok, description)."""
    g_ea, g_eb, golden = golden_targets(n)
    rtol = GOLDEN_RTOL if golden else TREND_RTOL
    ok = abs(ea_max - g_ea) < rtol * g_ea and abs(eb_max - g_eb) < rtol * g_eb
    kind = "golden" if golden else "h^2 trend"
    return ok, (
        f"Ea_max={ea_max:.5e} (target {g_ea:.5e}) "
        f"Eb_max={eb_max:.5e} (target {g_eb:.5e}) "
        f"{kind} gate rtol={rtol:g}: {'pass' if ok else 'FAIL'}"
    )


def power_law_fit(x: np.ndarray, y: np.ndarray, cov: bool = False):
    """Fit y = A * x^gamma in log-log space; returns (gamma, A, evaluator),
    or (gamma, A, C, evaluator) with the fit covariance when ``cov``
    (reference: utests.py:32-65)."""
    Lx = np.log10(np.asarray(x, dtype=np.float64))
    Ly = np.log10(np.asarray(y, dtype=np.float64))
    if cov:
        p, C = np.polyfit(Lx, Ly, 1, cov=True)
    else:
        p = np.polyfit(Lx, Ly, 1)
    A = 10.0 ** p[1]
    ev = lambda q: A * q ** p[0]  # noqa: E731
    if cov:
        return p[0], A, C, ev
    return p[0], A, ev


def potential_field_case(X, Y, Z, wn: float = np.pi):
    """Analytic potential-field test case with B = curl(A), div B = 0
    (reference: integration_test1.py:57-99): wave number wn = pi*N,
    l = sqrt(2) * wn.

    Args:
      X, Y, Z: broadcastable coordinate arrays (typically (nz, ny, nx)).

    Returns:
      (A, b): exact vector potential and field, shape (3,) + X.shape.
    """
    l = np.sqrt(2 * wn**2)
    shape = np.broadcast(X, Y, Z).shape
    b = np.zeros((3,) + shape)
    A = np.zeros((3,) + shape)
    e = np.exp(-l * Z)
    b[0] = +l * np.sin(wn * X) * np.cos(wn * Y) * e
    b[1] = +l * np.cos(wn * X) * np.sin(wn * Y) * e
    b[2] = +2 * wn * np.cos(wn * X) * np.cos(wn * Y) * e
    A[0] = -np.cos(wn * X) * np.sin(wn * Y) * e
    A[1] = +np.sin(wn * X) * np.cos(wn * Y) * e
    return A, b


def build_test_mesh(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The integration tests' mesh construction (integration_test1.py:
    122-127): x = linspace(0,1,n); y, z = arange(n)*dx."""
    x = np.linspace(0, 1, n)
    dx = x[1] - x[0]
    y = np.arange(n) * dx
    z = np.arange(n) * dx
    return x, y, z
