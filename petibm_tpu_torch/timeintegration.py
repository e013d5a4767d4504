"""Time-integration coefficient tables.

Copy of ``petibm_tpu/timeintegration.py`` (held equal to the original by
tests/test_torch_host.py).

Reference (include/petibm/timeintegration.h:100-171): each scheme is just
{implicitCoeff, explicitCoeffs}; the solver applies them to the implicit
operator and the explicit term history ring buffers.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TimeIntegration:
    name: str
    implicit_coeff: float
    explicit_coeffs: tuple[float, ...]

    @property
    def n_explicit(self) -> int:
        return len(self.explicit_coeffs)


SCHEMES = {
    "EULER_EXPLICIT": TimeIntegration("EULER_EXPLICIT", 0.0, (1.0,)),
    "EULER_IMPLICIT": TimeIntegration("EULER_IMPLICIT", 1.0, ()),
    "ADAMS_BASHFORTH_2": TimeIntegration("ADAMS_BASHFORTH_2", 0.0, (1.5, -0.5)),
    "CRANK_NICOLSON": TimeIntegration("CRANK_NICOLSON", 0.5, (0.5,)),
}


def create_time_integration(name: str, config: dict) -> TimeIntegration:
    """Read ``parameters.<name>`` (convection | diffusion) like the
    reference factory (src/timeintegration/timeintegration.cpp:40).
    Defaults match the reference apps' expectations: convection
    ADAMS_BASHFORTH_2, diffusion CRANK_NICOLSON."""
    default = "ADAMS_BASHFORTH_2" if name == "convection" else "CRANK_NICOLSON"
    key = config.get("parameters", {}).get(name, default)
    if key not in SCHEMES:
        raise ValueError(f"unknown time-integration scheme: {key}")
    return SCHEMES[key]
