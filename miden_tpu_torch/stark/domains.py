"""Host-side domain bookkeeping for the lifted STARK.

Mirrors the reference's domain layer (crates/lifted-stark/src/domain.rs):
``LiftedDomain`` = trace subgroup H (order n) + LDE coset s·K (order n·B,
canonical shift ``s = g^(2^(32 − log nB))``) + lift ratio r relative to the
max domain. Canonical shifts satisfy ``s_max^(N/n) = s_n``, which makes
cyclic lifting of evaluations consistent across heights.

Everything here is O(log n) Python-int arithmetic; the big arrays live in
:mod:`miden_tpu_torch.ntt` / the prover.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field import gl


@dataclass(frozen=True)
class LiftedDomain:
    log_trace_height: int
    log_blowup: int
    log_lift_ratio: int = 0

    @classmethod
    def canonical(cls, log_trace_height: int, log_blowup: int) -> "LiftedDomain":
        assert log_trace_height + log_blowup <= gl.TWO_ADICITY
        return cls(log_trace_height, log_blowup, 0)

    def sub_domain(self, smaller_log_trace_height: int) -> "LiftedDomain":
        assert smaller_log_trace_height <= self.log_trace_height
        return LiftedDomain(
            smaller_log_trace_height,
            self.log_blowup,
            self.log_lift_ratio + self.log_trace_height - smaller_log_trace_height,
        )

    # --- sizes ---
    @property
    def trace_height(self) -> int:
        return 1 << self.log_trace_height

    @property
    def log_lde_height(self) -> int:
        return self.log_trace_height + self.log_blowup

    @property
    def lde_height(self) -> int:
        return 1 << self.log_lde_height

    @property
    def lift_ratio(self) -> int:
        return 1 << self.log_lift_ratio

    # --- generators / shifts ---
    @property
    def lde_shift(self) -> int:
        """Canonical coset shift g^(2^(TWO_ADICITY − log_lde_height))
        (domain.rs:358-361)."""
        return gl.canonical_lde_shift(self.log_lde_height)

    @property
    def trace_generator(self) -> int:
        return gl.two_adic_generator(self.log_trace_height)

    @property
    def lde_generator(self) -> int:
        return gl.two_adic_generator(self.log_lde_height)

    # --- scalar (extension-field) helpers for the OOD point ---
    def lift(self, z: tuple) -> tuple:
        """z ↦ z^(2^log_lift_ratio): maps a max-domain point onto this
        domain's polynomial argument (domain.rs selectors_at)."""
        return gl.ext_exp_power_of_2(z, self.log_lift_ratio)

    def vanishing_at(self, z_lifted: tuple) -> tuple:
        """Z_H(z') = z'^n − 1 for the (already lifted) point."""
        zn = gl.ext_exp_power_of_2(z_lifted, self.log_trace_height)
        return gl.ext_sub(zn, (1, 0))

    def selectors_at(self, z: tuple):
        """Unnormalized Lagrange row selectors at an OOD point (lifts z
        internally — domain.rs:505-539): is_first = Z/(z'−1),
        is_last = Z/(z'−ω⁻¹), is_transition = z'−ω⁻¹."""
        zl = self.lift(z)
        vanishing = self.vanishing_at(zl)
        w_inv = gl.inv(self.trace_generator)
        first_den = gl.ext_sub(zl, (1, 0))
        last_den = gl.ext_sub(zl, (w_inv, 0))
        return Selectors(
            is_first_row=gl.ext_mul(vanishing, gl.ext_inv(first_den)),
            is_last_row=gl.ext_mul(vanishing, gl.ext_inv(last_den)),
            is_transition=last_den,
        )

    def contains_base(self, v: tuple, shifted: bool) -> bool:
        """Membership of an extension point in H (shifted=False) or the LDE
        coset (shifted=True)."""
        if shifted:
            s_inv = gl.inv(self.lde_shift)
            v = gl.ext_mul_base(v, s_inv)
            k = self.log_lde_height
        else:
            k = self.log_trace_height
        return gl.ext_exp_power_of_2(v, k) == (1, 0)

    def sample_ood_point(self, channel) -> tuple:
        """Sample z outside {0} ∪ H ∪ sK (domain.rs:539-560)."""
        while True:
            z = channel.sample_ext()
            if z == (0, 0):
                continue
            if self.contains_base(z, shifted=False):
                continue
            if self.contains_base(z, shifted=True):
                continue
            return z


@dataclass(frozen=True)
class Selectors:
    is_first_row: object
    is_last_row: object
    is_transition: object


def log_quotient_degree(max_constraint_degree: int) -> int:
    """Quotient chunk count D = next_pow2(max(1, M − 1)) — domain.rs:585-620."""
    chunks = max(1, max_constraint_degree - 1)
    return (chunks - 1).bit_length()
