"""Single-device satisfiability checking of the port."""

from .sat_check import ResidueSystem, crt_primes

__all__ = ["ResidueSystem", "crt_primes"]
