"""Exact joint time+space backend and optimality certificates (DESIGN.md §14).

The portfolio mapper (core/mapper.py) is a heuristic: its IIs are good but
unproven. This package adds the missing ground truth — a complete joint
search over (kernel step, PE) assignments per DFG node that either proves no
mapping exists at a candidate II (``solve_joint`` → ``unsat``) or produces a
real, independently validated mapping (``sat``). ``certify.py`` drives it
over every II below a portfolio result and emits a machine-checkable
:class:`~repro_torch.core.exact_backends.certify.Certificate` with status
``optimal | better-found | timeout``; ``tools/check_certificates.py``
re-validates certificates without trusting the solver.

The related SAT-MapIt line (PAPERS.md) and DRMT-style ILP schedulers encode
this with quotient/remainder modulo variables in an external solver; the
container ships neither z3 nor OR-Tools, so the same model is implemented
here as a self-contained propagate-and-backtrack search over bitmask domains
(no dependencies beyond the stdlib, deterministic under node budgets).
"""

from .certify import (
    CERTIFICATE_VERSION,
    Certificate,
    certify_mapping,
    verify_certificate,
)
from .joint import JointOutcome, solve_joint

__all__ = [
    "CERTIFICATE_VERSION",
    "Certificate",
    "JointOutcome",
    "certify_mapping",
    "solve_joint",
    "verify_certificate",
]
