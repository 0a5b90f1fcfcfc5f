"""Optimality certificates for portfolio mappings (DESIGN.md §14.2–§14.4).

:func:`certify_mapping` takes a mapping the portfolio produced and sweeps
:func:`~repro_torch.core.exact_backends.joint.solve_joint` over every II below it,
producing a :class:`Certificate` whose machine-readable ``status`` is

* ``"optimal"``   — every lower II is proven impossible (or the portfolio II
  already equals the recomputable mII bound), so ``ii == ii_opt``;
* ``"better-found"`` — the joint search produced a strictly better *valid*
  mapping; the caller should adopt it (``ii_opt`` is then proven optimal,
  since all IIs below it were refuted first);
* ``"timeout"``   — the budget ran out before a verdict; ``ii_lower_bound``
  still carries every II the sweep *did* refute.

A certificate never asks to be trusted: it records the probe outcomes, the
bound ingredients (res/rec/mII) and the final mapping arrays, and
:func:`verify_certificate` re-checks all of it — bound recomputation, probe
coverage, mapping validation and cycle-accurate re-execution — without
invoking the solver. ``tools/check_certificates.py`` wraps that into a CLI
over the BENCH artifacts, and the CI gate compares fresh bench rows against
recorded ``optimal`` certificates (a row regressing past its certified II
fails the build).

Route-through compiles (``max_route_hops > 0``) are certified against the
§14.3 reach-mask relaxation: a relaxed ``unsat`` soundly bounds even
mov-realised mappings, while ``better-found`` claims are only ever made from
direct-model solutions (which are real mappings outright).
"""

from __future__ import annotations

import dataclasses
import time as _time
from dataclasses import dataclass, field

from ... import obs
from ..cgra import CGRA
from ..dfg import DFG
from ..mapper import Mapping, _pressure_offenders, _rebuild_mapping
from ..schedule import min_ii, rec_ii, res_ii
from .joint import solve_joint

__all__ = [
    "CERTIFICATE_VERSION",
    "Certificate",
    "certify_mapping",
    "verify_certificate",
]

#: Bumped whenever the certificate schema or its proof semantics change;
#: the verifier rejects versions it does not understand.
CERTIFICATE_VERSION = 1

_STATUSES = ("optimal", "better-found", "timeout")

#: Default total wall budget of one certification sweep (seconds). Split
#: evenly across the candidate IIs still open below the portfolio result.
DEFAULT_BUDGET_S = 20.0

#: Default per-probe node budget in deterministic mode (load-independent).
DEFAULT_NODE_BUDGET = 2_000_000


@dataclass
class Certificate:
    """A machine-checkable optimality claim about one compiled mapping.

    JSON-shaped throughout (``as_dict``/``from_dict`` round-trip): this is
    what BENCH rows embed and what the independent verifier consumes. The
    ``probes`` list records one entry per solver call —
    ``{"ii", "outcome": "bound" | "unsat" | "sat" | "unknown",
    "reach_hops", "nodes", "wall_s"}`` — and ``mapping`` carries the final
    (possibly adopted) schedule/placement arrays plus route specs so the
    verifier can re-execute it.
    """

    kernel: str
    dfg_hash: str
    cgra: dict
    connectivity: str
    reach_hops: int
    res_ii: int
    rec_ii: int
    m_ii: int
    ii_portfolio: int
    ii: int
    ii_opt: int | None
    ii_lower_bound: int
    status: str
    probes: list[dict] = field(default_factory=list)
    mapping: dict | None = None
    budget: dict = field(default_factory=dict)
    note: str = ""
    version: int = CERTIFICATE_VERSION

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Certificate":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown Certificate keys: {', '.join(unknown)}")
        return cls(**d)


def _cgra_identity(cgra: CGRA) -> dict:
    return {
        "rows": cgra.rows,
        "cols": cgra.cols,
        "topology": cgra.topology,
        "arch_token": cgra.arch_token(),
    }


def _mapping_payload(mapping: Mapping) -> dict:
    return {
        "ii": mapping.ii,
        "t_abs": list(mapping.t_abs),
        "placement": list(mapping.placement),
        "routes": [list(s) for s in mapping.routes_spec()],
    }


def certify_mapping(
    dfg: DFG,
    cgra: CGRA,
    mapping: Mapping,
    *,
    connectivity: str = "strict",
    max_route_hops: int = 0,
    max_register_pressure: int | None = None,
    budget_s: float = DEFAULT_BUDGET_S,
    node_budget: int | None = None,
    deterministic: bool = False,
) -> tuple[Certificate, Mapping | None]:
    """Certify (or beat) a portfolio mapping's II.

    ``dfg`` is the *original* kernel (for routed mappings, ``mapping.dfg``
    is the mov-spliced rewrite — the model sweeps the original). Returns
    ``(certificate, better_mapping)`` where ``better_mapping`` is a fully
    validated replacement when ``status == "better-found"`` and None
    otherwise. Deterministic mode drops the wall deadline and bounds every
    probe by ``node_budget`` joint-search nodes instead.
    """
    start = _time.perf_counter()
    r_ii, c_ii = res_ii(dfg, cgra), rec_ii(dfg)
    m_ii = min_ii(dfg, cgra)
    hops = 1 + max_route_hops
    if node_budget is None and deterministic:
        node_budget = DEFAULT_NODE_BUDGET
    cert = Certificate(
        kernel=dfg.name,
        dfg_hash=dfg.stable_hash(),
        cgra=_cgra_identity(cgra),
        connectivity=connectivity,
        reach_hops=hops,
        res_ii=r_ii,
        rec_ii=c_ii,
        m_ii=m_ii,
        ii_portfolio=mapping.ii,
        ii=mapping.ii,
        ii_opt=None,
        ii_lower_bound=m_ii,
        status="timeout",
        mapping=_mapping_payload(mapping),
        budget={
            "budget_s": None if deterministic else budget_s,
            "node_budget": node_budget,
            "deterministic": deterministic,
        },
    )

    if mapping.ii <= m_ii:
        # the recomputable bound already meets the result: free proof
        cert.status = "optimal"
        cert.ii_opt = mapping.ii
        cert.ii_lower_bound = mapping.ii
        cert.probes.append({"ii": mapping.ii, "outcome": "bound",
                            "reach_hops": hops, "nodes": 0, "wall_s": 0.0})
        return cert, None

    candidates = list(range(m_ii, mapping.ii))
    better: Mapping | None = None
    for k in candidates:
        if deterministic:
            deadline_k = None
        else:
            # the lowest unresolved II gates every claim (optimal needs all
            # of them refuted, better-found needs everything below its sat
            # refuted), so each probe may spend the whole remaining budget
            deadline_k = budget_s - (_time.perf_counter() - start)
            if deadline_k <= 0:
                cert.note = f"budget exhausted before probing II={k}"
                break

        # direct model first: a sat here is a real mapping whatever the
        # route allowance was, and with hops == 1 its unsat is the proof
        with obs.span("exact.probe", kernel=dfg.name, ii=k,
                      reach_hops=1) as sp:
            out = solve_joint(dfg, cgra, k, reach_hops=1,
                              node_budget=node_budget, deadline_s=deadline_k)
            sp.set(outcome=out.status, nodes=out.nodes_visited)
        cert.probes.append({"ii": k, "outcome": out.status, "reach_hops": 1,
                            "nodes": out.nodes_visited,
                            "wall_s": round(out.wall_s, 4)})
        if out.status == "sat":
            assert out.mapping is not None
            errs = out.mapping.validate(connectivity=connectivity,
                                        registers=False)
            if errs:                            # pragma: no cover - solver bug
                cert.note = f"joint solution at II={k} failed validation: {errs[0]}"
                break
            if max_register_pressure is not None and _pressure_offenders(
                    out.mapping, max_register_pressure):
                cert.note = (
                    f"II={k} achievable but exceeds the requested register "
                    f"bound; optimality under that bound undecided"
                )
                break
            better = out.mapping
            cert.status = "better-found"
            cert.ii = k
            cert.ii_opt = k
            cert.mapping = _mapping_payload(better)
            cert.note = (
                f"strictly better mapping found and proven optimal at II={k} "
                f"(portfolio gave II={cert.ii_portfolio})"
            )
            return cert, better
        if out.status == "unsat":
            if hops > 1:
                # direct impossibility does not bound mov-realised mappings:
                # refute the reach-relaxed model too (§14.3)
                with obs.span("exact.probe", kernel=dfg.name, ii=k,
                              reach_hops=hops) as sp:
                    rout = solve_joint(dfg, cgra, k, reach_hops=hops,
                                       node_budget=node_budget,
                                       deadline_s=deadline_k)
                    sp.set(outcome=rout.status, nodes=rout.nodes_visited)
                cert.probes.append({
                    "ii": k, "outcome": rout.status, "reach_hops": hops,
                    "nodes": rout.nodes_visited,
                    "wall_s": round(rout.wall_s, 4),
                })
                if rout.status == "sat":
                    cert.note = (
                        f"reach-relaxed model satisfiable at II={k}; "
                        f"route-aware optimality undecided"
                    )
                    break
                if rout.status == "unknown":
                    cert.note = f"relaxed probe at II={k} ran out of budget"
                    break
            cert.ii_lower_bound = k + 1
            continue
        cert.note = f"probe at II={k} ran out of budget"
        break

    if cert.ii_lower_bound >= cert.ii_portfolio:
        cert.status = "optimal"
        cert.ii_opt = cert.ii_portfolio
    return cert, better


# --------------------------------------------------------------- verification

def verify_certificate(
    cert: Certificate | dict,
    dfg: DFG,
    cgra: CGRA,
    *,
    check_execution: bool = True,
) -> list[str]:
    """Independently re-check a certificate; returns violations (empty = ok).

    Trusts nothing derivable: recomputes the res/rec/mII bound from the DFG
    and architecture, re-walks the probe list to confirm the claimed lower
    bound is covered by ``unsat`` probes at the right relaxation level,
    re-validates the embedded mapping against every §2 constraint, and (by
    default) re-executes it cycle-accurately against the sequential oracle
    (``simulate.check_equivalence`` → ``execute_mapping``). The solver's
    ``unsat`` verdicts themselves are the one thing only a re-solve could
    re-check; everything else is recomputed here.
    """
    errs: list[str] = []
    if isinstance(cert, Certificate):
        cert = cert.as_dict()
    try:
        cert = Certificate.from_dict(dict(cert))
    except (TypeError, ValueError) as exc:
        return [f"malformed certificate: {exc}"]
    if cert.version != CERTIFICATE_VERSION:
        return [f"unsupported certificate version {cert.version}"]
    if cert.status not in _STATUSES:
        errs.append(f"unknown status {cert.status!r}")

    if cert.dfg_hash != dfg.stable_hash():
        errs.append(
            f"dfg hash mismatch: certificate {cert.dfg_hash[:12]}…, "
            f"kernel {dfg.stable_hash()[:12]}…"
        )
    ident = _cgra_identity(cgra)
    if cert.cgra != ident:
        errs.append(f"architecture mismatch: certificate {cert.cgra}, target {ident}")
    if errs:
        return errs                     # wrong problem: nothing else is meaningful

    # ---- bound recomputation (independent of the solver) ----
    r_ii, c_ii = res_ii(dfg, cgra), rec_ii(dfg)
    m_ii = max(r_ii, c_ii)
    if (cert.res_ii, cert.rec_ii, cert.m_ii) != (r_ii, c_ii, m_ii):
        errs.append(
            f"bound mismatch: certificate res/rec/mII = "
            f"{cert.res_ii}/{cert.rec_ii}/{cert.m_ii}, recomputed "
            f"{r_ii}/{c_ii}/{m_ii}"
        )

    # ---- probe coverage: every II in [mII, lower_bound) must be refuted
    # at the certificate's relaxation level (direct when reach_hops == 1) ----
    refuted = {
        p.get("ii")
        for p in cert.probes
        if p.get("outcome") == "unsat" and p.get("reach_hops") == cert.reach_hops
    }
    if cert.reach_hops > 1:
        # a relaxed refutation is only sound if the direct model was refuted
        # too (certify always probes direct first); require both on record
        direct = {
            p.get("ii") for p in cert.probes
            if p.get("outcome") == "unsat" and p.get("reach_hops") == 1
        }
        refuted &= direct
    covered = m_ii
    while covered in refuted:
        covered += 1
    if cert.ii_lower_bound > covered and cert.ii_lower_bound > m_ii:
        errs.append(
            f"ii_lower_bound={cert.ii_lower_bound} not covered by unsat "
            f"probes (refuted up to {covered})"
        )
    if cert.ii_lower_bound < m_ii:
        errs.append(
            f"ii_lower_bound={cert.ii_lower_bound} below recomputed mII={m_ii}"
        )

    if cert.status == "optimal":
        if cert.ii_opt != cert.ii:
            errs.append(f"optimal status but ii_opt={cert.ii_opt} != ii={cert.ii}")
        if cert.ii > m_ii and covered < cert.ii:
            errs.append(
                f"optimal status but IIs {covered}..{cert.ii - 1} were never refuted"
            )
    elif cert.status == "better-found":
        if cert.ii_opt != cert.ii or cert.ii >= cert.ii_portfolio:
            errs.append(
                f"better-found status inconsistent: ii={cert.ii}, "
                f"ii_opt={cert.ii_opt}, portfolio={cert.ii_portfolio}"
            )
        if cert.ii > m_ii and covered < cert.ii:
            errs.append(
                f"better-found at II={cert.ii} but IIs {covered}..{cert.ii - 1} "
                f"were never refuted"
            )
        sat_ok = any(
            p.get("outcome") == "sat" and p.get("ii") == cert.ii
            and p.get("reach_hops") == 1
            for p in cert.probes
        )
        if not sat_ok:
            errs.append("better-found status without a direct sat probe on record")
    elif cert.status == "timeout":
        if cert.ii_opt is not None:
            errs.append(f"timeout status must not claim ii_opt={cert.ii_opt}")

    # ---- mapping re-validation + re-execution ----
    if cert.mapping is None:
        errs.append("certificate carries no mapping payload")
        return errs
    try:
        mp = cert.mapping
        mapping = _rebuild_mapping(
            dfg, cgra, int(mp["ii"]), list(mp["t_abs"]),
            list(mp["placement"]), [tuple(s) for s in mp.get("routes", [])],
        )
    except (KeyError, ValueError, IndexError, TypeError) as exc:
        errs.append(f"mapping payload does not reconstruct: {exc}")
        return errs
    if mapping.ii != cert.ii:
        errs.append(f"mapping II {mapping.ii} != certified ii {cert.ii}")
    verrs = mapping.validate(connectivity=cert.connectivity, registers=False)
    errs.extend(f"mapping invalid: {e}" for e in verrs)
    if check_execution and not verrs:
        from ..simulate import check_equivalence

        try:
            if not check_equivalence(mapping):
                errs.append("mapping re-execution diverged from the DFG oracle")
        except Exception as exc:            # execute_mapping hard-errors
            errs.append(f"mapping re-execution failed: {exc}")
    return errs
