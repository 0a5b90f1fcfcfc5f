"""The port's fuzz generator and differential harness against the JAX package's.

``repro_torch.core.fuzz`` is a copy of the reference's module: both
``random_dfg`` give equal DFGs for seeds 0-203. The validity, joint-parity
and certificate cases of ``tests/test_differential.py`` run against the port
at the reference's ``FUZZ_SEEDS`` budget (marked ``fuzz``), with the
harness's tight deterministic mapper budgets, and on one chunk of seeds the
port's deterministic mappings equal the reference's on every fabric and
space backend.
"""

from __future__ import annotations

import os

import pytest

from repro.core import CGRA as JCGRA
from repro.core import map_dfg as jmap_dfg
from repro.core.fuzz import random_dfg as jrandom_dfg
from repro_torch.core import CGRA, map_dfg, min_ii
from repro_torch.core.exact_backends import (
    certify_mapping,
    solve_joint,
    verify_certificate,
)
from repro_torch.core.fuzz import random_dfg
from repro_torch.core.simulate import check_equivalence

# Seeds per (fabric, backend) config, as in tests/test_differential.py:
# 6 configs x 34 seeds = 204 mapped cases at the floor.
FUZZ_SEEDS = max(34, int(os.environ.get("REPRO_FUZZ_CASES", "0")) // 6)
_CHUNK = 17
#: the seeds whose generated DFGs are compared with the reference's
GENERATOR_SEEDS = 204

_FABRICS = [
    pytest.param("mesh3x3", dict(rows=3, cols=3), id="mesh3x3"),
    pytest.param("torus4x4", dict(rows=4, cols=4, topology="torus"),
                 id="torus4x4"),
    pytest.param("onehop4x4", dict(rows=4, cols=4, topology="one-hop"),
                 id="onehop4x4"),
]
_BACKENDS = ["exact", "anneal"]


def _chunks(n):
    return [(lo, min(lo + _CHUNK, n)) for lo in range(0, n, _CHUNK)]


_CHUNKS = _chunks(FUZZ_SEEDS)
_IDS = [f"seeds{lo}-{hi - 1}" for lo, hi in _CHUNKS]

_MAP_KW = dict(
    deterministic=True,
    use_cache=False,
    det_space_cap=4000,
    max_retries_per_window=1,
    max_slack=1,
)


def _compile(seed: int, fabric_kw: dict, backend: str):
    dfg = random_dfg(seed)
    cgra = CGRA(**fabric_kw)
    res = map_dfg(dfg, cgra, space_backend=backend, **_MAP_KW)
    return dfg, cgra, res


# ----------------------------------------------------------------- generator

@pytest.mark.parametrize("lo,hi", _chunks(GENERATOR_SEEDS),
                         ids=[f"seeds{lo}-{hi - 1}" for lo, hi in _chunks(GENERATOR_SEEDS)])
def test_random_dfg_matches_reference(lo, hi):
    for seed in range(lo, hi):
        mine, ref = random_dfg(seed), jrandom_dfg(seed)
        assert mine.to_json() == ref.to_json(), f"seed={seed}"
        assert mine.stable_hash() == ref.stable_hash(), f"seed={seed}"


def test_random_dfg_knobs_match_reference():
    knobs = dict(min_nodes=8, max_nodes=14, p_second_operand=0.9, p_carried=0.9,
                 p_mem=0.6, p_mul=0.5, name="knobs")
    for seed in range(20):
        assert random_dfg(seed, **knobs).to_json() == jrandom_dfg(seed, **knobs).to_json()


# ------------------------------------------- tests/test_differential.py's cases

@pytest.mark.fuzz
@pytest.mark.parametrize("fabric_id,fabric_kw", _FABRICS)
@pytest.mark.parametrize("backend", _BACKENDS)
@pytest.mark.parametrize("lo,hi", _CHUNKS, ids=_IDS)
def test_fuzz_valid_and_equivalent(fabric_id, fabric_kw, backend, lo, hi):
    """Every accepted mapping validates and executes correctly."""
    mapped = 0
    for seed in range(lo, hi):
        dfg, cgra, res = _compile(seed, fabric_kw, backend)
        if not res.ok:
            continue
        mapped += 1
        case = f"seed={seed} fabric={fabric_id} backend={backend}"
        problems = res.mapping.validate()
        assert problems == [], f"{case}: {problems}"
        check_equivalence(res.mapping)
        assert res.mapping.ii >= min_ii(dfg, cgra), (
            f"{case}: ii {res.mapping.ii} below the structural bound"
        )
    assert mapped > (hi - lo) // 2, f"only {mapped}/{hi - lo} cases mapped"


@pytest.mark.fuzz
@pytest.mark.parametrize("fabric_id,fabric_kw", _FABRICS)
@pytest.mark.parametrize("lo,hi", _CHUNKS, ids=_IDS)
def test_fuzz_joint_never_refutes_a_witness(fabric_id, fabric_kw, lo, hi):
    """The joint encoding may never call a portfolio mapping's II unsat."""
    for seed in range(lo, hi):
        dfg, cgra, res = _compile(seed, fabric_kw, "exact")
        if not res.ok or res.mapping.num_route_movs:
            continue
        out = solve_joint(dfg, cgra, res.mapping.ii, node_budget=200_000)
        assert out.status != "unsat", (
            f"seed={seed} fabric={fabric_id}: joint refuted II="
            f"{res.mapping.ii} but the portfolio holds a witness"
        )
        if out.status == "sat" and out.mapping is not None:
            assert out.mapping.validate() == [], f"seed={seed} joint witness invalid"
            check_equivalence(out.mapping)


@pytest.mark.fuzz
@pytest.mark.parametrize("lo,hi", _CHUNKS, ids=_IDS)
def test_fuzz_certificates_verify(lo, hi):
    """Certificates on fuzz mappings re-verify and bound correctly."""
    for seed in range(lo, hi):
        dfg, cgra, res = _compile(seed, dict(rows=3, cols=3), "exact")
        if not res.ok:
            continue
        cert, better = certify_mapping(
            dfg, cgra, res.mapping, budget_s=3.0, deterministic=True
        )
        case = f"seed={seed} status={cert.status}"
        assert verify_certificate(cert, dfg, cgra) == [], case
        assert cert.m_ii >= min_ii(dfg, cgra)
        if cert.ii_opt is not None:
            assert cert.m_ii <= cert.ii_opt <= res.mapping.ii, case
            final_ii = better.ii if better is not None else res.mapping.ii
            assert final_ii == cert.ii_opt, case
        else:
            assert cert.status == "timeout", case
        if better is not None:
            assert better.validate() == []
            check_equivalence(better)


# ------------------------------------------------ parity with the reference

def _mapping_view(res):
    if not res.ok:
        return (False, res.reason)
    m = res.mapping
    return (True, m.ii, m.t_abs, m.placement, m.labels,
            [tuple(r) for r in m.routes_spec()])


@pytest.mark.fuzz
@pytest.mark.parametrize("fabric_id,fabric_kw", _FABRICS)
@pytest.mark.parametrize("backend", _BACKENDS)
def test_fuzz_mappings_match_reference(fabric_id, fabric_kw, backend):
    lo, hi = _CHUNKS[0]
    for seed in range(lo, hi):
        mine = map_dfg(random_dfg(seed), CGRA(**fabric_kw), space_backend=backend,
                       **_MAP_KW)
        ref = jmap_dfg(jrandom_dfg(seed), JCGRA(**fabric_kw), space_backend=backend,
                       **_MAP_KW)
        assert _mapping_view(mine) == _mapping_view(ref), (
            f"seed={seed} fabric={fabric_id} backend={backend}")
