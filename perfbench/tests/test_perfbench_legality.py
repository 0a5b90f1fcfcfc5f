"""The benchmark's legality checker and mII, on the CPU."""

from __future__ import annotations

import pytest

from perfbench import legality, suite
from perfbench.reference import PlainDFG

CONFIGS = ["table3-mesh20", "table3-mesh4"]


def _frozen(config: str, kernel: str):
    cfg = suite.load_config(config)
    return PlainDFG.load(suite.dfg_path(kernel)), suite.mesh(cfg), suite.load_frozen_mapping(
        config, kernel)


@pytest.mark.parametrize("config", CONFIGS)
def test_a_moved_node_is_refused(config):
    plain, mesh, m = _frozen(config, "hotspot3D")
    assert legality.violations(plain, mesh, m["ii"], m["t_abs"], m["placement"]) == []
    src, dst = plain.edges[0][:2]
    # to a PE away from every neighbour's: the edge joins non-adjacent PEs
    far = max(range(mesh.num_pes), key=lambda p: sum(
        abs(divmod(p, mesh.cols)[i] - divmod(m["placement"][dst], mesh.cols)[i]) for i in (0, 1)))
    moved = list(m["placement"])
    moved[src] = far
    errs = legality.violations(plain, mesh, m["ii"], m["t_abs"], moved)
    assert any("not adjacent" in e or "share PE" in e for e in errs)
    # onto the PE and step of another node
    clash = list(m["placement"])
    other = next(v for v in range(plain.num_nodes) if v != src
                 and m["t_abs"][v] % m["ii"] == m["t_abs"][src] % m["ii"])
    clash[src] = clash[other]
    assert any("share PE" in e for e in legality.violations(
        plain, mesh, m["ii"], m["t_abs"], clash))
    # a consumer scheduled before its producer
    late = list(m["t_abs"])
    late[src] = m["t_abs"][src] + m["ii"] * 100   # same step, far too late
    assert any("before it is produced" in e for e in legality.violations(
        plain, mesh, m["ii"], late, m["placement"]))
    assert legality.violations(plain, mesh, 0, m["t_abs"], m["placement"])
    assert legality.violations(plain, mesh, m["ii"], m["t_abs"][:-1], m["placement"])
    off = list(m["placement"])
    off[0] = mesh.num_pes
    assert any("off the fabric" in e for e in legality.violations(
        plain, mesh, m["ii"], m["t_abs"], off))


@pytest.mark.parametrize("config", CONFIGS)
def test_mii_equals_the_ports_on_the_suite(config):
    from repro_torch.core.schedule import min_ii, rec_ii, res_ii

    cfg = suite.load_config(config)
    dfgs, cgra, mesh = suite.port_dfgs(cfg), suite.port_cgra(cfg), suite.mesh(cfg)
    for k, plain in suite.plain_dfgs(cfg).items():
        assert legality.res_ii(plain, mesh) == res_ii(dfgs[k], cgra), k
        assert legality.rec_ii(plain) == rec_ii(dfgs[k]), k
        assert legality.min_ii(plain, mesh) == min_ii(dfgs[k], cgra), k


def test_mii_of_table3_at_20x20_is_recii():
    """At 20x20 ResII is 1, so mII is Table III's RecII."""
    from repro_torch.core.benchsuite import TABLE3_BENCHMARKS

    mesh = legality.Mesh(20, 20)
    for k, (nodes, rec) in TABLE3_BENCHMARKS.items():
        plain = PlainDFG.load(suite.dfg_path(k))
        assert plain.num_nodes == nodes
        assert legality.min_ii(plain, mesh) == rec, k


def test_closed_degree():
    assert legality.Mesh(2, 2).closed_degree() == 3
    assert legality.Mesh(4, 4).closed_degree() == 5
    assert legality.Mesh(20, 20).closed_degree() == 5
