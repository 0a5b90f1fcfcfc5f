"""The frozen inputs: DFGs as the port generates them today, mappings legal."""

from __future__ import annotations

import pytest

from perfbench import freeze, legality, suite
from perfbench.reference import PlainDFG

CONFIGS = ["table3-mesh20", "table3-mesh4"]
KERNELS = suite.load_config("table3-mesh20")["kernels"]


def test_frozen_dfgs_equal_benchsuite():
    texts = freeze.dfg_texts()
    assert sorted(texts) == sorted(KERNELS)
    for k, text in texts.items():
        assert suite.dfg_path(k).read_text() == text, k


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_frozen_mapping_is_legal(config, kernel):
    cfg = suite.load_config(config)
    plain, mesh = PlainDFG.load(suite.dfg_path(kernel)), suite.mesh(cfg)
    m = suite.load_frozen_mapping(config, kernel)
    assert legality.violations(plain, mesh, m["ii"], m["t_abs"], m["placement"]) == []
    assert m["mii"] == legality.min_ii(plain, mesh) <= m["ii"]
    # the port's own validator agrees
    port = suite.port_mapping(suite.port_dfgs(cfg)[kernel], suite.port_cgra(cfg), m["ii"],
                              m["t_abs"], m["placement"])
    assert port.validate(connectivity="strict", registers=False) == []
