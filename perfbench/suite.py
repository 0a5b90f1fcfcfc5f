"""The frozen inputs, and the port's objects built from them.

Configurations, cells and frozen DFGs and mappings are files under this
folder, found by name. The port receives them only through its public
constructors: ``DFG.from_json``, ``CGRA`` or an architecture preset, and
``Mapping(dfg, cgra, ii, t_abs, placement)``.
"""

from __future__ import annotations

import json
from pathlib import Path

from .legality import Mesh
from .reference import PlainDFG

HERE = Path(__file__).resolve().parent
DATA = HERE / "data"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    cfg = read_json(HERE / "configs" / f"{name}.json")
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def load_cell(name: str) -> dict:
    return read_json(HERE / "workloads" / f"{name}.json")


def dfg_path(kernel: str) -> Path:
    return DATA / "dfgs" / f"{kernel}.json"


def mapping_path(config: str, kernel: str) -> Path:
    return DATA / "mappings" / config / f"{kernel}.json"


def plain_dfgs(config: dict) -> dict[str, PlainDFG]:
    """The configuration's kernels as the reference reads them, in order."""
    return {k: PlainDFG.load(dfg_path(k)) for k in config["kernels"]}


def mesh(config: dict) -> Mesh:
    fabric = config["fabric"]
    if fabric.get("topology", "mesh") != "mesh":
        raise ValueError("the checker knows the mesh topology only")
    return Mesh(fabric["rows"], fabric["cols"])


# -- the port's side ---------------------------------------------------------

def port_dfgs(config: dict) -> dict:
    from repro_torch.core.dfg import DFG

    return {k: DFG.from_json(dfg_path(k).read_text()) for k in config["kernels"]}


def port_cgra(config: dict):
    """The fabric as the port models it: its preset where the configuration
    names one, else a plain mesh."""
    from repro_torch.core.cgra import CGRA

    fabric = config["fabric"]
    if fabric.get("preset"):
        from repro_torch.core.arch import get_preset

        cgra = get_preset(fabric["preset"]).cgra()
    else:
        cgra = CGRA(fabric["rows"], fabric["cols"], topology=fabric.get("topology", "mesh"))
    if (cgra.rows, cgra.cols) != (fabric["rows"], fabric["cols"]) or cgra.heterogeneous:
        raise ValueError(f"{config['name']}: the fabric is not a homogeneous "
                         f"{fabric['rows']}x{fabric['cols']} mesh")
    return cgra


def compile_options(config: dict):
    """The compiler options the configuration states, as the port resolves
    them."""
    from repro_torch.api import resolve_options

    c = dict(config["compiler"])
    return resolve_options(c.pop("profile"), **c)


def port_mapping(dfg, cgra, ii: int, t_abs, placement):
    from repro_torch.core.mapper import Mapping

    return Mapping(dfg=dfg, cgra=cgra, ii=ii, t_abs=list(t_abs), placement=list(placement))


def load_frozen_mapping(config: str, kernel: str) -> dict:
    m = read_json(mapping_path(config, kernel))
    if m["kernel"] != kernel or m["config"] != config:
        raise ValueError(f"mapping file of {config}/{kernel} names {m['config']}/{m['kernel']}")
    return m
