"""Carry a mapping or a model's parameters made elsewhere into this package.

A mapping of the JAX package (or one read from a file) exposes everything
this package needs as JSON-able values: the DFG as ``dfg.to_json()``, the
grid's fields, ``ii``, ``t_abs``, ``placement`` and ``routes_spec()``.
:func:`mapping_from_plain` rebuilds this package's :class:`Mapping` from
them, and :func:`plain_mapping` takes the same data from any object with
those attributes — without importing that object's package.

:func:`lm_params_from_numpy` turns an LM parameter tree of numpy arrays (the
JAX package's, converted leaf by leaf) into this package's parameters, and
:func:`lm_params_to_numpy` turns this package's parameters (or gradients, or
optimizer moments: any tree of that layout) back into the JAX package's
stacked layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.cgra import CGRA
from .core.dfg import DFG, Route
from .core.mapper import Mapping

#: The ``CGRA`` fields carried across.
CGRA_FIELDS = ("rows", "cols", "topology", "registers_per_pe", "pe_classes",
               "mem_ports", "registers_by_class")


def plain_mapping(mapping) -> dict:
    """The plain data of ``mapping``: JSON-able values only."""
    cgra = mapping.cgra
    return {
        "dfg": mapping.dfg.to_json(),
        "cgra": {f: getattr(cgra, f) for f in CGRA_FIELDS},
        "ii": int(mapping.ii),
        "t_abs": [int(t) for t in mapping.t_abs],
        "placement": [int(p) for p in mapping.placement],
        "routes": [tuple(int(x) for x in r) for r in mapping.routes_spec()],
    }


def cgra_from_plain(fields: dict) -> CGRA:
    """A CGRA from its fields; JSON lists become the tuples CGRA hashes
    (it normalises ``registers_by_class`` itself)."""
    kw = dict(fields)
    if kw.get("pe_classes") is not None:
        kw["pe_classes"] = tuple(tuple(c) for c in kw["pe_classes"])
    return CGRA(**kw)


def mapping_from_plain(plain: dict) -> Mapping:
    """This package's Mapping for :func:`plain_mapping`'s data.

    ``plain["dfg"]`` is the mapped (possibly route-rewritten) DFG; its
    route-through movs were appended from the original node count in
    ``routes`` order, so the route records are rebuilt from the specs.
    The result is validated and raises ``ValueError`` if it does not hold.
    """
    dfg = DFG.from_json(plain["dfg"])
    specs = [tuple(s) for s in plain["routes"]]
    next_id = dfg.num_nodes - sum(n for *_, n in specs)
    routes = []
    for src, dst, distance, n_movs in specs:
        routes.append(Route(src=src, dst=dst, distance=distance,
                            movs=tuple(range(next_id, next_id + n_movs))))
        next_id += n_movs
    mapping = Mapping(
        dfg=dfg, cgra=cgra_from_plain(plain["cgra"]), ii=plain["ii"],
        t_abs=list(plain["t_abs"]), placement=list(plain["placement"]),
        routes=routes,
    )
    errs = mapping.validate(registers=False)
    if errs:
        raise ValueError(f"carried mapping is invalid: {errs}")
    return mapping


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bf16 (numpy's
    ``ml_dtypes`` extension type) goes through a ``uint16`` view."""
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(tree: dict, device="cuda") -> dict:
    """This package's LM parameters from a tree of numpy arrays.

    ``tree`` has the JAX package's keys, with each layer stack's leaves
    stacked on a leading ``[L, ...]`` axis; each stack becomes a list of L
    per-layer dicts, as this package's ``models.build`` keeps them. A list
    (the SSM and hybrid families' ``"layers"``, one dict per layer) is
    carried element by element. Dtypes are kept.
    """
    def convert(node, layer=None):
        if isinstance(node, dict):
            return {k: convert(v, layer) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, layer) for v in node]
        return _tensor(node if layer is None else node[layer], device)

    out = {}
    for key, node in tree.items():
        if key.endswith("_stack"):
            num_layers = len(_first_leaf(node))
            out[key] = [convert(node, i) for i in range(num_layers)]
        else:
            out[key] = convert(node)
    return out


def lm_params_to_numpy(tree: dict) -> dict:
    """The inverse layout of :func:`lm_params_from_numpy`: each ``*_stack``
    list of L per-layer dicts becomes one dict whose leaves are stacked on a
    leading ``[L, ...]`` axis, as the JAX package keeps them; any other
    list stays a list, element by element; every tensor becomes a numpy
    array on the host. numpy has no bfloat16, so bf16 leaves come back as
    float32 (exactly: every bf16 value is an f32)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([layer[k] for layer in layers]) for k in first}
        return np.stack([host(t) for t in layers])

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return host(node)

    return {key: stack(node) if key.endswith("_stack") else convert(node)
            for key, node in tree.items()}


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node
