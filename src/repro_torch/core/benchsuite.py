"""The 17-benchmark DFG suite (MiBench + Rodinia innermost loops, paper §V).

The authors' exact LLVM-extracted DFGs are not published; what Table III fixes
is each benchmark's node count and (via mII = max(ResII, RecII) and the
published per-size mII values) its recurrence-cycle length RecII. We generate
deterministic DFGs that reproduce those statistics exactly:

  * node count       == Table III "DFG Nodes"
  * RecII            == derived from the largest-grid mII (ResII ~ 1 there)
  * structure        == loop-body shaped: live-in loads fan out into a layered
                        binary-op DAG with store sinks and a single recurrence
                        chain closed by a distance-1 loop-carried edge (phi).

Generated graphs are validated (acyclic intra-iteration part, arity bounds,
RecII match) at construction. Real DFGs can be swapped in via DFG.from_json.
"""

from __future__ import annotations

import random
import zlib

from .dfg import DFG, Edge

# name -> (num_nodes, rec_ii) per Table III (RecII derived from large-grid mII)
TABLE3_BENCHMARKS: dict[str, tuple[int, int]] = {
    "aes": (23, 14),
    "backprop": (34, 5),
    "basicmath": (21, 7),
    "bitcount": (7, 3),
    "cfd": (51, 2),
    "crc32": (24, 8),
    "fft": (20, 7),
    "gsm": (24, 4),
    "heartwall": (35, 3),
    "hotspot3D": (57, 2),
    "lud": (26, 3),
    "nw": (33, 2),
    "particlefilter": (38, 9),
    "sha1": (21, 2),
    "sha2": (25, 7),
    "stringsearch": (28, 3),
    "susan": (21, 2),
}

_BINOPS = ["add", "sub", "mul", "xor", "and", "or", "shl", "shr", "min", "max"]
_UNOPS = ["neg", "not", "abs", "mov"]


def make_benchmark_dfg(name: str, num_nodes: int, rec: int, *, seed: int | None = None) -> DFG:
    """Deterministic loop-body-shaped DFG with the requested statistics."""
    if rec < 1 or num_nodes < rec + 2:
        raise ValueError(f"{name}: need at least rec+2={rec + 2} nodes")
    # crc32, NOT hash(): str hashing is salted per process (PYTHONHASHSEED),
    # which silently made "deterministic" DFGs differ between test runs
    rng = random.Random(seed if seed is not None else zlib.crc32(name.encode()))

    ops: list[str] = []
    edges: list[Edge] = []
    n_inputs = max(2, min(num_nodes // 5, num_nodes - rec - 1))
    for _ in range(n_inputs):
        ops.append("input")
    inputs = list(range(n_inputs))

    # Recurrence chain: c0 (phi) -> c1 -> ... -> c_{rec-1} -(carried)-> c0.
    # Chain nodes only take predecessors from {prev chain node} U inputs so the
    # single carried edge closes exactly one simple cycle of length `rec`.
    chain = list(range(n_inputs, n_inputs + rec))
    ops.append("phi")
    edges.append(Edge(rng.choice(inputs), chain[0]))
    for i, v in enumerate(chain[1:], start=1):
        ops.append(rng.choice(_BINOPS))
        edges.append(Edge(chain[i - 1], v))
        if rng.random() < 0.6:
            edges.append(Edge(rng.choice(inputs), v))
    edges.append(Edge(chain[-1], chain[0], 1))  # loop-carried back-edge

    # Remaining nodes: layered DAG reading from anything created earlier,
    # with a locality bias so the graph looks like real straight-line code.
    first_free = n_inputs + rec
    for v in range(first_free, num_nodes):
        pool = list(range(v))
        # bias towards recent producers
        weights = [1.0 + 3.0 * (p / max(1, v - 1)) for p in pool]
        k = 2 if rng.random() < 0.7 else 1
        preds = _weighted_sample(rng, pool, weights, k)
        if v == num_nodes - 1 or (num_nodes - v <= 2 and rng.random() < 0.7):
            ops.append("store")
            preds = preds[:1]
        else:
            ops.append(rng.choice(_BINOPS) if len(preds) == 2 else rng.choice(_UNOPS))
        for p in preds:
            edges.append(Edge(p, v))

    dfg = DFG(num_nodes=num_nodes, edges=edges, ops=ops, name=name)
    dfg.validate()
    got = dfg.rec_ii()
    if got != rec:
        raise AssertionError(f"{name}: generated RecII {got} != target {rec}")
    return dfg


def _weighted_sample(rng: random.Random, pool: list[int], weights: list[float], k: int) -> list[int]:
    chosen: list[int] = []
    pool = list(pool)
    weights = list(weights)
    for _ in range(min(k, len(pool))):
        total = sum(weights)
        r = rng.random() * total
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if r <= acc:
                chosen.append(pool.pop(i))
                weights.pop(i)
                break
    return chosen


def route_stress_dfg() -> DFG:
    """The route-through demo kernel: load → mul → store with an address chain.

    On bank-split machines (``onehop_split_4x4``: memory ops pinned to column
    0, multiplies to column 3) both the ``load→mul`` and ``mul→store`` edges
    connect PEs that are never adjacent, so the kernel is unmappable under
    direct adjacency at every II — and maps with one route-through mov per
    bank crossing (``max_route_hops >= 1``). Used by the route-through tests,
    the hetero benchmark's route row, and the CI escalation smoke.
    """
    from .dfg import Edge

    return DFG(
        num_nodes=5,
        ops=["input", "load", "const", "mul", "store"],
        edges=[Edge(0, 1), Edge(1, 3), Edge(2, 3), Edge(3, 4)],
        imms=[0.0, 0.0, 3.0, 0.0, 0.0],
        name="route_stress",
    )


def load_suite(names: list[str] | None = None) -> dict[str, DFG]:
    """Table III benchmarks, deterministically generated.

    ``names`` selects a subset (order-preserving, unknown names rejected);
    the default is all 17. The generator is seeded from the crc32 of the
    name, so every process builds bit-identical graphs.

    Example::

        from repro_torch.core.benchsuite import load_suite

        suite = load_suite(["bitcount", "fft"])
        assert [d.num_nodes for d in suite.values()] == [7, 20]
    """
    if names is not None:
        unknown = [n for n in names if n not in TABLE3_BENCHMARKS]
        if unknown:
            raise ValueError(
                f"unknown benchmark(s) {unknown}; "
                f"choose from {sorted(TABLE3_BENCHMARKS)}"
            )
        return {n: make_benchmark_dfg(n, *TABLE3_BENCHMARKS[n]) for n in names}
    return {
        name: make_benchmark_dfg(name, n, rec)
        for name, (n, rec) in TABLE3_BENCHMARKS.items()
    }
