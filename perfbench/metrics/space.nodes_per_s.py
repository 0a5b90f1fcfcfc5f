"""space.nodes_per_s (nodes/s): search nodes the space engine visited over
its phase time, over every kernel of the window;
``CompileResult.trace.space_nodes_visited`` over ``phases.space_s``."""


def read(record):
    rows = [r for p in record.get("passes") or [] for r in p["jobs"]]
    nodes = sum(r["space_nodes_visited"] for r in rows)
    space_s = sum(r["space_phase_s"] for r in rows)
    return nodes / space_s if nodes > 0 and space_s > 0 else None
