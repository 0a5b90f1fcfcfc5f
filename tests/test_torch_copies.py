"""The port's mapper modules are faithful copies of the JAX package's.

``repro_torch`` keeps its own copy of every framework-free module its path
needs, with imports rewritten and the algorithm untouched, so that
deterministic runs stay bit-identical to the reference (ROADMAP.md). This
test pins that rule at the source: both files are parsed with ``ast``,
docstrings are dropped (comments never reach the tree), and the port's
package name is rewritten to the reference's in import statements and in
string constants (a CLI's ``prog``, a help text naming a module). The two
trees must then be equal, node for node. The mapper's search modules in
``PROBE_OUTCOMES`` add only how a probe ended: their trees are compared with
those statements and ``outcome=`` arguments taken out of both.
"""

import ast
import os

import pytest

_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

#: every module the port carries as a copy of the reference
COPIES = sorted("""
api/__init__.py api/compiler.py api/options.py api/result.py compile.py
core/__init__.py core/arch/__init__.py core/arch/presets.py core/arch/spec.py
core/baseline.py core/benchsuite.py core/cgra.py core/daemon/__init__.py
core/daemon/client.py core/daemon/protocol.py core/dfg.py
core/exact_backends/__init__.py core/exact_backends/certify.py
core/exact_backends/joint.py core/frontend.py core/fuzz.py core/mapper.py
core/mono.py core/placement.py core/schedule.py
core/service/__init__.py core/service/batch.py core/service/cache.py
core/simulate.py core/space_backends/__init__.py core/space_backends/anneal.py
core/space_backends/base.py core/space_backends/exact.py
core/time_backends/__init__.py core/time_backends/base.py
core/time_backends/cp_backend.py core/time_smt.py daemon.py
roofline/report.py
""".split())

#: copies that also record how each space and time probe ended (found,
#: cancelled, timeout, node_budget, exhausted): SpaceStats' counts of dives
#: stopped by their deadline or their budget, taken where a dive already
#: stops, ``SpaceStats.outcome`` and the probe spans' ``outcome``
#: (tests/test_torch_obs.py). Every statement that names one of these, and
#: every ``outcome=`` argument, is taken out of both trees before comparing.
PROBE_OUTCOMES = {
    "modules": {"core/mapper.py", "core/space_backends/anneal.py",
                "core/space_backends/base.py", "core/space_backends/exact.py",
                "core/time_smt.py"},
    "names": {"deadline_stops", "budget_stops", "outcome", "probe_outcome"},
}

#: modules of the reference's layout that the port rewrites, and why
DIFFER = {
    "__init__.py": "the package docstring and version are the port's own; "
                   "the lazy API exports are checked by "
                   "tests/test_torch_api.py",
    "core/daemon/server.py":
        "a cold solve on the z3 time backend runs in a spawned process pool, "
        "not in the worker thread: z3 gives up the interpreter lock around "
        "every term it builds, and taking it back beside the other threads' "
        "pure-Python search stretches a solve many times over "
        "(tools/daemon_z3_probe.py); tests/test_torch_daemon.py checks that "
        "rows from the pool equal the reference's",
    "obs/__init__.py":
        "spans also open torch.profiler annotations while the profiler "
        "records, through a hook the torch layer installs and every forked "
        "child drops, and keep no per-thread stack of open names "
        "(tests/test_torch_obs.py)",
    "core/time_backends/z3_backend.py":
        "each backend builds its terms in a z3 context of its own, not z3's "
        "global one, so that the compile daemon's worker threads can solve "
        "at once; tests/test_torch_core.py checks the wiring",
}


class _Normalise(ast.NodeTransformer):
    @staticmethod
    def _name(name):
        if name == "repro_torch" or name.startswith("repro_torch."):
            return "repro" + name[len("repro_torch"):]
        return name

    def _strip_docstring(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        self.generic_visit(node)
        return self._strip_docstring(node)

    visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = visit_Module

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = self._name(alias.name)
        return node

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = self._name(node.module)
        return node

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = node.value.replace("repro_torch", "repro")
        return node


class _StripOutcomes(ast.NodeTransformer):
    """Takes out every statement that names one of ``names`` (as a variable,
    attribute, function or field) once its own inner such statements are
    gone, every ``outcome=`` argument, and every ``if`` left with no body."""

    def __init__(self, names):
        self.names = names

    def _names_one(self, node):
        for sub in ast.walk(node):
            name = (getattr(sub, "id", None) or getattr(sub, "attr", None)
                    or (sub.name if isinstance(sub, ast.FunctionDef) else None))
            if name in self.names:
                return True
        return False

    def visit_Call(self, node):
        self.generic_visit(node)
        node.keywords = [k for k in node.keywords if k.arg != "outcome"]
        return node

    def generic_visit(self, node):
        super().generic_visit(node)
        if isinstance(node, ast.stmt):
            if isinstance(node, ast.If) and not node.body:
                return None
            if self._names_one(node):
                return None
        return node


def _tree(path, strip=None):
    with open(path) as f:
        tree = ast.parse(f.read())
    if strip is not None:
        tree = _StripOutcomes(strip).visit(tree)
    return ast.dump(_Normalise().visit(tree), include_attributes=False)


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_reference(module):
    strip = (PROBE_OUTCOMES["names"] if module in PROBE_OUTCOMES["modules"]
             else None)
    mine = _tree(os.path.join(_SRC, "repro_torch", module), strip)
    ref = _tree(os.path.join(_SRC, "repro", module), strip)
    assert mine == ref, f"{module} drifted from src/repro/{module}"


@pytest.mark.parametrize("module", sorted(DIFFER))
def test_differing_module_really_differs(module):
    """A module named in ``DIFFER`` that has become a faithful copy again
    belongs in ``COPIES``, where a later drift would show."""
    mine = _tree(os.path.join(_SRC, "repro_torch", module))
    ref = _tree(os.path.join(_SRC, "repro", module))
    assert mine != ref, f"{module} is a copy again: move it to COPIES"


def test_report_renders_as_the_reference():
    """One set of dry-run result rows (both packages write the same keys)
    renders to the same tables and summary through either package."""
    from repro.roofline import report as ref
    from repro_torch.roofline import report as mine

    def row(arch, shape, mesh, t, bottleneck, mfu, ok=True):
        return {"arch": arch, "shape": shape, "mesh": mesh, "ok": ok,
                "t_compute": t[0], "t_memory": t[1], "t_collective": t[2],
                "bottleneck": bottleneck, "useful_flops_ratio": 0.61,
                "mfu_upper_bound": mfu, "arg_bytes_per_dev": 3 * 2**30,
                "temp_bytes_per_dev": 2**29,
                "collectives": {"all-reduce": 2**31, "all-gather": 5 * 2**28}}

    rows = [row("qwen3-0.6b", "train_4k", "16x16", (0.25, 1.03, 0.34), "memory", 0.0123),
            row("qwen3-0.6b", "decode_32k", "2x16x16", (7e-6, 3.4e-3, 1.2e-2), "collective",
                0.0004),
            row("deepseek-v3-671b", "train_4k", "2x16x16", (2.5, 0.5, 1e-4), "compute", 0.31),
            {"arch": "hymba-1.5b", "shape": "long_500k", "mesh": "16x16", "ok": False}]
    for mesh in ("16x16", "2x16x16"):
        assert mine.roofline_table(rows, mesh) == ref.roofline_table(rows, mesh)
        assert mine.collective_detail(rows, mesh) == ref.collective_detail(rows, mesh)
    assert mine.summary(rows) == ref.summary(rows)

