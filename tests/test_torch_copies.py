"""The port's mapper modules are faithful copies of the JAX package's.

``repro_torch`` keeps its own copy of every framework-free module its path
needs, with imports rewritten and the algorithm untouched, so that
deterministic runs stay bit-identical to the reference (ROADMAP.md). This
test pins that rule at the source: both files are parsed with ``ast``,
docstrings are dropped (comments never reach the tree), and the port's
package name is rewritten to the reference's in import statements and in
string constants (a CLI's ``prog``, a help text naming a module). The two
trees must then be equal, node for node.
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
core/daemon/client.py core/daemon/protocol.py core/daemon/server.py core/dfg.py
core/exact_backends/__init__.py core/exact_backends/certify.py
core/exact_backends/joint.py core/frontend.py core/fuzz.py core/mapper.py
core/mono.py core/placement.py core/schedule.py
core/service/__init__.py core/service/batch.py core/service/cache.py
core/simulate.py core/space_backends/__init__.py core/space_backends/anneal.py
core/space_backends/base.py core/space_backends/exact.py
core/time_backends/__init__.py core/time_backends/base.py
core/time_backends/cp_backend.py core/time_smt.py daemon.py obs/__init__.py
""".split())

#: modules of the reference's layout that the port rewrites, and why
DIFFER = {
    "__init__.py": "the package docstring and version are the port's own; "
                   "the lazy API exports are checked by "
                   "tests/test_torch_api.py",
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


def _tree(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return ast.dump(_Normalise().visit(tree), include_attributes=False)


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_reference(module):
    mine = _tree(os.path.join(_SRC, "repro_torch", module))
    ref = _tree(os.path.join(_SRC, "repro", module))
    assert mine == ref, f"{module} drifted from src/repro/{module}"


@pytest.mark.parametrize("module", sorted(DIFFER))
def test_differing_module_really_differs(module):
    """A module named in ``DIFFER`` that has become a faithful copy again
    belongs in ``COPIES``, where a later drift would show."""
    mine = _tree(os.path.join(_SRC, "repro_torch", module))
    ref = _tree(os.path.join(_SRC, "repro", module))
    assert mine != ref, f"{module} is a copy again: move it to COPIES"
