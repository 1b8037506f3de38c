"""The port's verbatim copies of framework-neutral reference modules stay
the reference's: both files parsed with ``ast``, docstrings and any import
line that names a package (``repro``, ``repro_torch``, ``jax``) dropped,
the rest equal node for node. A port-side edit that drifts from its
reference fails here, before a differential test of the manager happens to
reach it. No copy differs from its reference on purpose today.
"""

import ast
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
COPIES = [f"core/{m}.py" for m in (
    "packing", "pipeline", "storage", "integrity", "bitwidth", "range_reader",
    "reader_protocol", "incremental", "coordinator", "metrics")] + [
    "data/synthetic.py", "data/reader.py"]
PACKAGE_NAMES = ("repro", "repro_torch", "jax", "jaxlib")


def _names_a_package(node) -> bool:
    if isinstance(node, ast.Import):
        return any(a.name.split(".")[0] in PACKAGE_NAMES for a in node.names)
    if isinstance(node, ast.ImportFrom):
        return not node.level and (node.module or "").split(".")[0] in PACKAGE_NAMES
    return False


class _Strip(ast.NodeTransformer):
    def _body(self, body):
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:] or [ast.Pass()]
        return [n for n in body if not _names_a_package(n)]

    def generic_visit(self, node):
        node = super().generic_visit(node)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            node.body = self._body(node.body)
        return node


def _code(path: pathlib.Path) -> str:
    return ast.dump(_Strip().visit(ast.parse(path.read_text())))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_reference(rel):
    ref, port = SRC / "repro" / rel, SRC / "repro_torch" / rel
    assert _code(port) == _code(ref), f"src/repro_torch/{rel} drifted from src/repro/{rel}"


def test_strip_sees_a_drift():
    a = '"""doc"""\nimport jax\ndef f(x):\n    """doc"""\n    return x + 1\n'
    b = 'from repro_torch.core import y\ndef f(x):\n    return x + 1\n'
    c = 'def f(x):\n    return x + 2\n'
    dump = lambda s: ast.dump(_Strip().visit(ast.parse(s)))
    assert dump(a) == dump(b) != dump(c)
