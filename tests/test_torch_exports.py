"""Every public name of a reference package is present in the port's
counterpart, unless it waits for a later ROADMAP entry (``WAITING``).

A public name of a module is one in its ``__all__`` where it has one;
otherwise a name the module defines itself at its top level (a def, a
class, an assignment) and, in a package's ``__init__``, a name it
re-exports from its own submodules (a relative import). Names a module
imports from elsewhere (``jax``, ``jnp``, ``Tuple``, ``Mesh``) do not
count. A package's submodules count too, found on disk, so the result does
not depend on what other tests imported first. The port's side is looked
up as an attribute, or for a submodule name as a module on its path.
"""

import ast
import importlib
import importlib.util
import pathlib

import pytest

PACKAGES = ["core", "train", "optim", "models.embedding", "serve", "dist", "data",
            "configs", "launch", "dist.sharding", "configs._families", "models.layers",
            "models.transformer", "models.dlrm", "models.xdeepfm", "models.mind",
            "models.bert4rec", "models.dimenet"]

# reference names the port has not ported yet: {package: {name: ROADMAP entry}}
WAITING = {}


def _defined(path: pathlib.Path, package: bool) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and node.level and package:
            names |= {a.asname or a.name for a in node.names}
    return names


def public_names(modname: str) -> set:
    spec = importlib.util.find_spec(modname)
    mod = importlib.import_module(modname)
    package = spec.submodule_search_locations is not None
    if hasattr(mod, "__all__"):
        names = set(mod.__all__)
    elif spec.origin and spec.origin.endswith(".py"):
        names = _defined(pathlib.Path(spec.origin), package)
    else:
        names = set()  # a namespace package: its submodules alone
    for loc in (spec.submodule_search_locations or ()):
        for p in pathlib.Path(loc).iterdir():
            if p.suffix == ".py" and p.stem != "__init__":
                names.add(p.stem)
            elif p.is_dir() and (p / "__init__.py").exists():
                names.add(p.name)
    return {n for n in names if not n.startswith("_")}


def _in_port(port, package: str, name: str) -> bool:
    if hasattr(port, name):
        return True
    return (hasattr(port, "__path__")
            and importlib.util.find_spec(f"repro_torch.{package}.{name}") is not None)


@pytest.mark.parametrize("package", PACKAGES)
def test_port_exports_what_the_reference_exports(package):
    want = public_names(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    waiting = WAITING.get(package, {})
    assert set(waiting) <= want, f"WAITING names the reference lacks: {set(waiting) - want}"
    missing = sorted(n for n in want - set(waiting) if not _in_port(port, package, n))
    assert not missing, f"repro_torch.{package} lacks {missing}"
    ported = sorted(n for n in waiting if _in_port(port, package, n))
    assert not ported, f"repro_torch.{package} has {ported}: take them off WAITING"
    assert all(e in ("A6.3", "A6.4", "A6.5") for e in waiting.values())
