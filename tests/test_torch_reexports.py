"""Every package of the port re-exports what the JAX package's counterpart
does: the reference's ``__all__`` (or, where it has none, the public names
its ``__init__`` binds) is a subset of the port's, and each shared name
comes from the corresponding module (``d3d_tpu.models.pointpillars``'s
``make_train_step`` from ``d3d_tpu_torch.models.pointpillars``, not from
SECOND's). Names that only the port exports (the flax bridges,
``as_tensor``, the kernel entry points) are allowed."""

import ast
import importlib
import inspect
import pkgutil
import tomllib
import types
from pathlib import Path

import pytest

import _limits  # noqa: F401  (one torch thread a process)

import d3d_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _packages():
    return ["d3d_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(d3d_tpu_torch.__path__,
                                              "d3d_tpu_torch.") if m.ispkg)


def _reference_names(ref):
    """The reference's ``__all__``, else the public names its
    ``__init__`` binds at the top level (imports and definitions)."""
    if hasattr(ref, "__all__"):
        return list(ref.__all__)
    tree = ast.parse(Path(inspect.getfile(ref)).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")
            and getattr(ref, n, None) is not None
            and (not isinstance(getattr(ref, n), types.ModuleType)
                 or getattr(ref, n).__name__.startswith("d3d_tpu."))]


def _source(obj):
    if isinstance(obj, types.ModuleType):
        return obj.__name__
    return getattr(obj, "__module__", None)


def test_every_reference_package_has_a_port():
    ref = importlib.import_module("d3d_tpu")
    ref_pkgs = ["d3d_tpu"] + sorted(
        m.name for m in pkgutil.walk_packages(ref.__path__, "d3d_tpu.")
        if m.ispkg)
    assert sorted("d3d_tpu_torch" + p[len("d3d_tpu"):]
                  for p in ref_pkgs) == _packages()


@pytest.mark.parametrize("name", _packages())
def test_reexports_match_the_reference(name):
    port = importlib.import_module(name)
    ref = importlib.import_module("d3d_tpu" + name[len("d3d_tpu_torch"):])
    names = _reference_names(ref)
    port_names = getattr(port, "__all__", None)
    if hasattr(ref, "__all__"):
        assert port_names is not None, f"{name} has no __all__"
        missing = sorted(set(names) - set(port_names))
        assert not missing, f"{name} lacks {missing}"
    for n in names:
        assert hasattr(port, n), f"{name}.{n} missing"
        want = _source(getattr(ref, n))
        if want is None or not want.startswith("d3d_tpu"):
            continue
        assert _source(getattr(port, n)) == \
            "d3d_tpu_torch" + want[len("d3d_tpu"):], f"{name}.{n}"


def test_every_console_script_has_a_port():
    """Each ``d3d_tpu_*`` console script of ``pyproject.toml`` has a
    ``d3d_tpu_torch_*`` counterpart calling the function of the same name
    in the port's counterpart module, and that function exists."""
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    ref = {k: v for k, v in scripts.items()
           if not k.startswith("d3d_tpu_torch_")}
    assert len(ref) == 4
    for name, target in ref.items():
        port = scripts.get("d3d_tpu_torch_" + name[len("d3d_tpu_"):])
        assert port is not None, f"{name} has no port"
        module, func = target.split(":")
        assert port == f"d3d_tpu_torch{module[len('d3d_tpu'):]}:{func}"
        assert callable(getattr(importlib.import_module(
            port.split(":")[0]), func))
