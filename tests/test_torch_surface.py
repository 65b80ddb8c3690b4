"""The port's package surface against the reference's: the lazy
top-level names of ``repro_torch`` (``__all__`` and the deprecated
aliases) and the own copies of the cluster layer, the control plane, the
static memory tier and the ``api`` facade, each equal to its reference
module's syntax tree once docstrings are stripped, but for import paths,
the CLI's ``prog=``, the one function left out
(``workspace.xla_scratch_bytes``, which reads an XLA executable) and the
one put in its place (``workspace.scratch_bytes``); and the sharding rule
tables and policies, equal to the reference's."""

import ast
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

import repro
import repro_torch

SRC = Path(__file__).resolve().parents[1] / "src"

#: port module -> reference module, under src/repro_torch and src/repro
COPIES = ["api.py", "cluster/__init__.py", "cluster/tariff.py",
          "cluster/zones.py", "cluster/workload.py", "cluster/policies.py",
          "cluster/orchestrator.py", "control/__init__.py",
          "control/__main__.py", "control/plane.py",
          "core/memory/static_estimator.py", "core/memory/workspace.py"]
#: reference definitions the port leaves out, by module
LEFT_OUT = {"core/memory/workspace.py": {"xla_scratch_bytes"}}
#: port definitions that take their place, by module
ADDED = {"core/memory/workspace.py": {"scratch_bytes"}}


class _Normalize(ast.NodeTransformer):
    """Strip docstrings, and in the reference's tree point imports and the
    CLI's program name at the port."""

    def __init__(self, reference: bool, left_out=frozenset()):
        self.reference = reference
        self.left_out = left_out

    def _strip(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        node.body = [n for n in node.body if not (
            isinstance(n, ast.FunctionDef) and n.name in self.left_out)]
        return self._strip(self.generic_visit(node))

    def visit_FunctionDef(self, node):
        return self._strip(self.generic_visit(node))

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        return self._strip(self.generic_visit(node))

    def visit_ImportFrom(self, node):
        if self.reference and node.module and (
                node.module == "repro" or node.module.startswith("repro.")):
            node.module = "repro_torch" + node.module[len("repro"):]
        return node

    def visit_Constant(self, node):
        if self.reference and node.value == "python -m repro.control":
            node.value = "python -m repro_torch.control"
        return node


def _tree(path: Path, reference: bool, left_out=frozenset()) -> str:
    tree = _Normalize(reference, left_out).visit(ast.parse(path.read_text()))
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_but_for_import_paths(rel):
    left_out = LEFT_OUT.get(rel, frozenset())
    assert _tree(SRC / "repro_torch" / rel, False,
                 ADDED.get(rel, frozenset())) == \
        _tree(SRC / "repro" / rel, True, left_out)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_imports_neither_jax_nor_the_reference(rel):
    for node in ast.walk(ast.parse((SRC / "repro_torch" / rel).read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "repro"), (rel, name)


def test_all_is_the_references_and_resolve_device():
    assert repro_torch.__all__ == sorted([*repro.__all__, "resolve_device"])
    assert repro_torch._DEPRECATED.keys() == repro._DEPRECATED.keys()
    assert set(dir(repro_torch)) >= set(repro_torch.__all__) | set(
        repro_torch._DEPRECATED)


@pytest.mark.parametrize("name", sorted(repro.__all__))
def test_each_name_resolves_to_the_ports_object(name):
    home = repro_torch._EXPORTS[name]
    assert home == "repro_torch" + repro._EXPORTS[name][len("repro"):]
    value = getattr(repro_torch, name)
    if name == "KINDS":
        assert value == repro.KINDS
    else:
        assert value.__module__.startswith("repro_torch."), name
        assert value.__name__ == getattr(repro, name).__name__


@pytest.mark.parametrize("name", sorted(repro._DEPRECATED))
def test_deprecated_alias_warns_once_and_resolves_to_the_port(name,
                                                              monkeypatch):
    monkeypatch.delitem(vars(repro_torch), name, raising=False)
    with pytest.warns(DeprecationWarning, match=f"repro_torch.{name} is "
                      "deprecated"):
        value = getattr(repro_torch, name)
    assert value.__module__ == repro_torch._DEPRECATED[name][0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert getattr(repro_torch, name) is value   # cached: no warning


def test_resolve_device_is_the_device_modules():
    from repro_torch import device
    assert repro_torch.resolve_device is device.resolve_device
    assert str(repro_torch.resolve_device("cpu")) == "cpu"


def test_host_layers_import_no_torch():
    """``import repro_torch`` and the host-only layers (the cluster, the
    control CLI, the fleet and scheduler they drive) load no torch, so
    ``python -m repro_torch.control`` starts as fast as the reference's."""
    code = ("import sys, repro_torch, repro_torch.control.__main__, "
            "repro_torch.cluster, repro_torch.launch.cluster_sim; "
            "print(sorted(m for m in ('torch', 'jax', 'repro') "
            "if m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True).stdout
    assert out.strip() == "[]"


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'teleport'"):
        repro_torch.teleport


@pytest.mark.parametrize("name", ["PARAM_RULES", "ACT_RULES",
                                  "AXIS_PRIORITY", "POLICIES",
                                  "LONG_CONTEXT_OVERRIDES"])
def test_sharding_rule_tables_are_the_references(name):
    from repro.sharding import partitioning as ref
    from repro_torch.sharding import partitioning as port
    assert getattr(port, name) == getattr(ref, name)
    for policy in ref.POLICIES:
        assert port.apply_policy(policy) == ref.apply_policy(policy)
