"""General hygiene rules: no bare ``print`` in library modules, no
mutable default arguments.

The ``no-bare-print`` rule is the framework port of the one-off AST
check that used to live in ``tests/test_obs.py`` — library diagnostics
route through :func:`repro_torch.obs.diag` (swallowed/redirected per sink),
while ``__main__``-guarded CLI modules may print freely.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import Finding, ModuleInfo, Rule, register

_MUTABLE_CALLS = {"list", "dict", "set", "bytearray", "deque",
                  "defaultdict", "OrderedDict", "Counter"}


@register
class NoBarePrint(Rule):
    """Library modules must route diagnostics through ``repro_torch.obs.diag``
    (modules with a module-level ``__main__`` guard are CLIs, exempt)."""

    name = "no-bare-print"
    description = ("no bare print() in library modules — diagnostics go "
                   "through repro_torch.obs.diag; __main__-guarded CLI "
                   "modules are exempt")
    hint = ("route through repro_torch.obs.diag(...) (redirectable, silent "
            "under test) or add a __main__ guard if this is a CLI")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if mod.has_main_guard():
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id == "print":
                yield self.finding(mod, node,
                                   "bare print() in a library module")


@register
class NoMutableDefault(Rule):
    """Mutable default arguments are shared across calls — a classic
    state leak that breaks run-to-run reproducibility."""

    name = "mutable-default-arg"
    description = ("no mutable default arguments (list/dict/set "
                   "literals or constructor calls) — the default is "
                   "created once and shared across every call")
    hint = "default to None and create the container inside the function"

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if self._mutable(d):
                    label = (node.name if not isinstance(node, ast.Lambda)
                             else "<lambda>")
                    yield self.finding(
                        mod, d, f"mutable default argument in {label}()")

    @staticmethod
    def _mutable(node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in _MUTABLE_CALLS)
