"""Zero-overhead-when-off: every obs hook on an engine hot path must be
guarded by an ``is None`` / truthiness check on its receiver.

``docs/observability.md`` promises that with observability off the
engine runs the *identical* instruction stream — recorder objects are
``None`` and every emit/sample/profile call sits behind a lexical
guard.  An unconditional ``self.trace.emit(...)`` would crash obs-off
runs; an unconditional ``recorder()`` call would tax the hot loop.
This rule re-checks the promise on every commit.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional, Set

from repro_torch.analysis.core import Finding, ModuleInfo, Rule, register

#: hot-path modules under the contract (rel to the scan root)
OBS_GUARD_SCOPE: Set[str] = {"sim/engine.py", "sim/cluster.py"}

#: a call receiver is an obs hook when its final attribute (or its bare
#: name) is one of these — self.trace.emit, observer.metrics.series,
#: prof.add, core.profiler.tic, ...
_OBS_RECEIVERS = {"trace", "metrics", "profiler", "prof", "recorder"}


def _receiver_name(call: ast.Call) -> Optional[str]:
    """Source text of the obs receiver, or None if not an obs call."""
    if not isinstance(call.func, ast.Attribute):
        return None
    recv = call.func.value
    if isinstance(recv, ast.Name) and recv.id in _OBS_RECEIVERS:
        return recv.id
    if isinstance(recv, ast.Attribute) and recv.attr in _OBS_RECEIVERS:
        try:
            return ast.unparse(recv)
        except Exception:           # pragma: no cover - unparse is total
            return None
    return None


def _test_guards(test: ast.AST, recv: str, want_not_none: bool) -> bool:
    """Does ``test`` establish that ``recv`` is (not) None / truthy?

    ``want_not_none=True`` checks the positive branch (If body),
    ``False`` the negative one (If orelse).
    """
    src = _safe_unparse(test)
    if isinstance(test, ast.BoolOp):
        if isinstance(test.op, ast.And) and want_not_none:
            return any(_test_guards(v, recv, True) for v in test.values)
        if isinstance(test.op, ast.Or) and not want_not_none:
            return any(_test_guards(v, recv, False) for v in test.values)
        return False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _test_guards(test.operand, recv, not want_not_none)
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None \
            and _safe_unparse(test.left) == recv:
        if want_not_none:
            return isinstance(test.ops[0], ast.IsNot)
        return isinstance(test.ops[0], ast.Is)
    # plain truthiness: `if self.trace:` guards the positive branch
    return want_not_none and src == recv


def _safe_unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:               # pragma: no cover - unparse is total
        return ""


def _in_branch(parent: ast.If, node: ast.AST, mod: ModuleInfo) -> bool:
    """True if ``node`` sits in ``parent.body`` (vs ``orelse``)."""
    chain = [node] + list(mod.ancestors(node))
    for stmt in parent.body:
        if stmt in chain:
            return True
    return False


@register
class ObsGuard(Rule):
    """Obs hooks on engine/cluster hot paths must be ``None``-guarded."""

    name = "obs-guard"
    description = ("zero-overhead-when-off: trace/metrics/profiler "
                   "calls in sim/engine.py + sim/cluster.py must sit "
                   "inside an `if <recv> is not None` guard")
    hint = ("wrap the call: `if <receiver> is not None: <receiver>...`"
            " — obs-off runs carry None recorders and must not pay "
            "(or crash on) the hook")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if not mod.in_scope(self.name, OBS_GUARD_SCOPE):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            recv = _receiver_name(node)
            if recv is None:
                continue
            if not self._guarded(mod, node, recv):
                yield self.finding(
                    mod, node,
                    f"unguarded obs hook {_safe_unparse(node.func)}() — "
                    f"no enclosing `{recv} is not None` check")

    def _guarded(self, mod: ModuleInfo, node: ast.Call, recv: str) -> bool:
        prev = node
        for anc in mod.ancestors(node):
            if isinstance(anc, ast.If):
                in_body = _in_branch(anc, node, mod)
                if _test_guards(anc.test, recv, want_not_none=in_body):
                    return True
            elif isinstance(anc, ast.IfExp):
                if prev is anc.body and _test_guards(anc.test, recv, True):
                    return True
                if prev is anc.orelse and _test_guards(anc.test, recv,
                                                       False):
                    return True
            elif isinstance(anc, ast.BoolOp) and isinstance(anc.op,
                                                            ast.And):
                # `recv is not None and recv.emit(...)` short-circuits
                idx = anc.values.index(prev) if prev in anc.values else -1
                if idx > 0 and any(_test_guards(v, recv, True)
                                   for v in anc.values[:idx]):
                    return True
            elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                break               # guards don't cross function scope
            prev = anc
        return False
