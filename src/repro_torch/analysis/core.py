"""The invariant-linter core: one AST walk per module, every rule on it.

The port's correctness story rests on a handful of *conventions* — seeded
RNG everywhere, obs hooks guarded so tracing is zero-overhead when off,
`identity_hash` covering every result-affecting spec field — that the
runtime equivalence suites only catch probabilistically when broken.
This package turns those conventions into machine-checked invariants:

* a :class:`Rule` registry (``@register``-decorated singletons; adding a
  rule is ~30 lines in :mod:`repro_torch.analysis.rules`),
* a shared parse — each module under the scan root is read and
  ``ast.parse``'d exactly once into a :class:`ModuleInfo`, and every
  selected rule walks that one tree,
* structured :class:`Finding`\\ s (rule, file:line, message, fix hint),
* per-line suppression comments with an audit trail::

      do_risky_thing()   # repro: allow(wall-clock): report metadata only

  ``# repro: allow`` (no rule list) suppresses every rule on that line;
  a suppression on a comment-only line applies to the next code line.
  ``# repro: allow-file(<rule>): reason`` anywhere in a module
  suppresses the rule for the whole file (for modules that are exempt
  *by design*, e.g. deliberately-f32 TPU kernels), and
  ``# repro: scope(<rule>)`` opts a module *into* a rule that normally
  only runs on specific files (used by the test fixtures).

Run it as ``python -m repro_torch.analysis`` (see
:mod:`repro_torch.analysis.cli`) or from the test suite (one zero-findings
sweep per rule).  The pragma syntax is the reference linter's byte for
byte, so either linter reads the other's pragmas alike.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "ModuleInfo", "Rule", "register", "rules",
           "rule_names", "get_rule", "load_module", "iter_modules",
           "analyze", "default_root", "AnalysisError"]

#: suppression / scope pragmas — ``# repro: allow(rule-a, rule-b): why``
_PRAGMA_RE = re.compile(
    r"#\s*repro:\s*(allow-file|allow|scope)\s*(?:\(([^)]*)\))?")

#: sentinel rule-name meaning "every rule" (bare ``# repro: allow``)
ALL_RULES = "*"


class AnalysisError(ValueError):
    """Bad analyzer invocation (unknown rule name, unreadable path)."""


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line, with a fix hint."""
    rule: str
    path: str          # module path relative to the scan root (posix)
    line: int
    message: str
    hint: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint}

    @classmethod
    def from_dict(cls, d: Dict) -> "Finding":
        return cls(rule=d["rule"], path=d["path"], line=int(d["line"]),
                   message=d["message"], hint=d.get("hint", ""))

    def format(self, root: Optional[str] = None) -> str:
        prefix = f"{root}/" if root else ""
        out = f"{prefix}{self.path}:{self.line}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class ModuleInfo:
    """One parsed module: source, shared AST, pragmas, parent links."""

    def __init__(self, path: pathlib.Path, rel: str, source: str):
        self.path = path
        self.rel = rel                       # posix, relative to scan root
        self.source = source
        self.tree: ast.Module = ast.parse(source, filename=str(path))
        self.lines = source.splitlines()
        # line -> suppressed rule names (ALL_RULES suppresses everything)
        self.suppressions: Dict[int, Set[str]] = {}
        self.file_suppressions: Set[str] = set()
        self.forced_scopes: Set[str] = set()
        self._scan_pragmas()
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    # ---------------------------------------------------------------- #
    # pragmas
    # ---------------------------------------------------------------- #
    def _scan_pragmas(self) -> None:
        pending: Set[str] = set()            # from comment-only lines
        for lineno, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            code = text.split("#", 1)[0].strip()
            if m is None:
                if code and pending:         # code line after standalone
                    self.suppressions.setdefault(lineno, set()) \
                        .update(pending)
                    pending = set()
                continue
            kind, arg = m.group(1), m.group(2)
            names = ({n.strip() for n in arg.split(",") if n.strip()}
                     if arg else {ALL_RULES})
            if kind == "allow-file":
                self.file_suppressions |= names
            elif kind == "scope":
                self.forced_scopes |= names
            elif code:                       # trailing comment on code
                self.suppressions.setdefault(lineno, set()).update(names)
            else:                            # comment-only line: applies
                pending |= names             # to the next code line
        # (a trailing pending set at EOF suppresses nothing — fine)

    def suppressed(self, rule: str, line: int) -> bool:
        if self.file_suppressions & {rule, ALL_RULES}:
            return True
        at = self.suppressions.get(line, ())
        return rule in at or ALL_RULES in at

    def in_scope(self, rule_name: str, scope: Set[str]) -> bool:
        """Scoped rules run on ``scope`` rel-paths or opted-in modules."""
        return self.rel in scope or rule_name in self.forced_scopes

    # ---------------------------------------------------------------- #
    # shared AST helpers
    # ---------------------------------------------------------------- #
    def parents(self) -> Dict[ast.AST, ast.AST]:
        """Child → parent map over the shared tree (built once)."""
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        parents = self.parents()
        while node in parents:
            node = parents[node]
            yield node

    def has_main_guard(self) -> bool:
        for node in self.tree.body:
            if isinstance(node, ast.If) \
                    and isinstance(node.test, ast.Compare) \
                    and isinstance(node.test.left, ast.Name) \
                    and node.test.left.id == "__name__":
                return True
        return False


class Rule:
    """One invariant.  Subclass, set ``name``/``description``/``hint``,
    implement :meth:`check`, and decorate with :func:`register`."""

    name: str = ""
    description: str = ""
    hint: str = ""

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, mod: ModuleInfo, node_or_line, message: str,
                hint: Optional[str] = None) -> Finding:
        line = (node_or_line if isinstance(node_or_line, int)
                else node_or_line.lineno)
        return Finding(rule=self.name, path=mod.rel, line=line,
                       message=message,
                       hint=self.hint if hint is None else hint)


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and register a :class:`Rule`."""
    inst = cls()
    if not inst.name:
        raise AnalysisError(f"rule class {cls.__name__} has no name")
    if inst.name in _REGISTRY:
        raise AnalysisError(f"duplicate rule name {inst.name!r}")
    _REGISTRY[inst.name] = inst
    return cls


def _ensure_rules_loaded() -> None:
    # note: must be the submodule import form — ``from repro_torch.analysis
    # import rules`` would resolve to THIS function re-exported by the
    # package __init__, not the subpackage
    import repro_torch.analysis.rules  # noqa: F401  (registration side effect)


def rules() -> Dict[str, Rule]:
    _ensure_rules_loaded()
    return dict(_REGISTRY)


def rule_names() -> List[str]:
    return sorted(rules())


def get_rule(name: str) -> Rule:
    try:
        return rules()[name]
    except KeyError:
        raise AnalysisError(f"unknown rule {name!r}; "
                            f"known: {rule_names()}") from None


# -------------------------------------------------------------------- #
# scanning
# -------------------------------------------------------------------- #
def default_root() -> pathlib.Path:
    """The ``repro_torch`` package source tree (the default scan root).

    ``repro_torch`` has an ``__init__.py`` (importing it imports nothing
    else), so the root is its ``__file__``'s folder.
    """
    import repro_torch
    return pathlib.Path(repro_torch.__file__).parent.resolve()


def load_module(path: pathlib.Path,
                root: Optional[pathlib.Path] = None) -> ModuleInfo:
    path = pathlib.Path(path)
    try:
        rel = path.relative_to(root).as_posix() if root else path.name
    except ValueError:
        rel = path.name
    return ModuleInfo(path, rel, path.read_text())


def iter_modules(root: Optional[pathlib.Path] = None,
                 paths: Optional[Sequence[pathlib.Path]] = None
                 ) -> List[ModuleInfo]:
    """Parse every ``*.py`` under ``root`` (or the explicit ``paths``)
    exactly once; the returned modules are shared by all rules."""
    root = pathlib.Path(root) if root is not None else default_root()
    if paths is None:
        if not root.is_dir():
            raise AnalysisError(f"scan root {root} is not a directory")
        paths = sorted(root.rglob("*.py"))
    return [load_module(pathlib.Path(p), root) for p in paths]


def analyze(root: Optional[pathlib.Path] = None,
            rule_filter: Optional[Sequence[str]] = None,
            paths: Optional[Sequence[pathlib.Path]] = None,
            ) -> Tuple[List[Finding], int]:
    """Run the selected rules over the tree; returns
    ``(post-suppression findings, n files scanned)``."""
    selected = ([get_rule(n) for n in rule_filter]
                if rule_filter is not None
                else [rules()[n] for n in rule_names()])
    modules = iter_modules(root, paths)
    findings: List[Finding] = []
    for mod in modules:
        for rule in selected:
            for f in rule.check(mod):
                if not mod.suppressed(f.rule, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, len(modules)
