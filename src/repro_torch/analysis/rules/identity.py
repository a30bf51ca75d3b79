"""Identity-hash completeness: every ``ExperimentSpec`` field must be
classified as result-affecting or excluded — explicitly.

``identity_hash`` drives sweep resume: rows from a previous report are
reused when the result-affecting subset of the spec is unchanged.  A
new spec field that silently stays *out* of the hash poisons resume —
two different experiments would share a hash and cross-resume.
``repro_torch.exp.spec`` therefore declares two module-level registries::

    _IDENTITY_FIELDS = (...)   # in identity(); changing one invalidates
    _EXCLUDED_FIELDS = (...)   # provably non-result-affecting; why, per
                               # field, in the comment beside it

and asserts at import time that they partition
``dataclasses.fields(ExperimentSpec)``.  This rule re-checks the same
partition statically (so the linter catches an unregistered field even
before anything imports), and fails loudly if the registries are
missing altogether.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.core import Finding, ModuleInfo, Rule, register

IDENTITY_SCOPE: Set[str] = {"exp/spec.py"}

_SPEC_CLASS = "ExperimentSpec"
_REGISTRIES = ("_IDENTITY_FIELDS", "_EXCLUDED_FIELDS")


def _str_tuple(node: ast.AST) -> Optional[List[str]]:
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return [e.value for e in node.elts]
    return None


@register
class IdentityHashComplete(Rule):
    """New ``ExperimentSpec`` fields must land in exactly one of
    ``_IDENTITY_FIELDS`` / ``_EXCLUDED_FIELDS``."""

    name = "identity-hash"
    description = ("every ExperimentSpec dataclass field must appear in "
                   "exactly one of _IDENTITY_FIELDS / _EXCLUDED_FIELDS "
                   "in exp/spec.py (resume-safety)")
    hint = ("add the field to _IDENTITY_FIELDS if it can change any "
            "result row, else to _EXCLUDED_FIELDS with a comment "
            "saying why it provably cannot")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if not mod.in_scope(self.name, IDENTITY_SCOPE):
            return
        spec_cls = None
        registries: Dict[str, tuple] = {}   # name -> (names, lineno)
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef) and node.name == _SPEC_CLASS:
                spec_cls = node
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id in _REGISTRIES:
                        names = _str_tuple(node.value)
                        if names is None:
                            yield self.finding(
                                mod, node, f"{tgt.id} must be a literal "
                                "tuple/list of field-name strings")
                        else:
                            registries[tgt.id] = (names, node.lineno)
        if spec_cls is None:
            return                  # nothing to classify in this module
        missing_reg = [r for r in _REGISTRIES if r not in registries]
        if missing_reg:
            yield self.finding(
                mod, spec_cls,
                f"module defines {_SPEC_CLASS} but not the field "
                f"registries {missing_reg}")
            return

        fields: Dict[str, int] = {}
        for stmt in spec_cls.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                fields[stmt.target.id] = stmt.lineno
        ident, ident_line = registries["_IDENTITY_FIELDS"]
        excl, excl_line = registries["_EXCLUDED_FIELDS"]

        for name in sorted(set(ident) & set(excl)):
            yield self.finding(
                mod, ident_line, f"field {name!r} appears in BOTH "
                "_IDENTITY_FIELDS and _EXCLUDED_FIELDS")
        for name, line in fields.items():
            if name not in ident and name not in excl:
                yield self.finding(
                    mod, line, f"{_SPEC_CLASS} field {name!r} is in "
                    "neither _IDENTITY_FIELDS nor _EXCLUDED_FIELDS — "
                    "it would silently stay out of identity_hash")
        for name in ident:
            if name not in fields:
                yield self.finding(
                    mod, ident_line, f"_IDENTITY_FIELDS entry {name!r} "
                    f"is not a {_SPEC_CLASS} field")
        for name in excl:
            if name not in fields:
                yield self.finding(
                    mod, excl_line, f"_EXCLUDED_FIELDS entry {name!r} "
                    f"is not a {_SPEC_CLASS} field")
