"""``repro_torch.analysis`` — AST-based invariant linter for the
repro_torch tree (the port of ``repro.analysis``).

The port's core claims (bit-identical solo ≡ batched runs,
seed-deterministic generation, zero-overhead-when-off observability,
resume-safe ``identity_hash``) are enforced here as static rules over a
shared per-module AST.  The rules, pragmas, CLI and JSON report are the
reference linter's, so each honours the other's ``# repro: allow(...)``
pragmas; the rules also read torch's forms of the same mistakes.  See
``docs/torch/analysis.md`` for where the port differs.

>>> from repro_torch.analysis import analyze
>>> findings, n_files = analyze()          # full sweep over src/repro_torch
>>> findings
[]
"""
from repro_torch.analysis.core import (AnalysisError, Finding, ModuleInfo,
                                 Rule, analyze, default_root, get_rule,
                                 iter_modules, load_module, register,
                                 rule_names, rules)
from repro_torch.analysis.cli import main

__all__ = ["AnalysisError", "Finding", "ModuleInfo", "Rule", "analyze",
           "default_root", "get_rule", "iter_modules", "load_module",
           "main", "register", "rule_names", "rules"]
