"""Determinism rules: seeded RNG only, no wall-clock in result paths,
no iteration over unordered sets.

Every scenario, churn schedule, and critic harvest in this repo must be
a pure function of its seed — that is what makes batched ≡ solo runs
bit-identical and sweeps resumable.  These rules ban the three classic
ways nondeterminism sneaks in; ``no-module-rng`` also reads torch's
global generator (the port threads a ``torch.Generator`` everywhere).
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional, Set

from repro_torch.analysis.core import Finding, ModuleInfo, Rule, register

# np.random.<ctor> forms that build *seeded* generators are fine; the
# module-level convenience API (np.random.rand/seed/normal/...) shares
# hidden global state across call sites and is banned outright.
_SEEDED_CTORS = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "MT19937", "SFC64", "BitGenerator",
                 "RandomState"}  # RandomState(seed) is legacy-but-seeded
_NP_NAMES = {"np", "numpy"}

#: torch's global-generator seeders, banned outright
_TORCH_SEEDERS = {"torch.manual_seed", "torch.seed", "torch.random.seed",
                  "torch.random.manual_seed", "torch.cuda.manual_seed",
                  "torch.cuda.manual_seed_all", "torch.cuda.seed",
                  "torch.cuda.seed_all"}
#: torch factories that draw from the global generator unless given
#: ``generator=``
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "poisson", "rand_like",
                   "randn_like", "randint_like"}
#: in-place samplers of a tensor (or ``nn.init``), the same
_INPLACE_SAMPLERS = {"uniform_", "normal_", "random_", "exponential_",
                     "bernoulli_", "cauchy_", "log_normal_", "geometric_"}

#: modules allowed to read the wall clock without a per-line allow —
#: sweep timing is *report metadata* (wall_s columns), never an input
#: to any simulated result
WALL_CLOCK_ALLOWLIST: Set[str] = {"eval/sweep.py", "eval/cli.py"}

_WALL_CLOCK_CALLS = {"time.time", "time.time_ns",
                     "datetime.now", "datetime.utcnow",
                     "datetime.datetime.now", "datetime.datetime.utcnow",
                     "date.today", "datetime.date.today"}


@register
class NoModuleRNG(Rule):
    """Ban ``np.random.*`` module-level RNG and the stdlib ``random``
    module — all randomness must flow through a seeded Generator."""

    name = "no-module-rng"
    description = ("no np.random module-level RNG / stdlib random / "
                   "torch's global generator: randomness must come from "
                   "a seeded np.random.default_rng or torch.Generator "
                   "threaded from the caller")
    hint = ("thread a seeded np.random.default_rng(seed) (or a "
            "Generator built from one) from the scenario/spec seed; in "
            "torch pass generator=torch.Generator().manual_seed(seed)")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random":
                        yield self.finding(
                            mod, node, "import of the stdlib `random` "
                            "module (global hidden RNG state)")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    yield self.finding(
                        mod, node, "import from the stdlib `random` "
                        "module (global hidden RNG state)")
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Attribute) \
                    and isinstance(node.value.value, ast.Name) \
                    and node.value.value.id in _NP_NAMES \
                    and node.value.attr == "random" \
                    and node.attr not in _SEEDED_CTORS:
                yield self.finding(
                    mod, node,
                    f"np.random.{node.attr}: module-level RNG "
                    "(hidden global state shared across call sites)")
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                msg = _torch_global_draw(node)
                if msg is not None:
                    yield self.finding(mod, node, msg)


def _torch_global_draw(call: ast.Call) -> Optional[str]:
    """Why ``call`` draws from torch's global generator, else None."""
    name = ast.unparse(call.func)
    if name in _TORCH_SEEDERS:
        return (f"{name}(): seeds torch's global generator (hidden state "
                "shared across call sites)")
    if any(kw.arg == "generator" for kw in call.keywords):
        return None
    attr = call.func.attr
    if name == f"torch.{attr}" and attr in _TORCH_SAMPLERS:
        return f"{name}() without generator=: torch's global generator"
    if attr in _INPLACE_SAMPLERS:
        return (f".{attr}() without generator=: torch's global "
                "generator")
    return None


@register
class NoWallClock(Rule):
    """Ban wall-clock reads outside the timing/metadata allowlist —
    simulated time is the engine's ``t``, never the host clock."""

    name = "wall-clock"
    description = ("no time.time()/datetime.now() outside the "
                   "report-timing allowlist: results must not depend "
                   "on when they were computed")
    hint = ("simulated time is the engine clock `t`; if this really is "
            "report metadata, add `# repro: allow(wall-clock): <why>` "
            "or extend WALL_CLOCK_ALLOWLIST")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if mod.rel in WALL_CLOCK_ALLOWLIST:
            return
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            try:
                name = ast.unparse(node.func)
            except Exception:       # pragma: no cover - unparse is total
                continue
            if name in _WALL_CLOCK_CALLS:
                yield self.finding(mod, node, f"wall-clock read {name}()")


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.BitOr, ast.BitAnd,
                                     ast.Sub, ast.BitXor)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _walk_scope(scope: ast.AST):
    """Walk ``scope`` without descending into nested function scopes
    (each function gets its own pass with its own set-name table)."""
    stack = [scope]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _set_names_in(fn: ast.AST) -> Set[str]:
    """Names whose *every* assignment inside ``fn`` is a set expression
    (single-name targets only; conservative on purpose)."""
    assigned: dict = {}
    for node in _walk_scope(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
            value = None            # unknowable — poisons the name
        else:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                is_set = value is not None and _is_set_expr(value)
                assigned[tgt.id] = assigned.get(tgt.id, True) and is_set
    return {name for name, ok in assigned.items() if ok}


@register
class NoSetIteration(Rule):
    """Ban iterating directly over an unordered set — hash-order leaks
    into whatever the loop produces.  ``sorted(s)`` is the fix."""

    name = "set-iteration"
    description = ("no iteration over unordered sets: set hash order "
                   "is not part of the determinism contract")
    hint = "iterate sorted(<set>) so the order is a function of the data"

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        scopes = [mod.tree] + [
            n for n in ast.walk(mod.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            local_sets = _set_names_in(scope)
            for sub in _walk_scope(scope):
                iters = []
                if isinstance(sub, (ast.For, ast.AsyncFor)):
                    iters = [sub.iter]
                elif isinstance(sub, (ast.ListComp, ast.SetComp,
                                      ast.DictComp, ast.GeneratorExp)):
                    iters = [g.iter for g in sub.generators]
                for it in iters:
                    if _is_set_expr(it):
                        yield self.finding(
                            mod, it, "iteration directly over a set "
                            "expression (unordered)")
                    elif isinstance(it, ast.Name) and it.id in local_sets:
                        yield self.finding(
                            mod, it, f"iteration over set-typed local "
                            f"{it.id!r} (unordered)")
