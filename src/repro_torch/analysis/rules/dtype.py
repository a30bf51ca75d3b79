"""Float-dtype discipline on the f64 equivalence paths.

The engine's bit-for-bit contract (scalar ≡ numpy ≡ batched; the ``cuda``
core held to the numpy core's finish times) is a chain of IEEE-754
*double* operations — a single f32 cast or an implicit-dtype array
construction in those modules desyncs the event schedule within a handful
of events.  This rule bans bare ``np.float32``/``jnp.float32`` and
implicit-dtype ``np.zeros``-family constructions in the f64-path
modules, and torch's forms of the same: ``torch.float32`` (``float``,
``half``, ``float16``, ``bfloat16``) and ``torch.zeros / ones / empty /
full`` without ``dtype=`` (their default is ``torch.get_default_dtype()``,
float32; ``torch.full`` with a float fill too).  Deliberately-f32 kernels
(the allocator) opt out with ``# repro: allow-file(float-dtype): <why>``,
and the f32 model oracles that share ``kernels/ref.py`` with the f64
event-step oracle carry per-line ``allow(float-dtype)`` pragmas.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional, Set

from repro_torch.analysis.core import Finding, ModuleInfo, Rule, register

#: the f64 equivalence-path modules (rel to the scan root).  The other
#: kernels (flash_attention, rmsnorm, ssd_scan, ops) are model kernels
#: that compute in f32 *by design* and are out of scope.
FLOAT_DTYPE_SCOPE: Set[str] = {
    "sim/event_core.py",            # the numpy and torch cores
    "kernels/ref.py",               # the f64 event-step oracle (its f32
                                    # model oracles carry per-line allows)
    "kernels/event_step.py",        # CUDA [B, S] step kernel's loader
    "kernels/alloc_active_set.py",  # allocator kernel (f32 by design —
                                    # carries an allow-file pragma)
}

_NP_NAMES = {"np", "numpy", "jnp"}
_TORCH_NAMES = {"torch"}

#: torch's low-precision float dtypes (``torch.float`` is float32)
_TORCH_LOW_FLOATS = {"float32", "float", "half", "float16", "bfloat16"}

#: constructor -> positional index where dtype may be passed.
#: (np.array/asarray inherit the *input's* dtype — deterministic — so
#: only the fill constructors, whose default is the platform float,
#: are held to the explicit-dtype discipline.)
_IMPLICIT_DTYPE_CTORS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2}


def _np_attr(node: ast.AST, names: Set[str] = _NP_NAMES) -> Optional[str]:
    """``np.<attr>`` / ``jnp.<attr>`` (or ``torch.<attr>`` for
    ``names=_TORCH_NAMES``) → attr name, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id in names:
        return node.attr
    return None


@register
class FloatDtypeDiscipline(Rule):
    """No f32 casts or implicit-dtype array constructions on the f64
    equivalence paths."""

    name = "float-dtype"
    description = ("f64 equivalence paths (event cores + step/alloc "
                   "kernels) must not use np/jnp/torch float32 or "
                   "implicit-dtype zeros/ones/empty/full")
    hint = ("pass the dtype explicitly (np.float64 / torch.float64 on "
            "the event schedule, bool/intp for masks/indices); a "
            "deliberately-f32 kernel opts out with "
            "`# repro: allow-file(float-dtype): <why>`")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        if not mod.in_scope(self.name, FLOAT_DTYPE_SCOPE):
            return
        for node in ast.walk(mod.tree):
            attr = _np_attr(node)
            if attr in ("float32", "single") \
                    or _np_attr(node, _TORCH_NAMES) in _TORCH_LOW_FLOATS:
                yield self.finding(
                    mod, node, "f32 dtype on an f64 equivalence path")
                continue
            if not isinstance(node, ast.Call):
                continue
            ctor = _np_attr(node.func, _TORCH_NAMES)
            if ctor in _IMPLICIT_DTYPE_CTORS and not any(
                    kw.arg == "dtype" for kw in node.keywords):
                yield self.finding(
                    mod, node,
                    f"implicit-dtype torch.{ctor}(...) — the tensor's "
                    "dtype is torch's default (float32)")
                continue
            ctor = _np_attr(node.func)
            if ctor not in _IMPLICIT_DTYPE_CTORS:
                continue
            pos = _IMPLICIT_DTYPE_CTORS[ctor]
            has_dtype = any(kw.arg == "dtype" for kw in node.keywords) \
                or len(node.args) > pos
            if not has_dtype:
                yield self.finding(
                    mod, node,
                    f"implicit-dtype np.{ctor}(...) — the array's dtype "
                    "silently follows the input/platform default")
