"""Named method registry: string -> (placement, allocation, rr_dispatch).

Construction happens inside sweep workers, so methods are referenced by
name + picklable params rather than by live policy objects.  The HAF
critic travels as an artifact path (``critic_path``) and is loaded in the
worker (cached: the B replicas of a batched cell share one frozen
instance); without one, ``haf`` runs agent-only (HAF-NoCritic).
``haf-llm`` swaps the stand-in for an external LLM driven by a shell
command (prompt on stdin, JSON shortlist on stdout — the
:mod:`repro_torch.launch.serve` plumbing), so served endpoints sweep against
the stand-ins with the same harness.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.core.baselines import (AlphaSplitAllocation,
                                        EqualShareAllocation,
                                        GameTheoryPlacement,
                                        LyapunovPlacement, MarketAllocation,
                                        MaxWeightAllocation)
from repro_torch.sim.engine import DeadlineAwareAllocation, StaticPlacement

# (placement, allocation, rr_dispatch) for one simulator run
MethodInstance = Tuple[object, object, bool]
MethodSpec = Union[str, Dict]

_REGISTRY: Dict[str, Callable[..., MethodInstance]] = {}


def register_method(name: str) -> Callable:
    def deco(fn: Callable[..., MethodInstance]) -> Callable:
        _REGISTRY[name] = fn
        return fn
    return deco


def method_names():
    return sorted(_REGISTRY)


def make_method(name: str, **params) -> MethodInstance:
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown method {name!r}; "
                       f"known: {method_names()}") from None
    return fn(**params)


def normalize_method(spec: MethodSpec) -> Dict:
    """"haf" | {"name": ..., "params": ..., "label": ...} -> canonical dict."""
    if isinstance(spec, str):
        return {"name": spec, "params": {}, "label": spec}
    out = {"name": spec["name"], "params": dict(spec.get("params", {}))}
    out["label"] = spec.get("label", out["name"])
    return out


def haf_spec(agent: str = "qwen3-32b-sim",
             critic_path: Optional[str] = None,
             label: str = "HAF", **params) -> Dict:
    """The HAF method spec (single constructor for every sweep frontend)."""
    return {"name": "haf", "label": label,
            "params": {"agent": agent, "critic_path": critic_path,
                       **params}}


# --------------------------------------------------------------------------- #
@register_method("haf-static")
def _haf_static() -> MethodInstance:
    return StaticPlacement(), DeadlineAwareAllocation(), False


@register_method("round-robin")
def _round_robin() -> MethodInstance:
    return StaticPlacement(), EqualShareAllocation(), True


@register_method("lyapunov")
def _lyapunov(V: float = 0.25) -> MethodInstance:
    return LyapunovPlacement(V=V), MaxWeightAllocation(), False


@register_method("game-theory")
def _game_theory(toll: float = 0.1) -> MethodInstance:
    return GameTheoryPlacement(toll=toll), MarketAllocation(), False


@register_method("caora")
def _caora(alpha: float = 0.5) -> MethodInstance:
    return StaticPlacement(), AlphaSplitAllocation(alpha), False


def _load_critic(critic_path: Optional[str]):
    """Resolve + load a critic reference or path (None → agent-only HAF).

    ``critic_path`` may be a plain artifact path (legacy), or a store
    reference — ``@critic``, ``@critic?`` (optional: absent → agent-only),
    ``critic@<fingerprint>`` (pinned) — resolved through
    :mod:`repro_torch.exp.artifacts`.  When a manifest (or pin) promises a
    content fingerprint, the loaded critic is verified against it and a
    changed artifact raises :class:`repro_torch.exp.FingerprintMismatch`.
    """
    if not critic_path:
        return None
    from repro_torch.exp.artifacts import resolve_artifact
    path, expected = resolve_artifact(critic_path)
    if path is None:                         # optional ref, artifact absent
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"critic artifact not found: {path!r} "
            f"(pass critic_path=None for agent-only HAF)")
    from repro_torch.core.critic import load_critic_cached
    return load_critic_cached(path, expect_fingerprint=expected)


def _load_critic_degradable(critic_path: Optional[str], on_error: str):
    """(critic, degraded?) — ``on_error="degrade"`` turns a missing or
    corrupt artifact into agent-only HAF (critic=None) instead of raising;
    the marker is surfaced as the ``critic_degraded`` report column."""
    if on_error == "raise":
        return _load_critic(critic_path), False
    try:
        return _load_critic(critic_path), False
    except Exception as err:  # noqa: BLE001 — the degradation ladder's
        # whole point: any load failure (absent file, fingerprint
        # mismatch, corrupt JSON) downgrades to agent-only
        from repro_torch.obs import diag
        diag(f"# CRITIC DEGRADED (agent-only): {critic_path!r}: "
             f"{type(err).__name__}: {err}")
        return None, True


@register_method("haf")
def _haf(agent: str = "qwen3-32b-sim", seed: int = 0,
         critic_path: Optional[str] = None, K: int = 3,
         critic_on_error: str = "raise") -> MethodInstance:
    from repro_torch.core import HAFPlacement, make_agent
    critic, critic_degraded = _load_critic_degradable(critic_path,
                                                      critic_on_error)
    pol = HAFPlacement(make_agent(agent, seed=seed), critic=critic, K=K)
    pol.critic_degraded = critic_degraded
    return pol, DeadlineAwareAllocation(), False


@register_method("haf-llm")
def _haf_llm(cmd: str, critic_path: Optional[str] = None, K: int = 3,
             timeout: float = 120.0, retries: int = 2,
             backoff_s: float = 0.25, deadline_s: Optional[float] = None,
             fallback_agent: Optional[str] = "qwen3-32b-sim",
             fallback_seed: int = 0,
             critic_on_error: str = "degrade") -> MethodInstance:
    """HAF with a real LLM agent behind ``cmd`` (stdin prompt -> stdout).

    Spec sugar: ``"haf-llm:<cmd>"`` on the CLI.  Batched sweeps run these
    cells too — the epoch pipeline falls back to one completion call per
    replica while the critic still scores the group in one pass.

    This is the hardened external path: endpoint crashes/timeouts retry
    with exponential backoff under the ``deadline_s`` wall budget; once
    the budget is spent (or the reply is malformed), the epoch degrades
    to the ``fallback_agent`` stand-in (``fallback_agent=None`` disables
    degradation and re-raises).  A missing/corrupt critic artifact
    degrades to agent-only by default (``critic_on_error="raise"`` to
    restore strict loading).  Every degraded decision is counted in the
    run summary and the obs trace.
    """
    from repro_torch.core import HAFPlacement, make_agent
    from repro_torch.launch.serve import make_llm_agent
    critic, critic_degraded = _load_critic_degradable(critic_path,
                                                      critic_on_error)
    fb = None if fallback_agent is None \
        else make_agent(fallback_agent, seed=fallback_seed)
    pol = HAFPlacement(
        make_llm_agent(cmd, timeout, retries=retries, backoff_s=backoff_s,
                       deadline_s=deadline_s),
        critic=critic, K=K, fallback_agent=fb)
    pol.critic_degraded = critic_degraded
    return pol, DeadlineAwareAllocation(), False
