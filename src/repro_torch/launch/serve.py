"""HAF-orchestrated serving launcher (the paper's deployment shape).

Runs the AI-RAN cluster with the full HAF stack — agentic placement layer
(stand-in or external LLM via --llm-cmd), frozen critic, deadline-aware
allocation — against an Azure-like workload, and reports class-resolved
SLO fulfillment + migration counts.

It runs on the card: the solo run goes through the simulator's default
engine, ``cuda`` (a one-replica ``run_batch``, one ``event_step`` kernel
launch a tick), and a critic that has to be trained first is harvested
and trained there too.  Where CUDA is missing it raises ``RuntimeError``
instead of running on the host.

  PYTHONPATH=src python -m repro_torch.launch.serve --rho 1.0 --requests 5000
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --agent deepseek-r1-70b-sim --no-critic
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

from repro_torch.core import HAFPlacement, make_agent
from repro_torch.core.agent import ExternalLLMAgent
from repro_torch.core.critic import Critic, train_critic
from repro_torch.core.datagen import harvest
from repro_torch.faults.errors import LLMCrashError, LLMTimeoutError
from repro_torch.faults.retry import RetryPolicy, call_with_retries
from repro_torch.sim import (Simulator, WorkloadConfig, generate_workload,
                             paper_scenario)
from repro_torch.sim.engine import DeadlineAwareAllocation

DEFAULT_CRITIC = pathlib.Path(__file__).resolve().parents[3] / \
    "artifacts" / "critic.json"


def make_llm_complete(cmd: str, timeout: float = 120.0, retries: int = 2,
                      backoff_s: float = 0.25, deadline_s=None,
                      sleep=time.sleep):
    """``prompt -> completion`` via a shell command (stdin -> stdout).

    The serving adapter for any external LLM endpoint: the command reads
    the structured placement prompt on stdin and writes the JSON shortlist
    to stdout (e.g. a ``curl`` against a served model, or a local runner).
    Shared by this launcher and the ``haf-llm`` method spec of
    :mod:`repro_torch.eval.policies`.

    Failures raise the typed taxonomy of :mod:`repro_torch.faults.errors` — a
    dead endpoint must fail loudly (empty stdout would otherwise parse as
    "no migration" at every epoch and the sweep would record a
    complete-looking row for an LLM that never answered), but it fails
    *attributably*: :class:`LLMCrashError` carries the stderr tail,
    timeouts surface as :class:`LLMTimeoutError`.  Crashes and timeouts
    retry with exponential backoff (``retries`` extra attempts, base
    ``backoff_s``) under a total wall budget ``deadline_s``; each attempt
    is additionally bounded by ``timeout``.
    """
    policy = RetryPolicy(retries=retries, backoff_s=backoff_s,
                         deadline_s=deadline_s)

    def attempt(prompt: str) -> str:
        try:
            proc = subprocess.run(cmd, shell=True, input=prompt,
                                  capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired as err:
            raise LLMTimeoutError(
                f"LLM command timed out after {timeout:g}s: {cmd!r}") from err
        if proc.returncode != 0:
            err = (proc.stderr or "").strip()
            raise LLMCrashError(
                f"LLM command failed (exit {proc.returncode}): {cmd!r}"
                + (f" — stderr: {err[:500]}" if err else ""),
                stderr_tail=err[:500])
        return proc.stdout

    def complete(prompt: str) -> str:
        return call_with_retries(lambda: attempt(prompt), policy,
                                 sleep=sleep)
    return complete


def make_llm_agent(cmd: str, timeout: float = 120.0, retries: int = 2,
                   backoff_s: float = 0.25,
                   deadline_s=None) -> ExternalLLMAgent:
    """An :class:`ExternalLLMAgent` driving ``cmd`` (see above)."""
    return ExternalLLMAgent(
        make_llm_complete(cmd, timeout, retries=retries,
                          backoff_s=backoff_s, deadline_s=deadline_s),
        name=f"external({cmd})")


def get_critic(path: str, scenario) -> Critic:
    """The critic at ``path``; where there is none, harvest the scenario
    and train one with :func:`train_critic`'s default device (the card),
    and save it there."""
    p = pathlib.Path(path)
    if p.exists():
        return Critic.load(str(p))
    print("[serve] no critic artifact — training one (offline phase)")
    samples = harvest(scenario, verbose=True)
    critic = train_critic(samples)
    critic.save(str(p))
    return critic


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``), serve, print the summary
    and return the run's ``SimResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--requests", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--agent", default="qwen3-32b-sim")
    ap.add_argument("--llm-cmd", default=None,
                    help="external LLM: shell command reading the prompt on "
                         "stdin and writing the JSON shortlist to stdout")
    ap.add_argument("--llm-timeout", type=float, default=120.0)
    ap.add_argument("--llm-retries", type=int, default=2)
    ap.add_argument("--no-fallback", action="store_true",
                    help="disable degradation to the --agent stand-in when "
                         "the external LLM's retry budget is exhausted "
                         "(failures then abort the run, attributably)")
    ap.add_argument("--no-critic", action="store_true")
    ap.add_argument("--critic-path", default=str(DEFAULT_CRITIC))
    ap.add_argument("--epoch-interval", type=float, default=5.0)
    args = ap.parse_args(argv)

    sc = paper_scenario()
    wcfg = WorkloadConfig(rho=args.rho, n_ai_requests=args.requests,
                          seed=args.seed)
    requests, info = generate_workload(wcfg, sc["work_models"])
    print(f"[serve] λ_ai={info['lambda_ai']:.1f}/s "
          f"horizon={info['horizon']:.0f}s")

    fallback = None
    if args.llm_cmd:
        agent = make_llm_agent(args.llm_cmd, args.llm_timeout,
                               retries=args.llm_retries)
        if not args.no_fallback:
            fallback = make_agent(args.agent, seed=args.seed)
    else:
        agent = make_agent(args.agent, seed=args.seed)

    critic = None if args.no_critic else get_critic(args.critic_path, sc)
    policy = HAFPlacement(agent, critic=critic, fallback_agent=fallback)
    sim = Simulator(sc, epoch_interval=args.epoch_interval)
    res = sim.run(requests, policy, DeadlineAwareAllocation())
    s = res.summary()
    print(json.dumps(s, indent=2))
    for t, a in res.migrations:
        print(f"  t={t:8.1f}s {a.describe(sc['instances'], sc['nodes'])}")
    return res


if __name__ == "__main__":
    main()
