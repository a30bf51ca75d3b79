"""Declarative experiment API: specs, grammar, artifacts, provenance.

The single way every frontend declares work::

    from repro_torch.exp import ExperimentSpec, run_experiment

    spec = ExperimentSpec(
        methods=("haf(agent=qwen3-32b-sim, critic=@critic?)", "haf-static"),
        scenarios=("paper", "flash-crowd(rho=0.95, n_ai_requests=4000)"),
        seeds="0..4", workers=4, out="artifacts/my_sweep.json")
    spec.to_file("experiments/my_sweep.toml")    # …or check it in
    report = run_experiment(spec)                # resumable, stamped

CLI: ``python -m repro_torch.eval --spec experiments/my_sweep.toml`` (plus
flag overrides; ``--validate`` dry-runs the expansion).  See
``experiments/README.md`` for the spec-file format and the grammar.

The layer is the JAX package's ``repro.exp``, with the same spec fields,
hashes, report and manifest formats and artifact store, so a report or a
critic written by either package resumes or loads in the other.  The
engines are this package's (``numpy | scalar | torch | cuda``), and the
default is ``cuda``: the sweep's ``[B, S]`` blocks on the hand-written
``event_step`` kernel.
"""
from repro_torch.exp.artifacts import (ArtifactError, FingerprintMismatch,
                                       artifact_root, is_ref, list_manifests,
                                       manifest_path, read_manifest,
                                       resolve_artifact, save_critic,
                                       write_manifest)
from repro_torch.exp.grammar import (GrammarError, format_method,
                                     format_scenario, format_value,
                                     parse_method, parse_methods,
                                     parse_scenario, parse_scenarios,
                                     parse_seeds, parse_value)
from repro_torch.exp.provenance import backend_info, build_provenance
from repro_torch.exp.runner import expand_experiment, job_table, run_experiment
from repro_torch.exp.spec import ExperimentSpec, SpecError, load_experiment

__all__ = [
    "ArtifactError", "FingerprintMismatch", "artifact_root", "is_ref",
    "list_manifests", "manifest_path", "read_manifest", "resolve_artifact",
    "save_critic", "write_manifest",
    "GrammarError", "format_method", "format_scenario", "format_value",
    "parse_method", "parse_methods", "parse_scenario", "parse_scenarios",
    "parse_seeds", "parse_value",
    "backend_info", "build_provenance",
    "expand_experiment", "job_table", "run_experiment",
    "ExperimentSpec", "SpecError", "load_experiment",
]
