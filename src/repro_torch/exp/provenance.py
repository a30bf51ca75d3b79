"""Provenance stamping + resume keys for experiment reports.

Every report produced through :func:`repro_torch.exp.run_experiment` embeds a
``provenance`` block:

  * the canonical spec and its two hashes (full + result identity),
  * the **scenario fingerprint** of every distinct cell (the
    ``repro_torch.sim.scenarios`` determinism certificate, so a report can be
    audited against regenerated scenarios byte-for-byte),
  * the resolved **critic/artifact references** with their manifest
    fingerprints (which artifact actually gated each HAF cell),
  * engine/backend versions (python, numpy, torch, CUDA, platform, and
    the card's name where the engine runs on one).

Resume keys on ``(resume_key, method label, scenario label, seed)``:
``resume_key`` is the spec's identity hash combined with the resolved
artifact fingerprints, so retraining a critic — same path, new content —
invalidates old rows even though the spec text did not change.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import platform
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.exp.artifacts import (file_sha256, read_manifest,
                                       resolve_artifact)

__all__ = [
    "backend_info", "build_provenance", "job_key", "row_key",
    "completed_rows", "load_prior_report", "resume_key",
]

# method params that name a loadable artifact (resolved + fingerprinted)
ARTIFACT_PARAMS = ("critic_path",)


def backend_info(engine: str, device="cuda") -> Dict:
    """Versions of what ran the rows.  ``device`` is the card's name when
    the engine is a device one (``cuda``, or ``torch`` on a CUDA device)
    and a card is there, ``"cpu"`` for ``torch`` on the host, else None."""
    import numpy as np
    import torch
    info = {
        "engine": engine,
        "python": sys.version.split()[0],
        "numpy": np.__version__,
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": None,
    }
    if engine in ("torch", "cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and torch.cuda.is_available():
            info["device"] = torch.cuda.get_device_name(dev)
        elif dev.type == "cpu":
            info["device"] = "cpu"
    return info


def scenario_fingerprints(jobs: Sequence[Dict]) -> Dict[str, str]:
    """``{scenario label: fingerprint}`` over the attached scenarios."""
    from repro_torch.sim.scenarios import scenario_fingerprint
    out: Dict[str, str] = {}
    cache: Dict[int, str] = {}
    for job in jobs:
        label = job["scenario_label"]
        sc = job.get("scenario")
        if label in out or sc is None:
            continue
        key = id(sc)
        if key not in cache:
            cache[key] = scenario_fingerprint(sc)
        out[label] = cache[key]
    return out


def artifact_provenance(spec) -> Dict[str, Dict]:
    """Resolved artifact references across the spec's methods.

    ``{ref: {"path", "fingerprint", "families", "data_hash"}}`` — the
    fingerprint comes from the manifest when one exists, else the file
    content hash is recorded (as ``file_sha256``) so the report still
    pins what was loaded.
    """
    out: Dict[str, Dict] = {}
    for m in spec.methods:
        for key in ARTIFACT_PARAMS:
            ref = m["params"].get(key)
            if not ref or str(ref) in out:
                continue
            path, expected = resolve_artifact(ref)
            entry: Dict = {"path": path}
            if path is None:
                entry["missing"] = True       # optional ref, absent artifact
            elif not pathlib.Path(path).exists():
                from repro_torch.exp.artifacts import ArtifactError
                raise ArtifactError(
                    f"method {m['label']!r}: critic artifact not found: "
                    f"{path!r} (append '?' to a store reference, or pass "
                    "critic_path=none, for agent-only HAF)")
            elif expected is not None:
                entry["fingerprint"] = expected
                man = read_manifest(path) or {}
                for field in ("families", "data_hash"):
                    if field in man:
                        entry[field] = man[field]
            elif pathlib.Path(path).exists():
                entry["file_sha256"] = file_sha256(path)
            out[str(ref)] = entry
    return out


def resume_key(spec, artifacts: Dict[str, Dict]) -> str:
    """Identity hash + resolved artifact content: rows keyed under this
    are interchangeable across runs."""
    pins = sorted((ref, e.get("fingerprint") or e.get("file_sha256")
                   or ("missing" if e.get("missing") else e.get("path")))
                  for ref, e in artifacts.items())
    blob = json.dumps([spec.identity_hash(), pins], sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def build_provenance(spec, jobs: Sequence[Dict], device="cuda") -> Dict:
    artifacts = artifact_provenance(spec)
    return {
        "spec": spec.canonical(),
        "spec_hash": spec.spec_hash(),
        "identity_hash": spec.identity_hash(),
        "resume_key": resume_key(spec, artifacts),
        "scenario_fingerprints": scenario_fingerprints(jobs),
        "artifacts": artifacts,
        "backend": backend_info(spec.engine, device),
    }


# ------------------------------------------------------------------ #
# resume
# ------------------------------------------------------------------ #
def job_key(job: Dict) -> Tuple[str, str, int]:
    return (job["method_label"], job["scenario_label"], int(job["seed"]))


def row_key(row: Dict) -> Tuple[str, str, int]:
    return (row["method"], row["scenario"], int(row["seed"]))


def load_prior_report(path) -> Optional[Dict]:
    path = pathlib.Path(path)
    if not path.exists():
        return None
    try:
        report = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if report.get("kind") != "repro.eval.sweep_report":
        return None
    return report


def completed_rows(report: Optional[Dict], key: str) -> Dict[Tuple, Dict]:
    """Resumable rows of a prior report: non-truncated completions whose
    provenance resume key matches ``key`` (else nothing resumes)."""
    if not report:
        return {}
    prov = report.get("provenance") or {}
    if prov.get("resume_key") != key:
        return {}
    out: Dict[Tuple, Dict] = {}
    for row in report.get("runs", ()):
        if row.get("truncated"):
            continue                 # truncated rows recompute on resume
        out[row_key(row)] = row
    return out
