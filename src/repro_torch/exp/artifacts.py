"""Artifact manifests: a trained critic and the sidecar that vouches for it.

Every trained artifact gets a sidecar **manifest**
(``<artifact>.manifest.json``) recording its kind, content fingerprint
(:meth:`repro_torch.core.critic.Critic.fingerprint` — a hash of the frozen
parameters), the training families, the training-data hash, and free-form
metadata.  A load that is handed the manifest's fingerprint verifies the
artifact against it and raises :class:`FingerprintMismatch` when the file
changed under the manifest — a stale or swapped artifact can no longer
silently gate a run.

The manifest format is the JAX package's (same ``kind`` tag, keys and
JSON layout), so a critic saved here loads, with its manifest, there and
the other way round.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, Optional

__all__ = [
    "ArtifactError", "FingerprintMismatch", "manifest_path", "read_manifest",
    "save_critic", "verify_fingerprint", "write_manifest",
]

MANIFEST_SUFFIX = ".manifest.json"
# the format tag both packages write and check
MANIFEST_KIND = "repro.exp.artifact_manifest"


class ArtifactError(ValueError):
    """An artifact or manifest that cannot be used."""


class FingerprintMismatch(ArtifactError):
    """Artifact content no longer matches its manifest / pinned hash."""


def manifest_path(path) -> pathlib.Path:
    path = pathlib.Path(path)
    return path.with_name(path.name + MANIFEST_SUFFIX)


def write_manifest(path, *, kind: str, fingerprint: str,
                   families=None, data_hash: Optional[str] = None,
                   meta: Optional[Dict] = None) -> pathlib.Path:
    """Sidecar manifest for a trained artifact (returned path)."""
    path = pathlib.Path(path)
    man = {
        "kind": MANIFEST_KIND,
        "artifact_kind": kind,
        "artifact": path.name,
        "name": path.name[:-len(path.suffix)] if path.suffix else path.name,
        "fingerprint": fingerprint,
        # creation stamp: metadata only, never read back into a result
        "created_unix_s": round(time.time(), 3),
    }
    if families is not None:
        man["families"] = sorted(families)
    if data_hash is not None:
        man["data_hash"] = data_hash
    if meta:
        man["meta"] = dict(meta)
    mp = manifest_path(path)
    mp.parent.mkdir(parents=True, exist_ok=True)
    mp.write_text(json.dumps(man, indent=2, sort_keys=True))
    return mp


def read_manifest(path) -> Optional[Dict]:
    """The artifact's sidecar manifest, or None if it has none."""
    mp = manifest_path(path)
    if not mp.exists():
        return None
    man = json.loads(mp.read_text())
    if man.get("kind") != MANIFEST_KIND:
        raise ArtifactError(f"{mp} is not an artifact manifest "
                            f"(kind={man.get('kind')!r})")
    return man


def verify_fingerprint(path, actual: str, expected: Optional[str]) -> None:
    """Raise :class:`FingerprintMismatch` when a pinned/manifested
    artifact's content hash differs from what was promised."""
    if expected is not None and actual != expected:
        raise FingerprintMismatch(
            f"artifact {path}: content fingerprint {actual[:12]}… does not "
            f"match the manifest/pin {expected[:12]}… — the file changed "
            "since the manifest was written (retrain to refresh the "
            "manifest, or re-pin the reference)")


def save_critic(critic, path, *, families=None,
                data_hash: Optional[str] = None,
                meta: Optional[Dict] = None) -> pathlib.Path:
    """Persist a critic artifact WITH its manifest; returns the manifest's
    path."""
    critic.save(str(path))
    return write_manifest(path, kind="critic",
                          fingerprint=critic.fingerprint(),
                          families=families, data_hash=data_hash, meta=meta)
