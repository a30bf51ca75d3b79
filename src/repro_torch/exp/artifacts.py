"""Versioned artifact store: manifests + content-addressed references.

Critic artifacts (and any future trained artifact) travel through sweeps
as **references**, not bare paths:

  ``@critic``            the artifact named ``critic`` in the store root
  ``@critic?``           same, but optional — resolves to None when absent
  ``critic@1a2b3c``      the store artifact named ``critic`` whose manifest
                         fingerprint starts with ``1a2b3c`` (a pin)
  ``artifacts/c.json``   a plain path (legacy form, still accepted)

Every trained artifact gets a sidecar **manifest**
(``<artifact>.manifest.json``) recording its kind, content fingerprint
(:meth:`repro_torch.core.critic.Critic.fingerprint` — a
``scenario_fingerprint``-style hash of the frozen parameters), the
training families, the training-data hash, and free-form metadata.
Loads made through a reference verify the artifact's fingerprint against
the manifest (or the pin) and raise :class:`FingerprintMismatch` when the
file changed under the manifest — a stale or swapped artifact can no
longer silently gate a sweep.

The store root is ``artifacts/`` under the current directory, or
``$REPRO_ARTIFACTS``.  The store is the JAX package's: the same variable,
manifest format (``kind`` tag, keys, JSON layout) and reference forms, so
one store serves both packages and a critic saved by either resolves, and
verifies, in the other.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import re
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "ArtifactError", "FingerprintMismatch", "artifact_root", "file_sha256",
    "is_ref", "manifest_path", "read_manifest", "resolve_artifact",
    "save_critic", "verify_fingerprint", "write_manifest", "list_manifests",
]

ARTIFACTS_ENV = "REPRO_ARTIFACTS"
MANIFEST_SUFFIX = ".manifest.json"
# the format tag both packages write and check
MANIFEST_KIND = "repro.exp.artifact_manifest"

_PIN_RE = re.compile(r"([A-Za-z0-9_.-]+)@([0-9a-f]{4,64})")


class ArtifactError(ValueError):
    """An artifact reference that cannot be resolved."""


class FingerprintMismatch(ArtifactError):
    """Artifact content no longer matches its manifest / pinned hash."""


def artifact_root(root=None) -> pathlib.Path:
    if root is not None:
        return pathlib.Path(root)
    return pathlib.Path(os.environ.get(ARTIFACTS_ENV, "artifacts"))


def is_ref(text) -> bool:
    """True for store references (``@name`` / ``name@<hex>``) as opposed
    to plain paths."""
    if not isinstance(text, str):
        return False
    text = text.rstrip("?")
    if text.startswith("@"):
        return True
    return bool(_PIN_RE.fullmatch(text)) and not os.path.exists(text)


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
        # creation stamp: metadata only, never read back into any result
        # or resume key
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


def list_manifests(root=None) -> List[Tuple[pathlib.Path, Dict]]:
    """(artifact path, manifest) for every manifest under the store root."""
    root = artifact_root(root)
    out = []
    if not root.is_dir():
        return out
    for mp in sorted(root.glob("*" + MANIFEST_SUFFIX)):
        man = json.loads(mp.read_text())
        if man.get("kind") != MANIFEST_KIND:
            continue
        out.append((mp.with_name(mp.name[:-len(MANIFEST_SUFFIX)]), man))
    return out


def resolve_artifact(ref, root=None
                     ) -> Tuple[Optional[str], Optional[str]]:
    """Reference → ``(path, expected_fingerprint)``.

    ``path`` is None for an optional (``...?``) reference whose artifact
    does not exist; ``expected_fingerprint`` is None when nothing pins the
    content (no manifest and no ``name@hash`` pin).  Plain paths resolve
    to themselves, picking up a fingerprint from a sidecar manifest when
    one exists — so legacy callers gain verification for free.
    """
    if ref is None:
        return None, None
    ref = str(ref).strip()
    optional = ref.endswith("?")
    if optional:
        ref = ref[:-1]
    if not ref:
        raise ArtifactError("empty artifact reference")
    root = artifact_root(root)

    if ref.startswith("@"):
        name = ref[1:]
        if not name:
            raise ArtifactError("empty artifact name in '@' reference")
        path = root / (name if pathlib.Path(name).suffix
                       else name + ".json")
        if not path.exists():
            if optional:
                return None, None
            known = [p.name for p, _ in list_manifests(root)]
            raise ArtifactError(
                f"artifact reference {'@' + name!r}: {path} does not exist"
                + (f"; store has manifests for: {', '.join(known)}"
                   if known else f"; store root {root} has no manifests")
                + " (append '?' to run without it)")
        man = read_manifest(path)
        return str(path), man["fingerprint"] if man else None

    pin = _PIN_RE.fullmatch(ref)
    if pin and not os.path.exists(ref):
        name, prefix = pin.group(1), pin.group(2)
        matches = [(p, man) for p, man in list_manifests(root)
                   if man.get("name") == name
                   and man.get("fingerprint", "").startswith(prefix)]
        if not matches:
            if optional:
                return None, None
            have = [f"{man.get('name')}@{man.get('fingerprint', '')[:12]}"
                    for _, man in list_manifests(root)]
            raise ArtifactError(
                f"no artifact in {root} matches {ref!r}"
                + (f"; store has: {', '.join(have)}" if have else ""))
        if len(matches) > 1:
            raise ArtifactError(
                f"ambiguous artifact pin {ref!r}: "
                + ", ".join(str(p) for p, _ in matches))
        path, man = matches[0]
        return str(path), man["fingerprint"]

    # plain path (legacy): verify only if a manifest rides alongside
    path = pathlib.Path(ref)
    if not path.exists() and optional:
        return None, None
    man = read_manifest(path) if path.exists() else None
    return str(path), man["fingerprint"] if man else None


def verify_fingerprint(path, actual: str, expected: Optional[str]) -> None:
    """Raise :class:`FingerprintMismatch` when a pinned/manifested
    artifact's content hash differs from what was promised."""
    if expected is not None and actual != expected:
        raise FingerprintMismatch(
            f"artifact {path}: content fingerprint {actual[:12]}… does not "
            f"match the manifest/pin {expected[:12]}… — the file changed "
            "since the manifest was written (retrain to refresh the "
            "manifest, or re-pin the reference)")


def file_sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_critic(critic, path, *, families=None,
                data_hash: Optional[str] = None,
                meta: Optional[Dict] = None) -> pathlib.Path:
    """Persist a critic artifact WITH its manifest (the store write path).

    Every trainer should save through this so ``@critic`` references
    verify on load.
    """
    critic.save(str(path))
    return write_manifest(path, kind="critic",
                          fingerprint=critic.fingerprint(),
                          families=families, data_hash=data_hash, meta=meta)
