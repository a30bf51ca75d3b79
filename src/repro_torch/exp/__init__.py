"""Experiment plumbing of the port: so far only the artifact manifests that
a trained critic travels with (:mod:`repro_torch.exp.artifacts`)."""
from repro_torch.exp.artifacts import (ArtifactError, FingerprintMismatch,
                                       manifest_path, read_manifest,
                                       save_critic, verify_fingerprint,
                                       write_manifest)

__all__ = ["ArtifactError", "FingerprintMismatch", "manifest_path",
           "read_manifest", "save_critic", "verify_fingerprint",
           "write_manifest"]
