"""State–action feature map φ(s_{t_k}, a) for the predictive critic (Eq. 9).

Fixed-size, scale-normalized features so one critic generalizes across load
levels.  Everything is derived from the :class:`EpochSnapshot` — the critic
sees exactly what the agent's prompt describes, no simulator internals.

The canonical entry point is :func:`featurize_batch`: one vectorized
``[C, F]`` evaluation over a snapshot's candidate actions (per-node blocks
are built once and gathered per action).  :func:`featurize` is the
single-action view of the same code path, so solo and batched decide paths
cannot drift — the batched epoch pipeline stacks these rows into the
``[B, C, F]`` critic input without re-deriving anything.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.sim.snapshot import EpochSnapshot
from repro_torch.sim.types import InstanceCategory, MigrationAction

FEATURE_DIM = 40

_CAT_IDX = {InstanceCategory.DU: 0, InstanceCategory.CUUP: 1,
            InstanceCategory.LARGE_AI: 2, InstanceCategory.SMALL_AI: 3}

# feature-vector layout offsets
STATE = 0          # φ[0:9]   global state block
ACT = 9            # φ[9:19]  action block (φ[9] = 1[a≠∅])
SRC = 19           # φ[19:26] source-node block
DST = 26           # φ[26:33] destination-node block
DERIVED = 33       # φ[33:37] interaction terms
CHURN = 37         # φ[37:40] spot-churn block (exactly zero when the
                   # snapshot carries no churn signal, so critics trained
                   # before churn existed see unchanged inputs)


def _log1p_scale(x: np.ndarray, scale: float) -> np.ndarray:
    return np.log1p(np.maximum(x, 0.0) / scale)


def node_blocks(snap: EpochSnapshot) -> np.ndarray:
    """Per-node feature blocks ``[N, 7]`` (built once per snapshot)."""
    N, S = snap.N, snap.S
    gflops = np.array([n.gpu_flops for n in snap.nodes], np.float64)
    vram = np.array([n.vram_bytes for n in snap.nodes], np.float64)
    psi_node = snap.psi_g_by_node()
    counts = np.bincount(snap.placement, minlength=N).astype(np.float64)
    out = np.empty((N, 7))
    out[:, 0] = snap.gpu_util
    out[:, 1] = snap.cpu_util
    out[:, 2] = snap.ran_floor_g
    out[:, 3] = snap.ran_floor_c
    out[:, 4] = snap.vram_headroom / np.maximum(vram, 1.0)
    out[:, 5] = _log1p_scale(psi_node / np.maximum(gflops, 1.0), 1.0)
    out[:, 6] = counts / max(S, 1)
    return out


def featurize_batch(snap: EpochSnapshot,
                    actions: Sequence[Optional[MigrationAction]]
                    ) -> np.ndarray:
    """φ(s, a) for every action → float32 ``[C, FEATURE_DIM]``.

    ``None`` entries (no-migration) get the state block with the action,
    node, and interaction blocks zeroed.
    """
    C = len(actions)
    f = np.zeros((C, FEATURE_DIM))

    # ---- global state (9), shared by every action row -------------------- #
    state = np.empty(9)
    state[0] = np.mean(snap.gpu_util)
    state[1] = np.max(snap.gpu_util)
    state[2] = np.mean(snap.cpu_util)
    state[3] = np.max(snap.cpu_util)
    total_g = float(sum(n.gpu_flops for n in snap.nodes))
    state[4] = _log1p_scale(np.asarray(float(np.sum(snap.psi_g)) / total_g),
                            1.0)
    state[5] = _log1p_scale(np.asarray(float(np.sum(snap.omega))), 100.0)
    state[6] = snap.recent_fulfill.get("LARGE_AI", 1.0)
    state[7] = snap.recent_fulfill.get("SMALL_AI", 1.0)
    state[8] = snap.recent_fulfill.get("RAN", 1.0)
    f[:, STATE:STATE + 9] = state

    rows = [i for i, a in enumerate(actions) if a is not None]
    if rows:
        idx = np.asarray(rows, np.int64)
        migs: List[MigrationAction] = [actions[i] for i in rows]
        insts = [snap.instances[a.sid] for a in migs]
        sids = np.array([a.sid for a in migs], np.int64)
        srcs = np.array([a.src for a in migs], np.int64)
        dsts = np.array([a.dst for a in migs], np.int64)
        gflops = np.array([n.gpu_flops for n in snap.nodes], np.float64)
        q_s = snap.psi_g[sids].astype(np.float64)
        src_g = np.maximum(gflops[srcs], 1.0)
        dst_g = np.maximum(gflops[dsts], 1.0)
        rcfg = np.array([i.reconfig_s for i in insts], np.float64)
        rates = np.array([snap.arrival_rate.get(i.arch, 0.0) for i in insts],
                         np.float64)

        # ---- action block (10) ------------------------------------------ #
        f[idx, ACT] = 1.0
        cats = np.array([_CAT_IDX[i.category] for i in insts], np.int64)
        f[idx, ACT + 1 + cats] = 1.0
        f[idx, ACT + 5] = _log1p_scale(rcfg, 1.0)                    # R_s
        f[idx, ACT + 6] = _log1p_scale(
            np.array([i.weight_bytes for i in insts], np.float64), 1e9)
        f[idx, ACT + 7] = _log1p_scale(
            snap.kv_held[sids].astype(np.float64), 1e9)
        f[idx, ACT + 8] = _log1p_scale(
            snap.queue_len[sids].astype(np.float64), 10.0)
        f[idx, ACT + 9] = _log1p_scale(q_s / dst_g, 1.0)
        # ---- source / destination node blocks (7 + 7) -------------------- #
        blocks = node_blocks(snap)
        f[idx, SRC:SRC + 7] = blocks[srcs]
        f[idx, DST:DST + 7] = blocks[dsts]
        # ---- derived interaction terms (4) -------------------------------- #
        f[idx, DERIVED] = snap.gpu_util[srcs] - snap.gpu_util[dsts]
        f[idx, DERIVED + 1] = snap.cpu_util[srcs] - snap.cpu_util[dsts]
        f[idx, DERIVED + 2] = _log1p_scale(q_s / src_g, 1.0) \
            - _log1p_scale(q_s / dst_g, 1.0)
        # outage cost proxy: R_s × service arrival pressure
        f[idx, DERIVED + 3] = _log1p_scale(rcfg * rates, 1.0)
        # ---- spot-churn block (3): forced-evacuation context ------------- #
        # src/dst at risk (draining on a preemption notice, or already at
        # reduced capacity) and the dst's lost capacity fraction
        scale = snap.node_scale
        drain = snap.drain_until
        if scale is not None or drain is not None:
            if scale is None:
                scale = np.ones(snap.N)
            if drain is None:
                drain = np.zeros(snap.N)
            draining = drain > snap.t
            src_risk = draining[srcs] | (scale[srcs] < 1.0)
            dst_risk = draining[dsts] | (scale[dsts] < 1.0)
            f[idx, CHURN] = src_risk.astype(np.float64)
            f[idx, CHURN + 1] = dst_risk.astype(np.float64)
            f[idx, CHURN + 2] = 1.0 - scale[dsts]

    return f.astype(np.float32)


def featurize(snap: EpochSnapshot,
              action: Optional[MigrationAction]) -> np.ndarray:
    """φ(s, a) → float32 [FEATURE_DIM] (one row of :func:`featurize_batch`)."""
    return featurize_batch(snap, [action])[0]
