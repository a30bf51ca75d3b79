"""Predictive critic r̂_θ (paper §III-B, Eq. 9–11).

A 2-layer MLP (Table I) mapping φ(s, a) to a class-resolved fulfillment
forecast (r̂_L, r̂_S, r̂_R) ∈ [0,1]³, trained offline by supervised L2
regression on placement-epoch samples (Eq. 10) and FROZEN at deployment.
Selection uses a class-urgency-weighted mean r̄ (Eq. 11).

Training is PyTorch on the card: :class:`CriticNet` is an ``nn.Module`` in
the factored form, updated by the hand-written Adam below (the same update,
hyper-parameters and minibatch order as the JAX reference).  **Deployment
scoring** runs the frozen net through :func:`forward_np`, a numpy float64
forward on the host whose matmuls reduce by pairwise halving
(:func:`_tree_matmul`): every output element depends only on its own input
row through a fixed reduction order, so a ``[B, C, F]`` batched-epoch
evaluation scores each replica's options bit-for-bit as a solo ``[C, F]``
call would — the invariant the batched engine's discrete-outcome identity
rests on (BLAS / cuBLAS matmuls do not give this: their blocking changes
with the batch dimension).

A :class:`Critic` holds its frozen parameters as the parameter tree of the
JSON artifact — ``{"base": {"w1", "b1", …}, "delta": {…}}`` (or
``{"net": {…}}``) of float32 arrays, each ``w`` laid out ``[in, out]`` — so
artifacts, :meth:`Critic.fingerprint` values and saved files are
interchangeable with the JAX package's.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.features import FEATURE_DIM, featurize, featurize_batch
from repro_torch.sim.event_core import resolve_device
from repro_torch.sim.snapshot import EpochSnapshot
from repro_torch.sim.types import MigrationAction

# class weights for r̄(·): RAN is the hard constraint, large-AI is the
# binding objective term, small-AI is rarely at risk.
DEFAULT_CLASS_WEIGHTS = (0.45, 0.15, 0.40)   # (large, small, ran)


STATE_DIM = 9        # features.py: φ[0:9] is the state block, φ[9] = 1[a≠∅]
MIG_FLAG = 9

# parameter-tree leaves of one MLP, in the artifact's order: (name, layer)
_LEAVES = (("w1", "l1"), ("b1", "l1"), ("w2", "l2"), ("b2", "l2"),
           ("w3", "l3"), ("b3", "l3"))


# ----------------------------- training net -------------------------------- #
class _MLP(nn.Module):
    """relu(x W1 + b1) → relu(· W2 + b2) → · W3 + b3."""

    def __init__(self, in_dim: int, hidden: int, out: int, device):
        super().__init__()
        # skip_init: the weights are written by CriticNet, so the global
        # torch RNG is never drawn from
        self.l1 = nn.utils.skip_init(nn.Linear, in_dim, hidden, device=device)
        self.l2 = nn.utils.skip_init(nn.Linear, hidden, hidden, device=device)
        self.l3 = nn.utils.skip_init(nn.Linear, hidden, out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.l1(x))
        h = torch.relu(self.l2(h))
        return self.l3(h)

    def load_tree(self, tree: Dict) -> None:
        with torch.no_grad():
            for name, layer in _LEAVES:
                lin = getattr(self, layer)
                v = torch.as_tensor(np.asarray(tree[name], np.float32))
                if name[0] == "w":              # artifact [in, out]
                    lin.weight.copy_(v.T)       # nn.Linear [out, in]
                else:
                    lin.bias.copy_(v)

    def tree(self) -> Dict[str, np.ndarray]:
        out = {}
        for name, layer in _LEAVES:
            lin = getattr(self, layer)
            v = lin.weight.T if name[0] == "w" else lin.bias
            out[name] = np.ascontiguousarray(
                v.detach().to("cpu", torch.float32).numpy())
        return out


class CriticNet(nn.Module):
    """The training-time net: ``factored`` is r̂(s,a) = σ(base(s) +
    1[a≠∅]·Δ(s,a)) with ``base`` on φ[0:9] and ``delta`` on φ — no-migration
    is the structural reference, so action ranking is carried entirely by Δ
    and counterfactual (same-state, different-action) samples supervise it
    directly.  ``mlp`` is the paper's plain 2-layer head (kept as ablation).
    """

    def __init__(self, hidden: int = 64, in_dim: int = FEATURE_DIM,
                 arch: str = "factored", device="cpu"):
        super().__init__()
        if arch not in ("factored", "mlp"):
            raise ValueError(f"unknown critic arch {arch!r}")
        self.arch = arch
        if arch == "mlp":
            self.net = _MLP(in_dim, hidden, 3, device)
        else:
            self.base = _MLP(STATE_DIM, hidden, 3, device)
            self.delta = _MLP(in_dim, hidden, 3, device)

    def _parts(self) -> Tuple[str, ...]:
        return ("net",) if self.arch == "mlp" else ("base", "delta")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., F] -> r̂ [..., 3] in [0, 1]."""
        if self.arch == "mlp":
            return torch.sigmoid(self.net(x))
        logits = self.base(x[..., :STATE_DIM])
        delta = self.delta(x) * x[..., MIG_FLAG:MIG_FLAG + 1]
        return torch.sigmoid(logits + delta)

    @classmethod
    def from_params(cls, params: Dict, device="cpu") -> "CriticNet":
        """A net holding an artifact parameter tree (``w`` as ``[in, out]``)."""
        arch = "mlp" if "net" in params else "factored"
        first = params["net" if arch == "mlp" else "delta"]
        in_dim, hidden = np.shape(first["w1"])
        net = cls(hidden=hidden, in_dim=in_dim, arch=arch, device=device)
        for part in net._parts():
            getattr(net, part).load_tree(params[part])
        return net

    def params(self) -> Dict:
        """The artifact parameter tree, float32 numpy on the host."""
        return {part: getattr(self, part).tree() for part in self._parts()}


def init_params(seed: int = 0, hidden: int = 64, in_dim: int = FEATURE_DIM,
                arch: str = "factored") -> Dict:
    """Initial parameter tree drawn from a ``torch.Generator`` seeded by
    ``seed``: ``w ~ N(0, 1/in)`` (the last layer ×0.1), ``b = 0``.  The
    draws are on the CPU, so a seed gives the same weights on every
    device (they differ from the JAX package's, whose RNG is another)."""
    gen = torch.Generator().manual_seed(int(seed))

    def mlp(i: int, h: int, o: int) -> Dict[str, np.ndarray]:
        s1, s2 = 1.0 / np.sqrt(i), 1.0 / np.sqrt(h)

        def normal(*shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32)
        return {"w1": (normal(i, h) * s1).numpy(),
                "b1": np.zeros(h, np.float32),
                "w2": (normal(h, h) * s2).numpy(),
                "b2": np.zeros(h, np.float32),
                "w3": (normal(h, o) * (s2 * 0.1)).numpy(),
                "b3": np.zeros(o, np.float32)}

    if arch == "mlp":
        return {"net": mlp(in_dim, hidden, 3)}
    return {"base": mlp(STATE_DIM, hidden, 3),
            "delta": mlp(in_dim, hidden, 3)}


# ----------------- deployment forward (numpy, batch-invariant) ------------- #
def _pow2_at_least(n: int) -> int:
    k = 1
    while k < n:
        k <<= 1
    return k


def _tree_matmul(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """``x [..., K] @ w [K, H]`` with a pairwise-halving K reduction.

    The input axis is zero-padded to a power of two and folded in halves;
    folding an all-zero upper half returns the lower half unchanged, so
    each ``[..., h]`` output is a fixed-order sum over its own row only —
    identical doubles whatever the leading batch shape is.
    """
    K, H = w.shape
    Kp = _pow2_at_least(K)
    prod = np.zeros(x.shape[:-1] + (H, Kp))
    prod[..., :K] = x[..., None, :] * w.T
    while prod.shape[-1] > 1:
        h = prod.shape[-1] // 2
        prod = prod[..., :h] + prod[..., h:]
    return prod[..., 0]


def _mlp_np(params: Dict[str, np.ndarray], x: np.ndarray) -> np.ndarray:
    h = np.maximum(_tree_matmul(x, params["w1"]) + params["b1"], 0.0)
    h = np.maximum(_tree_matmul(h, params["w2"]) + params["b2"], 0.0)
    return _tree_matmul(h, params["w3"]) + params["b3"]


def _np_tree(tree) -> Dict:
    return {k: _np_tree(v) if isinstance(v, dict)
            else np.asarray(v, np.float64) for k, v in tree.items()}


def _sigmoid_np(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-z))


def forward_np(params_np: Dict, x: np.ndarray) -> np.ndarray:
    """x [..., F] -> r̂ [..., 3] in float64 numpy, batch-shape invariant."""
    x = np.asarray(x, np.float64)
    if "net" in params_np:                   # plain 2-layer MLP (ablation)
        return _sigmoid_np(_mlp_np(params_np["net"], x))
    logits = _mlp_np(params_np["base"], x[..., :STATE_DIM])
    delta = _mlp_np(params_np["delta"], x) * x[..., MIG_FLAG:MIG_FLAG + 1]
    return _sigmoid_np(logits + delta)


# ------------------------------ training ----------------------------------- #
def loss_fn(net: CriticNet, x: torch.Tensor, r: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 10 — L2 regression; ``mask`` [B,3] weights classes with samples."""
    sq = torch.square(net(x) - r)
    if mask is not None:
        return torch.sum(sq * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(sq)


def adam_init(net: CriticNet) -> Dict:
    """Adam moments (zeros like every parameter) and the step count."""
    ps = list(net.parameters())
    return {"m": [torch.zeros_like(p) for p in ps],
            "v": [torch.zeros_like(p) for p in ps],
            "t": 0}


@torch.no_grad()
def adam_step(params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict, lr: float = 1e-3, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam update in place: m ← b1·m + (1−b1)·g, v ← b2·v + (1−b2)·g²,
    p ← p − lr·m̂ / (√v̂ + eps) with m̂ = m/(1−b1ᵗ), v̂ = v/(1−b2ᵗ) — the
    reference's update as written, over all leaves at once."""
    state["t"] += 1
    t = state["t"]
    m, v = state["m"], state["v"]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, grads, alpha=1.0 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
    # bias corrections in float32, as the reference's float32 step count
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
    mh = torch._foreach_div(m, c1)
    den = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(mh, den)
    torch._foreach_add_(params, mh, alpha=-lr)


def train_step(net: CriticNet, opt: Dict, x: torch.Tensor, r: torch.Tensor,
               mask: Optional[torch.Tensor], lr: float = 1e-3
               ) -> torch.Tensor:
    """One minibatch: Eq. 10 loss, its gradient, one Adam update.  Returns
    the loss before the update (a 0-d tensor on the net's device)."""
    params = list(net.parameters())
    loss = loss_fn(net, x, r, mask)
    grads = torch.autograd.grad(loss, params)
    adam_step(params, list(grads), opt, lr=lr)
    return loss.detach()


@dataclasses.dataclass
class Critic:
    """Frozen-at-deployment critic with train/save/load utilities.

    ``params`` is the artifact parameter tree (float32 numpy, ``w`` as
    ``[in, out]``)."""
    params: Dict
    class_weights: Tuple[float, float, float] = DEFAULT_CLASS_WEIGHTS

    # ---- frozen-net caches (deployment path) ---- #
    @property
    def params_np(self) -> Dict:
        cache = getattr(self, "_params_np", None)
        if cache is None:
            cache = _np_tree(self.params)
            object.__setattr__(self, "_params_np", cache)
        return cache

    def fingerprint(self) -> str:
        """Content hash of the frozen parameters (+ class weights): equal
        fingerprints mean interchangeable critics, so the batched epoch
        pipeline can group replicas that loaded the same artifact."""
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            h = hashlib.sha256()
            h.update(repr(tuple(self.class_weights)).encode())

            def feed(tree):
                for k in sorted(tree):
                    v = tree[k]
                    if isinstance(v, dict):
                        h.update(k.encode())
                        feed(v)
                    else:
                        h.update(k.encode())
                        h.update(np.ascontiguousarray(
                            np.asarray(v, np.float32)).tobytes())
            feed(self.params)
            fp = h.hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    # ---- scoring (deployment path) ---- #
    def predict(self, snap: EpochSnapshot,
                action: Optional[MigrationAction]) -> np.ndarray:
        return forward_np(self.params_np, featurize(snap, action)[None])[0]

    def predict_batch(self, snap: EpochSnapshot, actions) -> np.ndarray:
        return forward_np(self.params_np, featurize_batch(snap, actions))

    def score(self, r_hat: np.ndarray) -> np.ndarray:
        """r̄(·) — Eq. 11 weighted mean over (large, small, ran).

        Fixed-order fused sum (not a matmul) so scores are identical
        whether computed for one replica or a padded ``[B, C]`` block."""
        w = np.asarray(self.class_weights, np.float64)
        wn = w / w.sum()
        return (r_hat[..., 0] * wn[0] + r_hat[..., 1] * wn[1]
                + r_hat[..., 2] * wn[2])

    def select(self, snap: EpochSnapshot, shortlist: Sequence
               ) -> Tuple[Optional[MigrationAction], np.ndarray]:
        """argmax_j r̄(r̂(s, a^{(j)})) over the agent's shortlist (Eq. 11)."""
        if not shortlist:
            return None, np.zeros(0)
        choices, scores = self.select_batch([snap], [shortlist])
        return choices[0], scores[0]

    def select_batch(self, snaps: Sequence[EpochSnapshot],
                     options_list: Sequence[Sequence]
                     ) -> Tuple[List[Optional[MigrationAction]],
                                List[np.ndarray]]:
        """Batched Eq. 11 over B replicas' option lists.

        Features stack into one zero-padded ``[B, Cmax, F]`` block and the
        frozen net runs once; padded rows are masked out of the argmax.
        Per-replica results are bit-identical to :meth:`select` (the
        forward is batch-shape invariant and padding never wins)."""
        B = len(snaps)
        counts = [len(opts) for opts in options_list]
        cmax = max(counts) if counts else 0
        if cmax == 0:
            return [None] * B, [np.zeros(0)] * B
        x = np.zeros((B, cmax, FEATURE_DIM), np.float32)
        for b, (snap, opts) in enumerate(zip(snaps, options_list)):
            if opts:
                x[b, :len(opts)] = featurize_batch(snap, opts)
        scores = self.score(forward_np(self.params_np, x))     # [B, Cmax]
        masked = scores.copy()
        for b, c in enumerate(counts):
            masked[b, c:] = -np.inf
        best = np.argmax(masked, axis=1)
        choices = [options_list[b][int(best[b])] if counts[b] else None
                   for b in range(B)]
        return choices, [scores[b, :counts[b]] for b in range(B)]

    # ---- persistence (the JAX package's JSON, byte for byte) ---- #
    def save(self, path: str) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)

        def enc(tree):
            return {k: enc(v) if isinstance(v, dict)
                    else np.asarray(v, np.float32).tolist()
                    for k, v in tree.items()}
        p.write_text(json.dumps({"params": enc(self.params),
                                 "class_weights": self.class_weights}))

    @classmethod
    def load(cls, path: str) -> "Critic":
        d = json.loads(pathlib.Path(path).read_text())

        def dec(tree):
            return {k: dec(v) if isinstance(v, dict)
                    else np.asarray(v, np.float32)
                    for k, v in tree.items()}
        return cls(params=dec(d["params"]),
                   class_weights=tuple(d["class_weights"]))


@functools.lru_cache(maxsize=16)
def _load_critic_cached(path: str, mtime_ns: int, size: int) -> "Critic":
    return Critic.load(path)


def load_critic_cached(path: str,
                       expect_fingerprint: Optional[str] = None) -> "Critic":
    """Load a critic artifact, sharing one frozen instance per file state.

    The critic is read-only at deployment, so the replicas of a batched
    run can share one object — one parse, one ``params_np`` cache, one
    fingerprint — instead of B loads.  Keyed on (path, mtime, size): a
    retrained artifact reloads.

    ``expect_fingerprint`` (from an artifact manifest — see
    :mod:`repro_torch.exp.artifacts`) is verified against the loaded
    parameters' content hash; a mismatch raises instead of letting a
    stale/swapped artifact silently gate a run.
    """
    st = os.stat(path)
    critic = _load_critic_cached(os.path.abspath(path), st.st_mtime_ns,
                                 st.st_size)
    if expect_fingerprint is not None:
        from repro_torch.exp.artifacts import verify_fingerprint
        verify_fingerprint(path, critic.fingerprint(), expect_fingerprint)
    return critic


def stack_samples(samples: Sequence[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(φ, r, mask) tuples → float32 ``[n, F]``, ``[n, 3]``, ``[n, 3]``."""
    return tuple(np.stack([np.asarray(s[i], np.float32) for s in samples])
                 for i in range(3))


def train_critic(samples: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                 *, hidden: int = 64, epochs: int = 2000, batch: int = 256,
                 lr: float = 1e-3, seed: int = 0, arch: str = "factored",
                 loss_class_weights: Tuple[float, float, float] = (3., 1., 1.),
                 class_weights=DEFAULT_CLASS_WEIGHTS,
                 device=None) -> Critic:
    """Offline supervised regression (Eq. 10) on ``device``.

    samples: list of (features [F], label r [3], mask [3]) — mask zeroes the
    classes that had no requests in the interval.  ``loss_class_weights``
    emphasizes the binding class (large-AI) whose forecast drives selection.
    Minibatches follow ``np.random.default_rng(seed).permutation(n)`` each
    epoch.  ``device=None`` trains on CUDA and raises ``RuntimeError``
    where there is none; pass ``device="cpu"`` to train on the host.
    """
    dev = resolve_device("cuda" if device is None else device)
    net = CriticNet.from_params(init_params(seed, hidden, arch=arch),
                                device=dev)
    opt = adam_init(net)
    xs, rs, ms = stack_samples(samples)
    x = torch.from_numpy(xs).to(dev)
    r = torch.from_numpy(rs).to(dev)
    m = torch.from_numpy(ms).to(dev) \
        * torch.tensor(loss_class_weights, dtype=torch.float32, device=dev)
    n = x.shape[0]
    np_rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = torch.from_numpy(np_rng.permutation(n)).to(dev)
        for i in range(0, n, batch):
            idx = order[i:i + batch]
            train_step(net, opt, x[idx], r[idx], m[idx], lr=lr)
    return Critic(params=net.params(), class_weights=class_weights)


def epoch_records_to_samples(records, horizon: Optional[int] = None
                             ) -> List[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
    """Convert simulator EpochRecords into (φ, r, mask) training tuples.

    ``horizon`` aggregates the class-resolved fulfillment label over the
    next ``horizon`` placement intervals (count-weighted); ``None`` labels
    with the rest-of-run return.  With Δ = 5 s and R_s ≈ 8 s a large-AI
    migration's outage spills past one interval, and in the no-admission-
    drop regime the *benefit* (queue stability) accrues over minutes — a
    single-interval label cannot capture the paper's "net outcome of each
    candidate migration" (§III-B), so the default is the Monte-Carlo
    return.
    """
    recs = [r for r in records if r.fulfill is not None
            and r.counts is not None]
    out = []
    for i, rec in enumerate(recs):
        window = recs[i:] if horizon is None else recs[i:i + horizon]
        ok = np.zeros(3)
        tot = np.zeros(3)
        for w in window:
            c = np.asarray(w.counts, np.float64)
            ok += np.asarray(w.fulfill, np.float64) * c
            tot += c
        r = np.where(tot > 0, ok / np.maximum(tot, 1.0), 1.0).astype(np.float32)
        mask = (tot > 0).astype(np.float32)
        x = featurize(rec.snapshot, rec.action)
        out.append((x, r, mask))
    return out
