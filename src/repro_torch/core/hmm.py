"""HMM substrate: log-domain model container, synthetic generators, scoring helpers.

The PyTorch counterpart of `repro.core.hmm`, with the same representation:

  * ``log_pi``   -- (K,)   initial state log-probabilities
  * ``log_A``    -- (K, K) transition log-probabilities, ``log_A[i, j] = log P(j | i)``
  * ``log_B``    -- (K, M) emission log-probabilities for discrete observations
  * emissions    -- (T, K) per-timestep state log-likelihoods

Missing transitions are ``NEG_INF`` (a large finite negative), never ``-inf``,
so float32 max-plus arithmetic cannot produce NaNs.

The generators draw with numpy (``torch.distributions.Dirichlet`` takes no
generator) from an explicit ``numpy.random.Generator`` or ``torch.Generator``
and then place the tensors on ``device``.  The same seed therefore gives the
same model on every device; it does not give the model `jax.random` gives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device

# Large finite "minus infinity" (see repro.core.hmm for the overflow margin).
NEG_INF = -1.0e9

Rng = np.random.Generator | torch.Generator


def _numpy_rng(rng: Rng) -> np.random.Generator:
    """A numpy generator drawn from `rng` (a torch generator seeds one)."""
    if isinstance(rng, np.random.Generator):
        return rng
    if isinstance(rng, torch.Generator):
        # flashlint: disable=FL002(model construction: one seed drawn from a torch generator for the host numpy generator)
        seed = torch.randint(0, 2**62, (1,), generator=rng).item()
        return np.random.default_rng(int(seed))
    raise TypeError(f"expected a numpy.random.Generator or torch.Generator, "
                    f"got {type(rng).__name__}")


def _f32(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device)


@dataclasses.dataclass
class HMM:
    """Log-domain HMM parameter triplet (pi, A, B) as float32 tensors."""

    log_pi: torch.Tensor  # (K,)
    log_A: torch.Tensor   # (K, K)
    log_B: torch.Tensor   # (K, M)

    @classmethod
    def from_numpy(cls, log_pi, log_A, log_B, *, device=None) -> "HMM":
        """Carry parameters across as numpy arrays (e.g. from the JAX package)."""
        dev = resolve_device(device)
        return cls(_f32(log_pi, dev), _f32(log_A, dev), _f32(log_B, dev))

    @property
    def num_states(self) -> int:
        return self.log_A.shape[0]

    @property
    def num_obs(self) -> int:
        return self.log_B.shape[1]

    def emissions(self, obs: torch.Tensor) -> torch.Tensor:
        """Dense per-timestep emission scores, shape (T, K), for int obs (T,)."""
        return self.log_B[:, obs.to(self.log_B.device)].T.contiguous()


# ---------------------------------------------------------------------------
# Synthetic model generators (paper Sec. VII-A)
# ---------------------------------------------------------------------------

def erdos_renyi_hmm(rng: Rng, num_states: int, num_obs: int = 50,
                    edge_prob: float = 0.253, ensure_connected: bool = True,
                    *, device=None) -> HMM:
    """Random HMM whose transition graph is G(K, p), as in the paper.

    Present edges get uniform random weights renormalised over each state's
    out-edges; absent edges get ``NEG_INF``.  ``ensure_connected`` adds the
    ring i -> i+1 mod K so every decoding problem stays feasible.
    """
    dev = resolve_device(device)
    g = _numpy_rng(rng)
    K = num_states
    mask = g.random((K, K)) < edge_prob
    if ensure_connected:
        mask[np.arange(K), (np.arange(K) + 1) % K] = True
    raw = g.uniform(0.05, 1.0, (K, K))
    weights = np.where(mask, raw, 0.0)
    probs = weights / weights.sum(axis=1, keepdims=True)
    # flashlint: disable=FL007(model generator defining log_A itself; this IS the dense input constraints mask against)
    log_A = np.where(mask, np.log(np.maximum(probs, 1e-30)), NEG_INF)
    pi = g.dirichlet(np.full(K, 0.8))
    emit = g.dirichlet(np.full(num_obs, 0.5), size=K)
    return HMM(_f32(np.log(np.maximum(pi, 1e-30)), dev), _f32(log_A, dev),
               _f32(np.log(np.maximum(emit, 1e-30)), dev))


def left_to_right_hmm(rng: Rng, num_states: int, num_obs: int,
                      self_loop: float = 0.6, max_skip: int = 2,
                      *, device=None) -> HMM:
    """Bakis (left-to-right) HMM used by forced alignment (paper Sec. VII-A)."""
    dev = resolve_device(device)
    g = _numpy_rng(rng)
    idx = np.arange(num_states)
    delta = idx[None, :] - idx[:, None]  # j - i
    allowed = (delta >= 0) & (delta <= max_skip)
    base = np.where(delta == 0, self_loop, (1.0 - self_loop) / max_skip)
    noise = g.uniform(0.8, 1.2, (num_states, num_states))
    weights = np.where(allowed, base * noise, 0.0)
    probs = weights / np.maximum(weights.sum(axis=1, keepdims=True), 1e-30)
    # flashlint: disable=FL007(model generator defining the left-to-right log_A, not a decode-time mask)
    log_A = np.where(allowed, np.log(np.maximum(probs, 1e-30)), NEG_INF)
    log_pi = np.full(num_states, NEG_INF)
    log_pi[0] = 0.0
    emit = g.dirichlet(np.full(num_obs, 0.5), size=num_states)
    return HMM(_f32(log_pi, dev), _f32(log_A, dev),
               _f32(np.log(np.maximum(emit, 1e-30)), dev))


def _categorical(g: np.random.Generator, logits: np.ndarray) -> int:
    p = np.exp(logits - logits.max())
    return int(g.choice(len(p), p=p / p.sum()))


def sample_observations(rng: Rng, hmm: HMM, length: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sampling of (hidden states, observations), int64 on hmm's device."""
    g = _numpy_rng(rng)
    # flashlint: disable=FL002(ancestral sampling runs on the host: the model is read back once a call)
    log_pi, log_A, log_B = (x.double().cpu().numpy()
                            for x in (hmm.log_pi, hmm.log_A, hmm.log_B))
    states = np.zeros(length, np.int64)
    obs = np.zeros(length, np.int64)
    s = _categorical(g, log_pi)
    for t in range(length):
        states[t] = s
        obs[t] = _categorical(g, log_B[s])
        s = _categorical(g, log_A[s])
    dev = hmm.log_A.device
    return torch.from_numpy(states).to(dev), torch.from_numpy(obs).to(dev)


# ---------------------------------------------------------------------------
# Scoring helpers
# ---------------------------------------------------------------------------

def path_score(log_pi: torch.Tensor, log_A: torch.Tensor,
               emissions: torch.Tensor, path: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of a concrete state path under (pi, A, emissions)."""
    path = path.long()
    first = log_pi[path[0]] + emissions[0, path[0]]
    trans = log_A[path[:-1], path[1:]]
    emit = emissions[1:].gather(1, path[1:, None])[:, 0]
    return first + trans.sum() + emit.sum()


def relative_error(opt_ll, ll):
    """Paper Sec. VII-D metric: eta = |l_opt - l| / |l_opt|."""
    return abs(opt_ll - ll) / abs(opt_ll)


def random_emissions(rng: Rng, length: int, num_states: int,
                     scale: float = 2.0, *, device=None) -> torch.Tensor:
    """Well-separated random emissions (ties have measure ~0) for tests/benches."""
    dev = resolve_device(device)
    g = _numpy_rng(rng)
    return _f32(scale * g.standard_normal((length, num_states)), dev)


__all__ = [
    "HMM",
    "NEG_INF",
    "erdos_renyi_hmm",
    "left_to_right_hmm",
    "sample_observations",
    "path_score",
    "relative_error",
    "random_emissions",
]
