"""The paper's own HMM workloads (Sec. VII-A parameter settings).

Defaults: |O|=50, edge probability p=0.253, K=512, T=512; forced-alignment
dataset analogue: left-to-right HMM with K=3965, T=256 (TIMIT via HTK in the
paper; synthesised here with the same structure/scale).

The port's own copy of `repro.configs.paper_hmm`, which imports nothing of
JAX: the port imports nothing of the JAX package."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class HMMWorkload:
    name: str
    num_states: int
    seq_len: int
    num_obs: int = 50
    edge_prob: float = 0.253
    kind: str = "erdos_renyi"      # or "left_to_right"


DEFAULT = HMMWorkload("default", num_states=512, seq_len=512)
FORCED_ALIGNMENT = HMMWorkload("forced-alignment", num_states=3965,
                               seq_len=256, num_obs=256, kind="left_to_right")
SWEEP_K = [32, 64, 128, 256, 512, 1024, 2048]
SWEEP_T = [32, 64, 128, 256, 512, 1024, 2048]
SWEEP_P_EDGE = [0.05, 0.075, 0.113, 0.169, 0.253, 0.38, 0.57, 0.85, 1.0]
SWEEP_B = [32, 64, 128, 256, 512, 1024]
