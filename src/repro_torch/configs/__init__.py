"""Architecture configs and the paper's HMM workloads, as in
`repro.configs`.

`ARCH_IDS` lists the JAX package's assignment ids, every one of which the
port has; `get_arch` returns an id's config module (CONFIG, SMOKE, SKIPS,
input_specs).  `paper_hmm` is the port's own copy of the JAX package's HMM
workloads.
"""

import importlib

ARCH_IDS = [
    "recurrentgemma_2b",
    "deepseek_v2_236b",
    "moonshot_v1_16b_a3b",
    "tinyllama_1_1b",
    "h2o_danube_3_4b",
    "granite_8b",
    "gemma_2b",
    "xlstm_350m",
    "hubert_xlarge",
    "llava_next_34b",
]

#: the ids the port has: all of them
PORTED_IDS = list(ARCH_IDS)


def get_arch(arch_id: str):
    """Return the config module for an assignment id (dashes tolerated)."""
    mod = arch_id.replace("-", "_").replace(".", "_")
    if mod not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


__all__ = ["ARCH_IDS", "PORTED_IDS", "get_arch"]
