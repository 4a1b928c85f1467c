"""Architecture configs and the paper's HMM workloads, as in
`repro.configs`.

`ARCH_IDS` lists the JAX package's assignment ids; `get_arch` returns the
config module (CONFIG, SMOKE, SKIPS, input_specs) of the ids the port has,
and raises for the others, naming the ROADMAP item that ports them.  `paper_hmm` is the
port's own copy of the JAX package's HMM workloads.
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

#: the ids the port has: the encoder that feeds the alignment step and the
#: transformer family's causal LMs (dense GQA / MQA / sliding window, MoE,
#: MLA)
PORTED_IDS = ["hubert_xlarge", "tinyllama_1_1b", "granite_8b", "gemma_2b",
              "h2o_danube_3_4b", "moonshot_v1_16b_a3b", "deepseek_v2_236b"]


def get_arch(arch_id: str):
    """Return the config module for an assignment id (dashes tolerated)."""
    mod = arch_id.replace("-", "_").replace(".", "_")
    if mod not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if mod not in PORTED_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: Griffin, xLSTM and llava "
            f"wait for ROADMAP Queue 1 item 11b; ported: {PORTED_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


__all__ = ["ARCH_IDS", "PORTED_IDS", "get_arch"]
