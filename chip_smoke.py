"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the checkout's `src/repro_torch`; imports
nothing of JAX or of the JAX package.  Phases, each fatal on failure:

  0. build every kernel from `src/repro_torch/kernels/csrc` with nvcc for
     sm_90a (one nvcc per source, all started together) and print ptxas's
     register / spill report;
  1. hold the forward and backtrack kernels against their plain PyTorch
     versions on the card, bitwise (`torch.equal`) at the serve shapes
     (B, T, K) = (8, 511, 512) on a left-to-right HMM with ragged lengths
     including 1 and 0 and on an Erdos-Renyi HMM (p = 0.253), at K in
     {1, 3 (CTAs that own no column), 100, 200, 384, the largest K of the
     resident instance and the next multiple of 8 above it, 1024, 1500},
     and at B = 40 (more sequences than clusters on the card) with
     lengths 0, 1 and 511 among them; each case prints the instance and
     cluster size it took; the backtrack also on psi of uniformly random
     states (a near-diagonal psi hides a wrong composition of its maps)
     with tie-heavy integer delta_T at (B, T, K) = (8, 511, 512), (40,
     511, 512), (1, 4095, 64), T in {0, 1, 2, 9}, K in {1, 3, 1500},
     (2, 511, 1500) and (1, 4095, 512) (psi rows read from L2), (2, 5,
     29056) (the widest K: one sub-block, rows from L2), (1, 511, 193) and
     a psi 4 bytes past an allocation's start; each backtrack case prints
     its instance (psi rows staged or read from L2, sub-blocks a CTA);
  1b. hold the constraint-masked forward kernel and the banded kernel
     against their plain versions, bitwise: (8, 511, 512) and (40, 511,
     512) with the serve lexicon's tmask and smask, (8, 511, 1024) on the
     map-matching grid with the band's smask, K in {1, 3, 100, 384, the
     instance boundary, 1500} with each mask alone and both, and the banded
     kernel at the map-matching shape, on bands clipped at both ends of the
     state range at widths 96, 0 (Kb = 1), 2, 4 and 8 (Kb = 5, 9 and 17:
     CTAs without columns) and Kb = K, at K = 301, at Kb = 255 and 257, for
     a single step, and at the widest window the kernel takes (Kb = K =
     29055); Kb = 1, 5, 9, 17 and 29055 end each step with a cluster
     barrier, the others exchange through mbarriers;
  1c. hold the beam kernel and the tropical kernel against their plain
     versions, bitwise: `ops.beam_step` at the four shapes of
     tests/test_kernels.py (the op's path to the single-step entry, its
     launches counted), `beam_step_batch` at the serve's (N, K, B, chunk) =
     (8, 512, 128, 128) and (2048, 512, 128, 128), at chunk = K = B = 512,
     and over 16 chained left-to-right steps from a one-hot beam;
     `ops.tropical_matmul` at the five shapes of tests/test_kernels.py in
     float32 and bfloat16 (values and argmax), the batched kernel with the
     argmax and values-only, in both dtypes, on normal and tie-heavy integer
     inputs, at (N, I, K, J) = (256, 64, 64, 64) and (2047, 64, 64, 64) (assoc
     scan levels), at ragged tile edges (3, 65, 33, 70) and (1, 130, 100,
     131), and on operands whose base is not 16-byte aligned; then the two
     FLASH-BS pass entries: the serve's initial
     pass (8 sequences, Tp = 512, K = 512, B = 128, P = 8, tie-heavy
     left-to-right model, ragged pad tails, one boundary crossed on a pad
     step), its first layer, a lanes group of its second and its last
     layer (2048 tiles of 2 steps), the budget rung (B = 256, P = 1), a
     full beam on the Erdos-Renyi model, K = 1024 (the global instance),
     and K = 100 and K = 3 (a cluster's CTAs own 13 / 1 columns);
  1d. hold the beam kernel's chunk mode (`bs_chunk_batch`, the streaming
     beam decoder's one launch a feed) against `ref.beam_chunk_ref`,
     bitwise: (N, C, K, B) = (1 | 8, 64, 512, 128) seeding and carried on
     the serve model and on random carried beams, a seeding feed of one row,
     B = K = 512, 16 beams with mixed flags, K = 200 padded to 256 with
     kchunk 128 as the decoder pads it (B = 16, 128, 200), K = 3, K = 1024
     (the global instance), the lexicon-constrained serve model and three
     chained feeds; and the forward kernel at the streaming chunk shapes
     (1, 63 | 64, 512) and the inflight slot shape (64, 16, 512) with nfeed
     drawn from 0..16, all 0 and all 16, and after a `fresh` re-seed;
  2. serve the 32 requests at K = 512 with ``--method fused`` through
     `repro_torch.launch.serve.main`, with the launch counters set to 0 just
     before and read just after: the forward and backtrack kernels must have
     launched once per batch and the other kernels never, and every served
     path and score must equal the exact `viterbi_vanilla` decode (relative
     error exactly 0) and, on a sample, the numpy oracle `viterbi_numpy`;
  4. serve the same 32 requests through the lexicon-constrained alignment
     head (`make_lexicon_align_head`, 128 four-state words): the masked
     kernel and the backtrack once per batch, the unmasked forward never;
     every path and score bitwise equal to `viterbi_vanilla` over
     `constrain_inputs`, 3 sampled also to `viterbi_numpy`;
  5. map matching on a 32 x 32 road grid (K = 1024, T = 512): a ragged batch
     of 8 sensors through `ViterbiDecoder(FusedSpec(constraint=band))`
     (one masked-kernel launch) and one trajectory through
     `FusedSpec(constraint=band).run` (one banded-kernel launch), each
     bitwise equal to the dense oracle;
  6. serve the default 32 requests (FLASH-BS, beam 128, P = 8) through
     `serve.main`: per batch one initial-pass launch and one tile launch
     per layer, as `plan_padding` predicts (5 + 25), every other kernel
     never; 8
     sampled requests (one per bucket at least) bitwise equal to
     `flash_bs_viterbi` on the CPU; the relative error against
     `viterbi_vanilla` printed;
  7. the same 32 requests through the default (FLASH-BS) lexicon head: the
     beam launches counted, 3 sampled requests bitwise equal to the same
     spec run on the CPU;
  8. the paper's default workload (Erdos-Renyi, K = 512, p = 0.253) at
     (B, T) = (8, 511): `flash` (P = 8), `flash_bs` (beam K), `checkpoint`,
     `beam_static` (B = K) and `beam_static_mp` (beam K), each path bitwise
     equal to `viterbi_vanilla` with relative error 0; `assoc` at (T, K) =
     (4096, 64) on the tropical kernel (one values-only launch per combine
     of the scan: 22; one argmax launch for its backtrack's table) and the
     backtrack kernel (one launch), those launches exactly, its path equal
     and its score within 1e-5 relative (the scan groups
     the adds as a tree; the rtol of tests/test_core_viterbi.py), and
     bitwise equal to the same decode on the CPU; `serve.main` with
     ``--budget-kb`` 1024 (an exact FLASH rung) and 32 (a beam rung);
  9. streaming at the serve deployment: the 32 serve requests, each fed in
     ragged pieces, through a `StreamMux` (blocks 32, 128, 512) with
     `StreamConfig("online")` (every path and score == `viterbi_vanilla`),
     `"online_beam"` (beam 128) and `max_lag=64` (8 sampled sessions ==
     the same decode on the CPU); launches exactly one forward (or chunk)
     launch per block feed, no `beam_step_batch`;
  10. inflight serving: the 32 requests into `InflightScheduler(max_slots=
     64, block=16)`, three joining a step, exact and `max_lag=16` sessions
     mixed: every step one forward launch at (64, 16, 512), every path ==
     the `OnlineSpec(stream_chunk=16, max_lag=L).run` oracle (exact ones
     also == `viterbi_vanilla`); then 8 online sessions routed by
     `StreamMux(..., inflight=)` into a pool;
  11. sharded decoding, the load test and the fault drills: the tropical
     kernel (with the argmax) against its plain version, bitwise, at the
     tensor-parallel steps' shapes, row (1, M, 256) x (1, 256, 512) and
     column (1, M, 512) x (1, 512, 256), M from 1 to 256; then, in one
     world of 4 ranks spawned by `launch.mesh.run_spmd` that share the
     card over gloo: (a) `make_flash_viterbi_2d` on mesh (data 2, model
     2), row and column layouts, at the paper's (T, K) = (511, 512) on its
     Erdos-Renyi model (p = 0.253; path and score bitwise
     `viterbi_vanilla`'s), on the serve's left-to-right model and on an
     equal-weight left-to-right model with emissions in {0, 1} whose
     paths tie across the model shards (score bitwise vanilla's, path ==
     the same decode on CPU tensors; on the tie-heavy one the layouts'
     paths must differ), each decode exactly one tropical launch a DP step
     a rank, its host-clock time printed; (b) the 32 serve requests bucket by bucket through
     `ViterbiDecoder.decode_sharded` over data = 4 for `fused`, FLASH-BS
     (beam 128, P = 8) and the lexicon-constrained `fused` (JAX's route:
     `constrain_inputs`, then the plain forward kernel), every bucket
     bitwise the unsharded decode, launches a rank exact; (c) the sharded
     alignment head on a bucket of 5; launches summed over the ranks.  In
     this process: (d) the load test (`launch/loadtest.py`) at K = 512,
     p = 0.253, lengths 128 / 256 / 511, 32 requests, a quarter streamed,
     for `fused`, `flash_bs`, `--budget-kb` 32 and 1024 and the
     inflight-versus-bucketed compare, each delivering every request once
     with the oracle green, throughput, latency percentiles and commit lag
     printed, each run's launches held to exactly its offline batches'
     (forward and backtrack a `fused` batch, FLASH-BS's beam passes,
     none for exact FLASH) plus one forward launch a stream block feed,
     with the oracle run outside that count, and the inflight side one
     slot-step launch a step and no other kernel; (e) the drills at
     K = 512 with 16 requests: worker death (kill batch 1 and 0), the
     budget shrink from 1024 to 32 KB (exact FLASH, P = 16, to FLASH-BS,
     P = 1, beam 256), in a world of 4 ranks the mesh shrink 4 -> 2, and
     the budget shrink at its default 64 -> 2 KB, which must be flagged
     by the oracle with `reported_score_vs_path` alone (the narrow beam's
     open fault, ROADMAP Queue 3);
  12. the end-to-end forced-alignment step (`make_e2e_align_step`): (a)
     hubert-xlarge's full width (d 1280, 16 x 80 heads, d_ff 5120, vocab
     512) at 2 layers in float32, the same weights on the card and on the
     CPU, emissions within `E2E_PARITY_TOL`; (b) the whole CONFIG, 48
     layers in bf16 drawn on the card from a seeded `torch.Generator`, on
     (B, S) = (8, 256) frames (`FORCED_ALIGNMENT.seq_len`) and a
     left-to-right HMM of K = 504 states, one a class, through the default
     FLASH-BS step and the `fused` step: paths in range and monotone, the
     decode bitwise the same decode of the same emissions on the CPU
     (FLASH-BS's plain version; `viterbi_vanilla` for `fused`), launches
     exactly one initial pass and 5 tile launches (Tp = 256 = 8 x 2^5), or
     one forward and one backtrack; the bf16 emissions against the same
     weights in float32 on the card within `E2E_BF16_TOL`, and what
     allowing cuBLAS's reduced-precision bf16 reductions changes; (c) the
     encoder (emissions), decode and whole-step times (CUDA events, median
     of 7), frames/s, peak memory, the encoder's bound, and the device's
     idle share of a step under `torch.profiler`;
  13. the five Viterbi examples (`examples/torch_*.py`) at their defaults
     on the card through their `main`, launches counted, every path (and
     score) bitwise the same example's decode on the CPU; then the analysis
     gate's card checks (`repro_torch.analysis`): the Python mirror of the
     kernels' shared-memory layouts equal to the C entries at every K from
     1 to 29 056, the memory contracts at the gate's grid and (K, T) =
     (512, 511) (allocated bytes against the planner's model, departures
     failing unless their owning module waives them), the launch guard on
     one decode per spec, and the deep flashprove run on the card (PV102
     sees copies from the card to the host; the ptxas log of this build;
     the gloo world of 2 for the collective check), any unwaived finding
     fatal, its JSON report written to ``build/analysis/report.json``; the
     line ``{"resources": [...]}`` (each kernel entry's registers, spill
     bytes and shared bytes at K = 512) comes before the kernels line;
  3. time each kernel and its plain version with CUDA events: the forward
     and backtrack kernels at the serve shapes (B = 8, T in {128, 256,
     512}, K = 512; the backtrack by CUDA-graph replay, on the forward's
     psi, warm in L2, and also at (40, 511, 512), (1, 511, 193) and (1,
     4095, 64) on random-state psi), the masked kernel at (8, 511, 512)
     with both masks and at (8, 511, 1024) with smask alone (the forward
     entries also per DP step, with their instance), the banded kernel on
     the map-matching grid at Kb = 193 (mbarrier exchange) and 17 (a
     cluster barrier a step), per launch and per DP step, the beam
     kernel's single step at (N, K, B, chunk) = (8, 512, 128, 128) and
     (2048, 512, 128, 128), its initial pass at the serve's (8, 512, 512,
     128, P = 8) and its tile launches of the first and last layers (ms
     per launch and per DP step), the tropical kernel with the argmax and
     values-only at (N, I, K, J) = (N, 64, 64, 64), N in {1, 255, 256,
     2047}, and (1, 512, 512, 512), by CUDA events and by the device time
     of a `torch.profiler` trace (the events time the host where it
     launches slower than the card runs), the device time of the 22
     values-only launches of one `assoc` decode at (T, K) = (4096, 64) and
     of its backtrack table's argmax launch (replayed), its tropical and
     backtrack launches under the profiler, and that decode on the host
     clock; the FLASH-BS and the `fused` serve's drains of the 32 requests
     on the host clock, twice each, with their launches; and one more
     drain of each under `torch.profiler`: the device time and the
     device's idle share of the drain; the chunk mode at (1 | 8, 64, 512,
     128) seeding and carried, and the slot step at (64, 16, 512), per
     launch and per step (events and graph replay); the three streaming
     drains and the inflight drain (with its commit-lag percentiles) on the
     host clock, twice each, and once each under the profiler;
  14. causal-LM serving of the transformer family (`models/`, `configs/`;
     no Viterbi kernel may launch): (a) each of tinyllama-1.1b, granite-8b,
     gemma-2b, h2o-danube-3-4b (2 layers), moonshot-v1-16b-a3b and
     deepseek-v2-236b (1 layer) at full width in float32, the same weights
     on the card and on the CPU, a prefill of (2, 64) prompts (max_len 128)
     and 4 greedy decode steps on both: logits within `LM_F32_TOL` of the
     CPU's, greedy tokens equal, and the first step against a prefill over
     65 tokens within `LM_F32_TF_TOL`; (b) granite-8b whole, 36 layers in
     bf16 from a seed, 8 prompts of 511 tokens, max_len 1024, 64 greedy
     steps; (c) tinyllama, gemma and danube whole, moonshot at 16 of 48
     layers and deepseek-v2 at 2 of 60, bf16, 4 prompts of 511 tokens and
     16 greedy steps; for each of (b) and (c) every logit finite, the first
     step's logits against the last-position logits of a prefill over all
     512 tokens within `LM_BF16_TOL` (MoE on a capacity that drops no
     assignment), the prefill (CUDA events, median of 7) and decode-step
     times, tokens/s, peak memory and cache bytes beside their bounds, then
     one decode step and one prefill under `torch.profiler` (device busy
     and idle share);
     (d) danube's 4096-slot window ring at full width, 2 layers, float32:
     a prefill of 4096 tokens and 1024 single-token steps (the ring wraps
     once) against a prefill of all 5120 (rolled by 1024), then 16 greedy
     steps from each cache, within `LM_RING_TOL`, tokens equal.
  15. the recurrent families and llava's image tokens (`models/hybrid.py`,
     `rglru.py`, `xlstm.py`; no Viterbi kernel may launch): (a)
     recurrentgemma-2b (5 layers: one (rec, rec, attn) unit and the two
     tail rec layers), xlstm-350m (2 layers) and llava-next-34b (2 layers,
     32 image rows before the prompt) at full width in float32, card
     against CPU as 14a, within `REC_F32_TOL` / `REC_F32_TF_TOL`; (b)
     recurrentgemma-2b whole (26 layers, bf16), 8 prompts of 511 tokens,
     max_len 1024, 64 greedy steps, a decode step after the 511 against a
     prefill of 512; (c) xlstm-350m whole (24 layers), 8 prompts of 512
     tokens (a multiple of its 256-row mLSTM chunk), 64 greedy steps, a
     prefill of 256 and 256 single-token steps against a prefill of 512
     and 255 + 1 against 256 (for xLSTM, 15a's check too, the logits'
     gap is printed and unit 0's mLSTM state and conv tail are held:
     `mlstm_state_gap`); (d) llava-next-34b at full width cut to
     `LM_DEPTH` layers, 2 sequences of 2880 image embeddings and 192
     tokens (3072 positions, a multiple of the attention's kv block),
     max_len 4096, 16 greedy steps, 1024 single-token steps against a
     prefill of all 4096 positions (`REC_TF`); for each of (b)-(d) the
     init's peak memory beside its model from the
     layout, the checks within `REC_BF16_TOL`, the prefill (CUDA events,
     median of 3, `REC_PREFILL_RUNS`) and decode-step times, tokens/s,
     peak memory and cache bytes beside their bounds, then one decode
     step and one prefill under `torch.profiler` (device busy and idle
     share, kernel launches).
  16. training (`train/`, `optim/`, `data/`, the models' `loss`; no
     Viterbi kernel may launch): (a) every config's SMOKE in float32,
     weights drawn on the card from a seed and copied to the CPU, one
     `make_train_step` step at accum_steps 2 on a (4, 16) numpy batch on
     both: loss, grad_norm, the first moment (the clipped gradient) and
     every updated weight within `TRAIN_F32_TOL` of the CPU's, and
     tinyllama's once more with ``compress_accum`` (its moment holds the
     dequantized gradients); (b) tinyllama-1.1b at full width cut to 2
     layers, float32, (B, S) = (2, 512), its layer matrices rescaled to
     std 1/sqrt(d_in) (JAX's init draws the 2-layer stack at std
     1/sqrt(2), which saturates the attention's softmax), held as (a); (c) tinyllama-1.1b
     whole (22 layers, bf16) at train_4k's S = 4096, microbatches of 2 at
     accum_steps 2 from `SyntheticTokenPipeline`: a warm-up step, 3 steps
     and 2 with ``compress_accum`` timed by CUDA events, beside the bound
     (bf16 products at 989 TFLOP/s plus float32 attention at 67, x 3), the
     useful FLOPs (`launch.model_flops`) and their share of 989 TFLOP/s,
     peak memory, the optimizer's and the error-feedback buffers' bytes,
     then one step under `torch.profiler` (device busy and idle share,
     kernel launches); (d) `launch.train.main` on the card with
     tests/test_system.py's tinyllama SMOKE arguments (the loss falls by
     more than 0.3), and its full / part / resume trio (the resumed losses
     within rtol 2e-4, atol 2e-5 of the uninterrupted run's).
  17. sharded training (`make_train_step(..., mesh=)`, `sharding.placement`;
     no Viterbi kernel may launch): (a) a world of 8 ranks sharing the card
     (gloo) on the (data 4, model 2) mesh under SINGLE_POD_RULES and the
     (pod 2, data 2, model 2) mesh under MULTI_POD_RULES: every config's
     SMOKE in float32 and tinyllama's with ``compress_accum``, one sharded
     step at accum_steps 2 on a (8, 16) batch with a random 0.8 mask (per-
     rank mask counts differ), each rank's rows from `shard_rows`, the
     state placed by `shard_train_state` and gathered back, against the
     single-process step on the card from the same weights and batch: the
     four gaps of 16a within `SHARD_TRAIN_TOL` (every family, the
     transformer family with MoE and MLA, Griffin and xLSTM, runs Megatron
     compute over "model", `sharding.tensor_parallel`); (b)
     tinyllama-1.1b whole (22 layers, bf16, tensor-parallel) on (data 2,
     model 2), 4 ranks sharing the card, at
     S = 2048, a global batch of 4 (one row a data rank a microbatch) at
     accum_steps 2 (train_4k cut to the card, `SHARD_MAIN`; the plan of a
     rank's peak printed and checked against the free memory first, and
     the plan at train_4k's S = 4096): a warm-up step and a timed step
     on the host clock, the share of each in collectives (host clock
     around them, after a synchronise), the sums over "model", the sums
     over "data" and the gathers over each axis apart (calls, ms, bytes;
     no gather over "model" but 17e's), the first step's loss and grad_norm against a float32
     single-process step on the same global batch and weights, within
     1.5x the bf16 single-process step's own gaps from it (at least
     2.4e-7; the gaps to the bf16 single-process step printed too), each
     rank's bytes at rest against the specs' share (`SHARD_REST_SLACK`
     above it fails) and each rank's peak; (c) the same for
     moonshot-v1-16b-a3b at full width (64 experts top-6, vocab 163 840,
     bf16), tensor- and expert-parallel (32 experts a rank) at
     `SHARD_MOE_LAYERS` of its 48 layers, its block matrices rescaled to
     std 1/sqrt(d_in): a warm-up step and a timed one, the plan printed at
     one layer more too; (d) the same for recurrentgemma-2b at full width
     (d 2560, d_rnn 2560, 10 heads with MQA, d_ff 7680, vocab 256 000,
     bf16), tensor-parallel (the RG-LRU on 1280 columns a rank) at
     `SHARD_GRIFFIN_UNITS` of its 8 (rec, rec, attn) units and none of its
     2 tail layers, its block matrices rescaled to std 1/sqrt(d_in): a
     warm-up step and 1 timed, the plan printed at one unit more too;
     (e) the same for xlstm-350m at full width (d 1024, 4 heads, mLSTM
     width 2048, sLSTM MLP width 1408, vocab 50 304, bf16),
     tensor-parallel (the mLSTM on 2 heads a rank, the sLSTM's recurrence
     whole on every rank beside its tensor-parallel MLP) at
     `SHARD_XLSTM_UNITS` of its 12 (mLSTM, sLSTM) units and S =
     `SHARD_XLSTM_S`, its block matrices rescaled to std 1/sqrt(d_in): a
     warm-up step and 1 timed, its gathers over "model" (the sLSTM's gate
     weights, the fused w_up products' exchange) counted against their
     8 a unit a microbatch, the plan printed at one unit more too.
  18. the dry run against the card (`repro_torch.launch.dryrun`, no card
     work): a host process of its own, started before the kernels' build
     and collected before phase 2 (no phase beside it reads a clock),
     runs 17b's cell as rank 0 of a fake world of 4 on fake tensors under
     `launch.op_cost`, and 11a's 2-D decode at `TP_MESH`; after 17b it
     holds (a) per (collective, axis) the calls and bytes against rank 0's
     timed 17b step, exactly, (b) rank 0's predicted peak within
     `DRYRUN_PEAK_TOL` of 17b's ``max_memory_allocated``, (c) the
     predicted launches a rank, times the ranks, against 11a's counted
     launches of that decode; it prints the predicted flops beside 17b's
     step time as a share of 989 TFLOP/s.

The line before the last is a JSON object with one entry per kernel (the
`resources` object just before it); the last line is {"ok": true,
"device": {...}}.  Exits non-zero, printing no
result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import multiprocessing
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet) used for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12          # dense, on the tensor cores

SERVE_T = (128, 256, 512)
SERVE_B, SERVE_K = 8, 512

# the serve lexicon: word w is the four-state chain (4w, 4w+1, 4w+2, 4w+3)
LEXICON = tuple(((4 * w, 4 * w + 1, 4 * w + 2, 4 * w + 3),)
                for w in range(SERVE_K // 4))
# map matching: a G x G road grid, T fixes from B sensors, GPS noise SIGMA
# (cell units), band half-width 3 grid rows (Kb = 193)
GRID_G, GRID_T, GRID_B, GRID_SIGMA = 32, 512, 8, 0.45
GRID_WIDTH = 3 * GRID_G
GRID_LENGTHS = (512, 501, 483, 9, 384, 256, 130, 1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of one call of `fn` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of one call of `fn`: `reps` calls captured in a CUDA
    graph, whose replay runs them back to back on the card with no host
    work between them (back-to-back CUDA events time the host where it
    launches a call slower than the card runs it)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5) / reps


def profiled_ms(fn, *names: str) -> list[float | None]:
    """Device time of the kernels whose names hold each of `names` in one
    `torch.profiler` trace of one call of `fn`; None for a name the trace
    holds no event of."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = []
    for name in names:
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name)
        out.append(us / 1e3 if us else None)
    return out


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                        "operations")


def fwd_bound(B: int, T: int, K: int, real_steps: int):
    """The forward kernel's work (`kernels.work.fwd_work`) as a bound."""
    from repro_torch.kernels import work
    return bound_ms(*work.fwd_work(B, T, K, real_steps))


def backtrack_bound(B: int, T: int, K: int):
    """The backtrack's work (`kernels.work.backtrack_work`) as a bound."""
    from repro_torch.kernels import work
    return bound_ms(*work.backtrack_work(B, T, K))


def pad_of(lengths, T: int, dev) -> torch.Tensor:
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    return (torch.arange(T, device=dev)[None, :]
            >= lengths[:, None]).to(torch.float32)


def forward_layout(vdp, K: int) -> str:
    """The forward template's instance at K and its cluster size (the
    `kCluster` its source includes from csrc/cluster.cuh)."""
    from repro_torch.kernels import build
    text = (build.CSRC / "cluster.cuh").read_text()
    ctas = re.search(r"constexpr int kCluster = (\d+);", text).group(1)
    return f"{vdp.forward_instance(K)} log_A, clusters of {ctas} CTAs"


def resident_limit(vdp) -> int:
    """The largest K whose forward launch holds its column slices of log_A
    in shared memory (the C entry's own layout arithmetic)."""
    K = 1
    while vdp.forward_instance(K + 1) == "resident":
        K += 1
    return K


def random_case(g, dev, K: int, B: int, T: int):
    """Normal log_A (K, K), em (B, T, K) (x2) and delta0 (B, K) on `dev`."""
    log_A, em, delta0 = (torch.from_numpy(
        g.standard_normal(shape).astype(np.float32)).to(dev)
        for shape in ((K, K), (B, T, K), (B, K)))
    return log_A, 2.0 * em, delta0


def check_forward(vdp, ref, log_A, em, delta0, pad, what: str):
    """Kernel vs plain version, bitwise; returns (max |delta_T difference|,
    the kernel's psi and delta_T)."""
    what = f"{what}, {forward_layout(vdp, em.shape[2])}"
    psi, dT = vdp.viterbi_forward_batch(log_A, em, delta0, pad)
    if pad is None:
        psi_r, dT_r = ref.viterbi_forward_ref(log_A, em, delta0)
    else:
        psi_r, dT_r = ref.viterbi_forward_masked_ref(log_A, em, delta0,
                                                     pad > 0.5)
    torch.cuda.synchronize()
    if not (torch.equal(psi, psi_r) and torch.equal(dT, dT_r)):
        bad = int((psi != psi_r).sum())
        raise SystemExit(f"FAIL forward {what}: {bad} psi entries differ, "
                         f"max |delta_T diff| "
                         f"{float((dT - dT_r).abs().max())}")
    print(f"forward kernel == plain (bitwise) at {what}")
    return float((dT - dT_r).abs().max()), psi, dT


def backtrack_layout(vdp, T: int, K: int) -> str:
    """The backtrack's instance at (T, K): psi rows staged in shared memory
    or read from L2, and the sub-blocks a CTA cuts its rows into."""
    inst, sub = vdp.backtrack_instance(T, K)
    return f"{inst} psi rows, sub-blocks a CTA: {sub}"


def check_backtrack(vdp, ref, psi, dT, what: str) -> float:
    B, T, K = psi.shape
    what = f"{what}, {backtrack_layout(vdp, T, K)}"
    paths, scores = vdp.viterbi_backtrack_batch(psi, dT)
    paths_r, scores_r = ref.viterbi_backtrack_ref(psi, dT)
    torch.cuda.synchronize()
    if not (torch.equal(paths, paths_r) and torch.equal(scores, scores_r)):
        raise SystemExit(f"FAIL backtrack {what}: "
                         f"{int((paths != paths_r).sum())} path entries or "
                         f"the scores differ")
    print(f"backtrack kernel == plain (bitwise) at {what}")
    return float((scores - scores_r).abs().max())


def random_psi(g, dev, B: int, T: int, K: int, base: int = 0):
    """psi (B, T, K) of uniformly random states in [0, K) (where a wrong
    composition of the backtrack's maps shows; a near-diagonal psi hides
    it), `base` words past an allocation's start, and tie-heavy integer
    delta_T (B, K) in [-2, 2]."""
    flat = torch.from_numpy(g.integers(0, K, base + B * T * K,
                                       dtype=np.int32)).to(dev)
    dT = torch.from_numpy(g.integers(-2, 3, (B, K)).astype(np.float32))
    return flat[base:].view(B, T, K), dT.to(dev)


#: (B, T, K) of the backtrack's random-state cases in phase 1: the serve
#: shape, more sequences than clusters, assoc's table, T = 0, 1, 2 and 9
#: (fewer rows than CTAs or sub-blocks), K = 1, 3 and 1500 (staged), psi
#: rows read from L2 (1500 and 512 at long T, with 16 sub-blocks; the widest
#: K, one sub-block) and map matching's window
BACKTRACK_CASES = ((8, 511, 512), (40, 511, 512), (1, 4095, 64),
                   (3, 0, 512), (3, 1, 512), (3, 2, 512), (3, 9, 512),
                   (3, 37, 1), (3, 37, 3), (3, 37, 1500), (2, 511, 1500),
                   (1, 4095, 512), (2, 5, 29056), (1, 511, 193))


def phase_kernels(dev) -> dict[str, float]:
    from repro_torch.core import erdos_renyi_hmm, left_to_right_hmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import viterbi_dp as vdp

    err = {"viterbi_fwd_batch": 0.0, "viterbi_backtrack_batch": 0.0}
    g = np.random.default_rng(1)
    B, T, K = SERVE_B, 511, SERVE_K
    cases = [
        ("left-to-right", left_to_right_hmm(g, K, 64, device=dev),
         [511, 300, 1, 0, 128, 511, 77, 255]),
        ("erdos-renyi p=0.253", erdos_renyi_hmm(g, K, 50, 0.253, device=dev),
         None),
    ]
    inputs = []
    for name, hmm, steps in cases:
        em_full = torch.from_numpy(
            (2.0 * g.standard_normal((B, T + 1, K))).astype(np.float32)).to(dev)
        delta0 = hmm.log_pi[None, :] + em_full[:, 0, :]
        em = em_full[:, 1:]                 # strided, as the decode passes it
        pad = None if steps is None else pad_of(steps, T, dev)
        inputs.append((f"{name} (B,T,K)=({B},{T},{K}) lengths={steps}",
                       hmm.log_A, em, delta0, pad))
    # K = 1 and 3: CTAs that own no column; the largest resident K and the
    # next multiple of 8 above it: the two instances' boundary
    k_res = resident_limit(vdp)
    for K in (1, 3, 100, 200, 384, k_res, k_res // 8 * 8 + 8, 1024, 1500):
        B, T = 3, 37
        log_A, em, delta0 = random_case(g, dev, K, B, T)
        inputs.append((f"(B,T,K)=({B},{T},{K}) lengths=[{T}, 1, 0]",
                       log_A, em, delta0, pad_of([T, 1, 0], T, dev)))
    # more sequences than clusters on the card: the persistent task loop
    B, T, K = 40, 511, SERVE_K
    hmm = left_to_right_hmm(g, K, 64, device=dev)
    lengths = [0, 1, 511, 0] + g.integers(2, T + 1, B - 4).tolist()
    em_full = torch.from_numpy(
        (2.0 * g.standard_normal((B, T + 1, K))).astype(np.float32)).to(dev)
    inputs.append((f"left-to-right (B,T,K)=({B},{T},{K}) lengths 0, 1, "
                   f"511, 0 and 36 drawn from [2, 511]",
                   hmm.log_A, em_full[:, 1:],
                   hmm.log_pi[None, :] + em_full[:, 0, :],
                   pad_of(lengths, T, dev)))
    for what, log_A, em, delta0, pad in inputs:
        e, psi, dT = check_forward(vdp, ref, log_A, em, delta0, pad, what)
        err["viterbi_fwd_batch"] = max(err["viterbi_fwd_batch"], e)
        e = check_backtrack(vdp, ref, psi, dT, what)
        err["viterbi_backtrack_batch"] = max(err["viterbi_backtrack_batch"], e)
    # the backtrack on random-state psi, and on a base 4 bytes past an
    # allocation's start (its rows' cp.async copies start unaligned)
    cases = [(f"random-state psi (B,T,K)={shape}", shape, 0)
             for shape in BACKTRACK_CASES]
    cases.append(("random-state psi, base + 4 bytes (B,T,K)=(2,64,100)",
                  (2, 64, 100), 1))
    for what, shape, base in cases:
        psi, dT = random_psi(g, dev, *shape, base=base)
        e = check_backtrack(vdp, ref, psi, dT, what)
        err["viterbi_backtrack_batch"] = max(err["viterbi_backtrack_batch"], e)
    del psi, dT
    return err


def masked_bound(B: int, T: int, K: int, has_t: bool, has_s: bool,
                 real_steps: int):
    """The masked forward kernel's work (`kernels.work.masked_work`) as a
    bound."""
    from repro_torch.kernels import work
    return bound_ms(*work.masked_work(B, T, K, has_t, has_s, real_steps))


def banded_bound(K: int, starts: torch.Tensor, Kb: int):
    """The banded kernel's work at this run's windows
    (`kernels.work.banded_work`) as a bound."""
    from repro_torch.kernels import work
    return bound_ms(*work.banded_work(K, starts.numel(), Kb,
                                      starts.tolist()))


def lexicon_problem(dev, g, B: int, T: int):
    """The serve model (left-to-right HMM, K = 512, 64 classes) with the
    serve lexicon's penalties compiled for T + 1 steps, and B sequences of
    emissions: (log_A, tmask, em (B, T, K) strided, smask (T, K), delta0)."""
    from repro_torch.core import (LexiconConstraint, compiled_penalties,
                                  left_to_right_hmm)
    K = SERVE_K
    hmm = left_to_right_hmm(g, K, 64, device=dev)
    t_pen, pi_pen, s_pen = compiled_penalties(LexiconConstraint(LEXICON), K,
                                              T + 1)
    tmask, pi_pen, s_pen = (torch.from_numpy(x).to(dev)
                            for x in (t_pen, pi_pen, s_pen))
    em_full = torch.from_numpy(
        (2.0 * g.standard_normal((B, T + 1, K))).astype(np.float32)).to(dev)
    delta0 = (hmm.log_pi + pi_pen)[None, :] + (em_full[:, 0] + s_pen[0])
    return hmm.log_A, tmask, em_full[:, 1:], s_pen[1:], delta0


def grid_problem(dev, seed: int = 7):
    """Map matching on a GRID_G x GRID_G road grid, as in
    examples/map_matching.py at G = 32: a dense grid HMM whose move cost
    decays with squared cell distance, a random-walk trajectory, GRID_B
    sensors' noisy fixes and their emissions -||obs - cell||^2 / (2 s^2),
    and the band of half-width GRID_WIDTH around the sensors' consensus.

    Returns (log_pi, log_A, em (B, T, K), truth (T,) numpy, band)."""
    from repro_torch.core import BandConstraint
    G, T, B, sigma = GRID_G, GRID_T, GRID_B, GRID_SIGMA
    K = G * G
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(np.stack(
        np.meshgrid(np.arange(G), np.arange(G), indexing="ij"),
        -1).reshape(K, 2).astype(np.float32)).to(dev)
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    log_A = torch.log_softmax(-0.7 * d2, dim=1).contiguous()
    log_pi = torch.log_softmax(torch.zeros(K, device=dev), dim=0)
    steps = rng.integers(-1, 2, size=(T, 2))
    truth_xy = np.clip(np.cumsum(np.vstack([[[G // 2, G // 2]], steps[1:]]),
                                 0), 0, G - 1)
    truth = truth_xy[:, 0] * G + truth_xy[:, 1]
    obs = truth_xy[None] + rng.normal(0, sigma, size=(B, T, 2))
    obs_t = torch.from_numpy(obs.astype(np.float32)).to(dev)
    em = -((obs_t[:, :, None, :] - pos[None, None]) ** 2).sum(-1) / (
        2 * sigma ** 2)
    cxy = np.clip(np.round(obs.mean(0)), 0, G - 1)
    band = BandConstraint(centers=tuple(int(x * G + y) for x, y in cxy),
                          width=GRID_WIDTH)
    return log_pi, log_A, em.contiguous(), truth, band


def check_masked(vdp, ref, log_A, em, delta0, pad, tmask, smask,
                 what: str) -> float:
    """Masked kernel and a backtrack of its psi vs the plain versions,
    bitwise; returns max |delta_T difference|."""
    what = f"{what}, {forward_layout(vdp, em.shape[2])}"
    psi, dT = vdp.viterbi_forward_batch_masked(log_A, em, delta0, pad,
                                               tmask, smask)
    mask = (torch.zeros(em.shape[:2], dtype=torch.bool, device=em.device)
            if pad is None else pad > 0.5)
    psi_r, dT_r = ref.viterbi_forward_masked_pen_ref(log_A, em, delta0, mask,
                                                     tmask, smask)
    paths, scores = vdp.viterbi_backtrack_batch(psi, dT)
    paths_r, scores_r = ref.viterbi_backtrack_ref(psi_r, dT_r)
    torch.cuda.synchronize()
    if not (torch.equal(psi, psi_r) and torch.equal(dT, dT_r)
            and torch.equal(paths, paths_r) and torch.equal(scores, scores_r)):
        raise SystemExit(f"FAIL masked forward {what}: "
                         f"{int((psi != psi_r).sum())} psi entries differ, "
                         f"max |delta_T diff| "
                         f"{float((dT - dT_r).abs().max())}")
    print(f"masked forward kernel == plain (bitwise) at {what}")
    return float((dT - dT_r).abs().max())


def check_banded(vdp, ref, log_A, log_pi, em, centers, width: int,
                 what: str) -> float:
    """Banded kernel and a backtrack of its psi vs the plain versions,
    bitwise; returns max |delta_w difference|."""
    from repro_torch.kernels.ops import band_windows
    K = em.shape[1]
    Kb = min(2 * width + 1, K)
    c, starts = (x.to(em.device) for x in band_windows(centers, K, width))
    psi_r, dw_r = ref.viterbi_banded_forward_ref(log_A, log_pi, em, c, starts,
                                                 width)
    paths_r, _ = ref.viterbi_backtrack_ref(psi_r[None], dw_r[None])
    psi, dw = vdp.viterbi_banded_forward(log_A, log_pi, em, c, starts, width)
    paths, _ = vdp.viterbi_backtrack_batch(psi[None], dw[None])
    torch.cuda.synchronize()
    if not (torch.equal(psi, psi_r) and torch.equal(dw, dw_r)
            and torch.equal(paths, paths_r)):
        raise SystemExit(f"FAIL banded {what} (Kb = {Kb}): "
                         f"{int((psi != psi_r).sum())} psi entries differ")
    print(f"banded kernel == plain (bitwise) at {what}, Kb = {Kb}")
    return float((dw - dw_r).abs().max())


def phase_masked_kernels(dev) -> dict[str, float]:
    from repro_torch.kernels import ref
    from repro_torch.kernels import viterbi_dp as vdp
    from repro_torch.core import compiled_penalties

    err = {"viterbi_fwd_batch_masked": 0.0, "viterbi_banded_fwd": 0.0}
    g = np.random.default_rng(3)
    B, T = SERVE_B, 511
    lengths = [511, 300, 1, 0, 128, 511, 77, 255]
    log_A, tmask, em, smask, delta0 = lexicon_problem(dev, g, B, T)
    cases = [(f"lexicon tmask+smask (B,T,K)=({B},{T},{SERVE_K}) "
              f"lengths={lengths}", log_A, em, delta0, pad_of(lengths, T, dev),
              tmask, smask)]

    log_pi_g, log_A_g, em_g, _, band = grid_problem(dev)
    Kg, Tg = log_A_g.shape[0], GRID_T - 1
    _, _, s_pen = compiled_penalties(band, Kg, GRID_T)
    s_pen = torch.from_numpy(s_pen).to(dev)
    delta0_g = log_pi_g[None, :] + (em_g[:, 0] + s_pen[0])
    grid_len = [n - 1 for n in GRID_LENGTHS]
    cases.append((f"grid band smask (B,T,K)=({GRID_B},{Tg},{Kg}) "
                  f"lengths={grid_len}", log_A_g, em_g[:, 1:], delta0_g,
                  pad_of(grid_len, Tg, dev), None, s_pen[1:]))

    # more sequences than clusters: the lexicon serve model at B = 40
    b, lengths = 40, [0, 1, 511, 0] + g.integers(2, T + 1, 36).tolist()
    A, tm, e, sm, d0 = lexicon_problem(dev, g, b, T)
    cases.append((f"lexicon tmask+smask (B,T,K)=({b},{T},{SERVE_K}) "
                  f"lengths 0, 1, 511, 0 and 36 drawn from [2, 511]", A, e,
                  d0, pad_of(lengths, T, dev), tm, sm))

    # K = 1, 3 (CTAs without columns) and the instances' boundary
    k_res = resident_limit(vdp)
    for K in (1, 3, 100, 384, k_res, k_res // 8 * 8 + 8, 1500):
        b, t = 3, 37
        A, e, d0 = random_case(g, dev, K, b, t)
        tm, sm = (torch.from_numpy(np.where(
            g.random(shape) < frac, np.float32(-1.0e9),
            np.float32(0.0)).astype(np.float32)).to(dev)
            for shape, frac in (((K, K), 0.5), ((t, K), 0.3)))
        for name, tk, sk in (("tmask", tm, None), ("smask", None, sm),
                             ("tmask+smask", tm, sm)):
            cases.append((f"{name} (B,T,K)=({b},{t},{K}) lengths=[{t}, 1, 0]",
                          A, e, d0, pad_of([t, 1, 0], t, dev), tk, sk))

    for what, A, e, d0, pad, tk, sk in cases:
        err["viterbi_fwd_batch_masked"] = max(
            err["viterbi_fwd_batch_masked"],
            check_masked(vdp, ref, A, e, d0, pad, tk, sk, what))

    # banded: the map-matching shape, a band clipped at 0 and at K-1, a
    # single step, width 0, windows whose columns leave CTAs without any
    # (Kb = 5, 9, 17), one as wide as K (every start 0), an odd K and wider
    # windows (Kb = 255, 257)
    banded = [(f"map matching (T,K,width)=({GRID_T},{Kg},{GRID_WIDTH})",
               log_A_g, log_pi_g, em_g[0], band.centers, GRID_WIDTH)]
    for Kc, Tc, widths in ((300, 64, (96, 0, 2, 4, 8, 300)), (301, 24, (96,)),
                           (316, 40, (127, 128))):
        A, lp, e = (torch.from_numpy(g.standard_normal(shape).astype(
            np.float32)).to(dev) for shape in ((Kc, Kc), (Kc,), (Tc, Kc)))
        sweep = tuple(int(c) for c in np.linspace(-20, Kc + 20, Tc))
        for w in widths:
            banded.append((f"clipped at both ends (T,K,width)=({Tc},{Kc},{w})",
                           A, lp, e, sweep, w))
        banded.append((f"single step (T,K,width)=(1,{Kc},{widths[0]})", A, lp,
                       e[:1], sweep[:1], widths[0]))
    # the widest window the kernel takes, Kb = K = 29055 (every start 0),
    # one step: its two delta buffers leave no room for the mbarriers, so
    # each step ends with a cluster barrier (log_A: 3.4 GB, made on the card)
    Kw = vdp.MAX_K - 1
    gen = torch.Generator(device=dev).manual_seed(8)
    A, lp, e = (torch.randn(shape, generator=gen, device=dev)
                for shape in ((Kw, Kw), (Kw,), (2, Kw)))
    banded.append((f"widest window, cluster barrier (T,K,width)=(2,{Kw},"
                   f"{Kw // 2})", A, lp, e, (0, 0), Kw // 2))
    for what, A, lp, e, centers, width in banded:
        err["viterbi_banded_fwd"] = max(
            err["viterbi_banded_fwd"],
            check_banded(vdp, ref, A, lp, e, centers, width, what))
    del A, lp, e, banded
    return err


def expected_batches(requests) -> list[tuple[int, int]]:
    """(bucket, requests) of each batch the scheduler forms for these
    payloads, replayed without decoding."""
    from repro_torch.launch.serve import BUCKETS
    from repro_torch.serving.scheduler import BatchScheduler

    formed = []

    def record(padded, lens):
        formed.append((padded.shape[1], padded.shape[0]))
        return (np.zeros(padded.shape[:2], np.int32),
                np.zeros(len(lens), np.float32))

    sched = BatchScheduler(record, max_batch=8, buckets=BUCKETS)
    for r in sorted(requests, key=lambda r: r.rid):
        sched.submit(r.payload)
    sched.drain()
    return formed


def check_launches(what: str, launches: dict[str, int],
                   expected: dict[str, int]) -> None:
    """Each kernel in `expected` launched that many times, every other
    never: the launch guard's check (`analysis.retrace.check_launches`),
    a departure failing the run."""
    from repro_torch.analysis.retrace import LaunchError
    from repro_torch.analysis.retrace import check_launches as held
    try:
        held(what, launches, expected)
    except LaunchError as e:
        raise SystemExit(f"FAIL {e}") from None


def phase_serve(dev) -> dict[str, int]:
    from repro_torch.core import (left_to_right_hmm, relative_error,
                                  viterbi_vanilla)
    from repro_torch.core.reference import viterbi_numpy
    from repro_torch import kernels
    from repro_torch.launch import serve

    kernels.reset_launches()
    done = serve.main(["--method", "fused", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()

    formed = expected_batches(done)
    batches = len(formed)
    print(f"serve: {len(done)} requests, {batches} batches "
          f"(bucket x requests: "
          f"{', '.join(f'{b} x {n}' for b, n in formed)}), "
          f"launches {launches}")
    if len(done) != 32:
        raise SystemExit(f"FAIL serve: {len(done)} of 32 requests served")
    check_launches("serve", launches, dict(viterbi_fwd_batch=batches,
                                           viterbi_backtrack_batch=batches))

    # the same model serve.main built from its default seed and sizes
    hmm = left_to_right_hmm(np.random.default_rng(0), 512, 64, device=dev)
    worst = 0.0
    for r in done:
        path, score = r.result
        em = torch.from_numpy(r.payload).to(dev)
        p_ref, s_ref = viterbi_vanilla(hmm.log_pi, hmm.log_A, em)
        worst = max(worst, float(relative_error(float(s_ref), score)))
        if not np.array_equal(path, p_ref.cpu().numpy()):
            raise SystemExit(f"FAIL serve: request {r.rid} path != vanilla")
    if worst != 0.0:
        raise SystemExit(f"FAIL serve: relative error vs vanilla {worst}")
    log_pi, log_A = hmm.log_pi.cpu().numpy(), hmm.log_A.cpu().numpy()
    for r in done[:3]:
        p_np, s_np = viterbi_numpy(log_pi, log_A, r.payload)
        if not (np.array_equal(r.result[0], p_np) and r.result[1] == s_np):
            raise SystemExit(f"FAIL serve: request {r.rid} != viterbi_numpy")
    print("serve: all 32 paths == viterbi_vanilla, relative error 0; "
          "3 sampled == viterbi_numpy")
    return launches


def serve_requests(n: int = 32, seed: int = 0) -> list[np.ndarray]:
    """The requests `launch/serve.py` makes at its defaults: n emission
    matrices with T in {96, 128, 200, 256, 384, 512} at K = 512."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T = int(rng.choice([96, 128, 200, 256, 384, 512]))
        out.append(rng.standard_normal((T, SERVE_K)).astype(np.float32) * 2.0)
    return out


def phase_lexicon(dev) -> dict[str, int]:
    from repro_torch import kernels
    from repro_torch.core import (FusedSpec, constrain_inputs,
                                  left_to_right_hmm, viterbi_vanilla)
    from repro_torch.core.reference import viterbi_numpy
    from repro_torch.launch.serve import BUCKETS
    from repro_torch.serving import BatchScheduler, make_lexicon_align_head

    hmm = left_to_right_hmm(np.random.default_rng(0), SERVE_K, 64, device=dev)
    head = make_lexicon_align_head(hmm.log_pi, hmm.log_A, LEXICON,
                                   cfg=FusedSpec())
    sched = BatchScheduler(head, max_batch=SERVE_B, buckets=BUCKETS)
    for em in serve_requests():
        sched.submit(em)
    kernels.reset_launches()
    t0 = time.perf_counter()
    done = sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()

    formed = expected_batches(done)
    print(f"lexicon serve: {len(done)} requests in {wall:.4f} s on the host "
          f"clock, {len(formed)} batches (bucket x requests: "
          f"{', '.join(f'{b} x {n}' for b, n in formed)}), {len(LEXICON)} "
          f"words, launches {launches}")
    if len(done) != 32:
        raise SystemExit(f"FAIL lexicon serve: {len(done)} of 32 served")
    check_launches("lexicon serve", launches, dict(
        viterbi_fwd_batch_masked=len(formed),
        viterbi_backtrack_batch=len(formed)))
    for r in done:
        em = torch.from_numpy(r.payload).to(dev)
        p_ref, s_ref = viterbi_vanilla(*constrain_inputs(
            head.constraint, hmm.log_pi, hmm.log_A, em))
        path, score = r.result
        if not (np.array_equal(path, p_ref.cpu().numpy())
                and np.float32(score) == np.float32(float(s_ref))):
            raise SystemExit(f"FAIL lexicon serve: request {r.rid} != "
                             f"viterbi_vanilla over constrain_inputs")
    for r in done[:3]:
        lp, la, em = (x.cpu().numpy() for x in constrain_inputs(
            head.constraint, hmm.log_pi, hmm.log_A,
            torch.from_numpy(r.payload).to(dev)))
        p_np, s_np = viterbi_numpy(lp, la, em)
        if not (np.array_equal(r.result[0], p_np) and r.result[1] == s_np):
            raise SystemExit(f"FAIL lexicon serve: request {r.rid} != "
                             f"viterbi_numpy over the masked inputs")
    print("lexicon serve: all 32 paths and scores == viterbi_vanilla over "
          "constrain_inputs (relative error 0); 3 sampled == viterbi_numpy")
    return launches


def phase_map_matching(dev) -> dict[str, int]:
    from repro_torch import kernels
    from repro_torch.core import (FusedSpec, ViterbiDecoder,
                                  banded_state_bytes, constrain_inputs,
                                  viterbi_vanilla)

    log_pi, log_A, em, truth, band = grid_problem(dev)
    B, T, K = em.shape
    spec = FusedSpec(constraint=band)
    lengths = np.asarray(GRID_LENGTHS, np.int32)

    def oracle(e):
        return viterbi_vanilla(*constrain_inputs(band, log_pi, log_A, e))

    # (a) ragged batch of sensors: one masked-kernel launch
    dec = ViterbiDecoder(spec, log_pi, log_A)
    kernels.reset_launches()
    paths, scores = dec.decode_batch(em, lengths)
    torch.cuda.synchronize()
    batch_launches = kernels.launch_counts()
    print(f"map matching batch: (B,T,K)=({B},{T},{K}), lengths "
          f"{lengths.tolist()}, launches {batch_launches}")
    check_launches("map matching batch", batch_launches, dict(
        viterbi_fwd_batch_masked=1, viterbi_backtrack_batch=1))
    for i, L in enumerate(lengths):
        p_o, s_o = oracle(em[i, :L])
        if not (torch.equal(paths[i, :L], p_o) and
                float(scores[i]) == float(s_o)):
            raise SystemExit(f"FAIL map matching batch: sensor {i} != "
                             f"dense oracle")

    # (b) one trajectory: the band covers the horizon, one banded launch
    kernels.reset_launches()
    path, score = spec.run(log_pi, log_A, em[0])
    torch.cuda.synchronize()
    run_launches = kernels.launch_counts()
    print(f"map matching trajectory: (T,K,width)=({T},{K},{band.width}), "
          f"launches {run_launches}")
    check_launches("map matching trajectory", run_launches, dict(
        viterbi_banded_fwd=1, viterbi_backtrack_batch=1))
    p_o, s_o = oracle(em[0])
    if not (torch.equal(path, p_o) and float(score) == float(s_o)):
        raise SystemExit("FAIL map matching trajectory != dense oracle")
    acc = float(np.mean(path.cpu().numpy() == truth))
    acc_b = [float(np.mean(paths[i, :L].cpu().numpy() == truth[:L]))
             for i, L in enumerate(lengths)]
    dense = K * T * 4 + K * 8 + band.mask_bytes(K, T)
    print(f"map matching: batch and trajectory == dense oracle (bitwise); "
          f"match accuracy vs truth {acc:.4f} (trajectory), "
          f"{min(acc_b):.4f}..{max(acc_b):.4f} (sensors); state bytes "
          f"banded {banded_state_bytes(K, T, band.width):,} vs dense + mask "
          f"{dense:,}")
    return {n: batch_launches[n] + run_launches[n] for n in batch_launches}


def beam_bound(log_A, scores, states, chunk: int):
    """One beam step's work at the rows these beams gather
    (`kernels.work.beam_work`) as a bound."""
    from repro_torch.kernels import work
    N, B = scores.shape
    return bound_ms(*work.beam_work(N, log_A.shape[0], B, chunk,
                                    int(torch.unique(states).numel())))


def pass_bound(N: int, T: int, K: int, B: int, out_words: int,
               extra_bytes: int = 0):
    """A beam pass's work (`kernels.work.pass_work`) as a bound."""
    from repro_torch.kernels import work
    return bound_ms(*work.pass_work(N, T, K, B, out_words, extra_bytes))


def tropical_bound(a, b, with_args: bool = True):
    """The tropical product's work (`kernels.work.tropical_work`) as a
    bound."""
    from repro_torch.kernels import work
    N, I, K = a.shape
    return bound_ms(*work.tropical_work(N, I, K, b.shape[2],
                                        a.element_size(), with_args))


def beam_launches(batches, P: int = 8, lanes: int | None = None
                  ) -> dict[str, int]:
    """Beam-kernel launches of FLASH-BS batches of padded lengths `batches`:
    per batch, one initial pass and, for each layer of n = Tp/s tiles of
    length s = Tp/P, ..., 2, one tile launch per `lanes` tiles (one per
    `decode_tiles` call of the wavefront; ``lanes=None``: the whole layer)."""
    from repro_torch.core import plan_padding
    tiles = 0
    for bucket in batches:
        Tp, _ = plan_padding(bucket, P)
        s = Tp // P
        while s >= 2:
            tiles += 1 if lanes is None else -(-(Tp // s) // lanes)
            s //= 2
    return dict(bs_initial_pass_batch=len(batches),
                bs_segment_decode_batch=tiles)


def counted(total: dict[str, int], fn, *args, **kw):
    """(fn's result, the kernel launches it made); the launches are also
    added into `total`."""
    from repro_torch import kernels
    kernels.reset_launches()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name, n in counts.items():
        total[name] += n
    return out, counts


def beam_case(dev, g, N: int, K: int, B: int):
    """A (K, K) log_A, strided (N, K) emissions and N beams of B distinct
    states with normal scores."""
    log_A = torch.from_numpy(g.standard_normal((K, K)).astype(np.float32))
    em = torch.from_numpy(g.standard_normal((N, 2, K)).astype(np.float32))
    scores = torch.from_numpy(g.standard_normal((N, B)).astype(np.float32))
    states = torch.from_numpy(np.stack(
        [g.permutation(K)[:B] for _ in range(N)]).astype(np.int32))
    return (log_A.to(dev), em.to(dev)[:, 1], scores.to(dev), states.to(dev))


def check_same(what: str, out, ref_out) -> float:
    """Kernel outputs vs the plain version's, bitwise; returns the max
    |difference| of the first (value) output."""
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(out, ref_out)):
        raise SystemExit(f"FAIL {what}: kernel != plain version")
    print(f"{what}: kernel == plain (bitwise)")
    return float((out[0].float() - ref_out[0].float()).abs().max())


def phase_beam_tropical_kernels(dev):
    """1c: the beam and tropical kernels against their plain versions on the
    card, bitwise.  Returns (max |value differences| per kernel, the launches
    of the `ops.beam_step` calls: the op is the public path to the
    single-step entry, which no decode path calls)."""
    from repro_torch import kernels
    from repro_torch.core import left_to_right_hmm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.beam_stream import beam_step_batch
    from repro_torch.kernels.ops import _pad_to
    from repro_torch.kernels.tropical import tropical_matmul_batch

    err = {"beam_step_batch": 0.0, "tropical_matmul_batch": 0.0}
    g = np.random.default_rng(5)

    def beam(what, out, ref_out):
        err["beam_step_batch"] = max(err["beam_step_batch"],
                                     check_same(what, out, ref_out))

    # ops.beam_step at the shapes of tests/test_kernels.py::test_beam_step_kernel
    op_launches = {name: 0 for name in kernels.launch_counts()}
    for K, B, chunk in ((512, 64, 128), (300, 32, 128), (128, 128, 128),
                        (256, 16, 64)):
        A, em, sc, st = beam_case(dev, g, 1, K, B)
        kernels.reset_launches()
        out = ops.beam_step(A, em[0], sc[0], st[0], chunk=chunk)
        torch.cuda.synchronize()
        for name, n in kernels.launch_counts().items():
            op_launches[name] += n
        c = min(chunk, -(-K // 128) * 128)
        Ap = _pad_to(_pad_to(A, 0, c, -4e9), 1, c, -4e9)
        ref_out = ref.beam_transition_ref(Ap, _pad_to(em, 1, c, -4e9), sc, st,
                                          c)
        beam(f"beam_step (K,B,chunk)=({K},{B},{chunk})", out,
             [x[0] for x in ref_out])
    # the serve shapes: the initial pass (8 beams), the last layer (2048),
    # and chunk = K = B, the beam_static_mp and full-beam case
    for N, K, B, C in ((8, 512, 128, 128), (2048, 512, 128, 128),
                       (8, 512, 512, 512)):
        A, em, sc, st = beam_case(dev, g, N, K, B)
        beam(f"beam_step_batch (N,K,B,chunk)=({N},{K},{B},{C})",
             beam_step_batch(A, em, sc, st, C),
             ref.beam_transition_ref(A, em, sc, st, C))
    # 16 chained steps of a left-to-right beam from a one-hot beam: the
    # sentinel slots and NEG_INF ties decide the merge order
    N, K, B = 8, 512, 128
    A = left_to_right_hmm(g, K, 64, device=dev).log_A
    sc = torch.full((N, B), -4e9, device=dev)
    sc[:, 0] = 0.0
    st = torch.zeros((N, B), dtype=torch.int32, device=dev)
    sc_r, st_r = sc, st
    for t in range(16):
        em = torch.from_numpy(
            (2.0 * g.standard_normal((N, K))).astype(np.float32)).to(dev)
        sc, st, f = beam_step_batch(A, em, sc, st, 128)
        sc_r, st_r, f_r = ref.beam_transition_ref(A, em, sc_r, st_r, 128)
        torch.cuda.synchronize()
        if not (torch.equal(sc, sc_r) and torch.equal(st, st_r)
                and torch.equal(f, f_r)):
            raise SystemExit(f"FAIL beam_step_batch left-to-right chain: "
                             f"step {t} != plain version")
    print(f"beam_step_batch: 16 chained left-to-right steps (N,K,B)=({N},{K},"
          f"{B}) == plain (bitwise); {int((sc <= -1e9).sum())} of {N * B} "
          f"slots at NEG_INF sums")

    # tropical: the shapes of tests/test_kernels.py::test_tropical_matmul
    for I, K, J in ((8, 16, 128), (64, 128, 256), (37, 100, 200),
                    (1, 512, 512), (128, 64, 384)):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.from_numpy(g.standard_normal((I, K)).astype(
                np.float32)).to(dev, dt)
            b = torch.from_numpy(g.standard_normal((K, J)).astype(
                np.float32)).to(dev, dt)
            e = check_same(f"tropical_matmul {str(dt)[6:]} (I,K,J)=({I},{K},"
                           f"{J})", ops.tropical_matmul(a, b),
                           ref.tropical_matmul_ref(a, b))
            err["tropical_matmul_batch"] = max(err["tropical_matmul_batch"], e)
    # the batched kernel, with the argmax and values-only (the same vals, no
    # args): levels of the assoc scan at K = 64, ragged tile edges, tie-heavy
    # integer inputs, and operands whose base is not 16-byte aligned
    def trop(what, a, b):
        want = ref.tropical_matmul_ref(a, b)
        what = f"{what} {str(a.dtype)[6:]} (N,I,K,J)={(*a.shape, b.shape[2])}"
        e = check_same(f"tropical_matmul_batch {what}",
                       tropical_matmul_batch(a, b), want)
        vals, args = tropical_matmul_batch(a, b, with_args=False)
        if args is not None:
            raise SystemExit("FAIL tropical values-only: args returned")
        check_same(f"tropical_matmul_batch values-only {what}", (vals,),
                   want[:1])
        err["tropical_matmul_batch"] = max(err["tropical_matmul_batch"], e)

    for N, I, K, J in ((256, 64, 64, 64), (2047, 64, 64, 64), (3, 65, 33, 70),
                       (1, 130, 100, 131)):
        for dt in (torch.float32, torch.bfloat16):
            for kind, draw in (("normal", g.standard_normal),
                               ("integer", lambda s: g.integers(-3, 4, s))):
                a, b = (torch.from_numpy(draw(shape).astype(np.float32)).to(
                    dev, dt) for shape in ((N, I, K), (N, K, J)))
                trop(kind, a, b)
    a, b = (torch.from_numpy(g.standard_normal(3 * 64 * 64 + 1).astype(
        np.float32)).to(dev)[1:].view(3, 64, 64) for _ in range(2))
    trop("unaligned base", a, b)
    check_launches("ops.beam_step path", op_launches, dict(beam_step_batch=4))
    return err, op_launches


def pass_problem(dev, g, K: int, N: int, T: int, lengths=None,
                 model: str = "left-to-right"):
    """A model and N sequences of T steps for the beam passes: (log_pi,
    log_A, em (N, T, K) strided along N, as a decode's views are, pad (N,
    T) bool with True from each length on)."""
    from repro_torch.core import erdos_renyi_hmm, left_to_right_hmm
    hmm = (left_to_right_hmm(g, K, 64, device=dev) if model == "left-to-right"
           else erdos_renyi_hmm(g, K, 50, 0.253, device=dev))
    em = torch.from_numpy((2.0 * g.standard_normal((N, T + 1, K))).astype(
        np.float32)).to(dev)[:, 1:]
    lengths = [T] * N if lengths is None else lengths
    pad = (torch.arange(T, device=dev)[None, :]
           >= torch.tensor(lengths, device=dev)[:, None])
    return hmm.log_pi, hmm.log_A, em, pad


def tiles_of(dev, g, em, pad, s: int, K: int, i0: int = 0, ln=None):
    """The tiles of length s of a layer of the wavefront, as `wavefront`
    cuts them (lanes i0 .. i0 + ln of every sequence), with random pinned
    entry and exit states and every tile at step 0 marked first."""
    Bt, Tp = pad.shape
    n = Tp // s
    ln = n - i0 if ln is None else ln
    em_seg = em.reshape(Bt, n, s, K)[:, i0:i0 + ln].reshape(Bt * ln, s, K)
    pad_seg = pad.reshape(Bt, n, s)[:, i0:i0 + ln].reshape(Bt * ln, s)
    M = Bt * ln
    entry, exit_state = (torch.from_numpy(g.integers(0, K, M)).to(dev)
                         for _ in range(2))
    is_first = torch.from_numpy(np.arange(i0, i0 + ln) == 0).to(dev).repeat(
        Bt)
    return em_seg, pad_seg, entry, exit_state, is_first


def phase_beam_passes(dev) -> dict[str, float]:
    """1c, continued: the two pass entries against their plain versions on
    the card, bitwise, at the serve's shapes and at the edges of the
    template (the global instance, a K the cluster does not divide)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.beam_stream import (bs_initial_pass_batch,
                                                 bs_segment_decode_batch,
                                                 pass_instance)
    err = {"bs_initial_pass_batch": 0.0, "bs_segment_decode_batch": 0.0}
    g = np.random.default_rng(6)

    def initial(what, lp, A, em, pad, P: int, B: int):
        T, K = em.shape[1:]
        bnd = (np.arange(1, P) * (T // P) - 1).astype(np.int64)
        chunk = 128 if K % 128 == 0 else None
        q_b, q_l, sc = bs_initial_pass_batch(lp, A, em, pad, bnd, B)
        q_b_r, q_l_r, sc_r = ref.bs_initial_pass_ref(lp, A, em, pad, bnd, B,
                                                     chunk)
        e = check_same(f"bs_initial_pass_batch {what} (N,Tp,K,B,P)=("
                       f"{em.shape[0]},{T},{K},{B},{P}), "
                       f"{pass_instance(K, B, len(bnd))} log_A",
                       (sc, q_b, q_l), (sc_r, q_b_r, q_l_r))
        err["bs_initial_pass_batch"] = max(err["bs_initial_pass_batch"], e)

    def segment(what, lp, A, em_seg, pad_seg, entry, exit_state, is_first,
                B: int):
        M, s, K = em_seg.shape
        chunk = 128 if K % 128 == 0 else None
        out = bs_segment_decode_batch(lp, A, em_seg, pad_seg, entry,
                                      exit_state, is_first, B)
        want = ref.bs_segment_decode_ref(lp, A, em_seg, pad_seg, entry,
                                         exit_state, is_first, B, chunk)
        e = check_same(f"bs_segment_decode_batch {what} (M,s,K,B)=({M},{s},"
                       f"{K},{B}), {pass_instance(K, B, 1)} log_A",
                       (out,), (want,))
        err["bs_segment_decode_batch"] = max(err["bs_segment_decode_batch"],
                                             e)

    # the serve's initial pass of a 512 bucket on the tie-heavy serve model,
    # ragged pad tails (one crossing a boundary on a pad step: 64 = 63 + 1)
    lengths = [512, 300, 64, 1, 128, 512, 77, 255]
    lp, A, em, pad = pass_problem(dev, g, SERVE_K, 8, 512, lengths)
    initial(f"serve, lengths {lengths}", lp, A, em, pad, 8, 128)
    # its first layer (64 tiles of 64 steps), a lanes group of its second
    # (8 x 8 tiles of 32 steps) and its last (2048 tiles of 2 steps)
    segment("serve first layer", lp, A, *tiles_of(dev, g, em, pad, 64,
                                                  SERVE_K), 128)
    segment("serve lanes group 8..15", lp, A,
            *tiles_of(dev, g, em, pad, 32, SERVE_K, 8, 8), 128)
    segment("serve last layer", lp, A, *tiles_of(dev, g, em, pad, 2,
                                                 SERVE_K), 128)
    # the planner's beam rung: P = 1, beam 256
    initial("budget rung", lp, A, em, pad, 1, 256)
    segment("budget rung", lp, A, *tiles_of(dev, g, em, pad, 16, SERVE_K),
            256)
    # Erdos-Renyi K = 512 at a full beam (flash_bs and beam_static_mp, beam K)
    lp, A, em, pad = pass_problem(dev, g, SERVE_K, 4, 64, model="er")
    initial("erdos-renyi full beam", lp, A, em, pad, 8, 512)
    segment("erdos-renyi full beam", lp, A, *tiles_of(dev, g, em, pad, 8,
                                                      SERVE_K), 512)
    # K = 1024: log_A's column slices do not fit, the global instance
    lp, A, em, pad = pass_problem(dev, g, 1024, 4, 64, [64, 40, 9, 1])
    initial("K = 1024", lp, A, em, pad, 4, 128)
    segment("K = 1024", lp, A, *tiles_of(dev, g, em, pad, 8, 1024), 128)
    # K = 100 and K = 3: the cluster's 8 CTAs own 13 / 1 columns, the last
    # CTAs a tail or none
    for K, B in ((100, 32), (3, 2)):
        lp, A, em, pad = pass_problem(dev, g, K, 5, 40, [40, 33, 20, 2, 1],
                                      model="er")
        initial(f"K = {K}", lp, A, em, pad, 4, B)
        segment(f"K = {K}", lp, A, *tiles_of(dev, g, em, pad, 10, K), B)
    return err


def flash_bs_sample(done, n: int = 8):
    """n served requests, the first of each bucket among them."""
    from repro_torch.launch.serve import BUCKETS
    first = {}
    for r in done:
        first.setdefault(next(b for b in BUCKETS if len(r.payload) <= b), r)
    picked = list(first.values())
    ids = {r.rid for r in picked}
    return picked + [r for r in done if r.rid not in ids][:n - len(picked)]


def phase_flash_bs_serve(dev) -> dict[str, int]:
    """6: the default serve (FLASH-BS, beam 128, P = 8) on the beam kernel."""
    from repro_torch import kernels
    from repro_torch.core import (flash_bs_viterbi, left_to_right_hmm,
                                  relative_error, viterbi_vanilla)
    from repro_torch.launch import serve

    kernels.reset_launches()
    done = serve.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    formed = expected_batches(done)
    predicted = beam_launches([b for b, _ in formed])
    print(f"flash_bs serve: {len(done)} requests, {len(formed)} batches "
          f"(bucket x requests: {', '.join(f'{b} x {n}' for b, n in formed)}),"
          f" {sum(predicted.values())} beam launches predicted {predicted}, "
          f"launches {launches}")
    if len(done) != 32 or len(formed) != 5:
        raise SystemExit(f"FAIL flash_bs serve: {len(done)} of 32 requests "
                         f"in {len(formed)} batches")
    check_launches("flash_bs serve", launches, predicted)

    hmm = left_to_right_hmm(np.random.default_rng(0), SERVE_K, 64, device=dev)
    lp, la = hmm.log_pi.cpu(), hmm.log_A.cpu()
    sample = flash_bs_sample(done)
    for r in sample:
        p, s = flash_bs_viterbi(lp, la, torch.from_numpy(r.payload),
                                beam_width=128, parallelism=8, lanes=None,
                                chunk=128)
        if not (np.array_equal(r.result[0], p.numpy())
                and np.float32(r.result[1]) == np.float32(float(s))):
            raise SystemExit(f"FAIL flash_bs serve: request {r.rid} (T = "
                             f"{len(r.payload)}) != flash_bs_viterbi on the "
                             f"CPU")
    errs = []
    for r in done:
        _, opt = viterbi_vanilla(hmm.log_pi, hmm.log_A,
                                 torch.from_numpy(r.payload).to(dev))
        errs.append(float(relative_error(float(opt), r.result[1])))
    print(f"flash_bs serve: {len(sample)} sampled requests (T = "
          f"{sorted(len(r.payload) for r in sample)}) == flash_bs_viterbi on "
          f"the CPU (bitwise)")
    print(f"relative error vs exact (all 32): mean={np.mean(errs):.2e} "
          f"max={np.max(errs):.2e}")
    return launches


def phase_flash_bs_lexicon(dev) -> dict[str, int]:
    """7: the lexicon serve under the default (FLASH-BS) head."""
    from repro_torch import kernels
    from repro_torch.core import (constrain_inputs, left_to_right_hmm,
                                  relative_error, viterbi_vanilla)
    from repro_torch.launch.serve import BUCKETS
    from repro_torch.serving import BatchScheduler, make_lexicon_align_head

    hmm = left_to_right_hmm(np.random.default_rng(0), SERVE_K, 64, device=dev)
    head = make_lexicon_align_head(hmm.log_pi, hmm.log_A, LEXICON)
    sched = BatchScheduler(head, max_batch=SERVE_B, buckets=BUCKETS)
    for em in serve_requests():
        sched.submit(em)
    kernels.reset_launches()
    t0 = time.perf_counter()
    done = sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    formed = expected_batches(done)
    predicted = beam_launches([b for b, _ in formed])
    spec = head.decoder.spec
    print(f"flash_bs lexicon serve ({type(spec).__name__}, beam "
          f"{spec.beam_width}, P = {spec.parallelism}, {len(LEXICON)} words): "
          f"{len(done)} requests in {wall:.4f} s on the host clock, "
          f"{len(formed)} batches, {sum(predicted.values())} beam launches "
          f"predicted {predicted}, launches {launches}")
    if len(done) != 32:
        raise SystemExit(f"FAIL flash_bs lexicon serve: {len(done)} of 32")
    check_launches("flash_bs lexicon serve", launches, predicted)
    lp, la = hmm.log_pi.cpu(), hmm.log_A.cpu()
    for r in flash_bs_sample(done, 3):
        p, s = spec.run(lp, la, torch.from_numpy(r.payload))
        if not (np.array_equal(r.result[0], p.numpy())
                and np.float32(r.result[1]) == np.float32(float(s))):
            raise SystemExit(f"FAIL flash_bs lexicon serve: request {r.rid} "
                             f"!= the same spec on the CPU")
    errs = []
    for r in done:
        _, opt = viterbi_vanilla(*constrain_inputs(
            head.constraint, hmm.log_pi, hmm.log_A,
            torch.from_numpy(r.payload).to(dev)))
        errs.append(float(relative_error(float(opt), r.result[1])))
    print(f"flash_bs lexicon serve: 3 sampled == the CPU run (bitwise); "
          f"relative error vs exact (all 32): mean={np.mean(errs):.2e} "
          f"max={np.max(errs):.2e}")
    return launches


def phase_paper_workload(dev) -> dict[str, int]:
    """8: the paper's algorithms at full width on its default workload."""
    from repro_torch import kernels
    from repro_torch.analysis.retrace import scan_levels
    from repro_torch.core import (AssocSpec, BeamStaticMPSpec, BeamStaticSpec,
                                  CheckpointSpec, FlashBSSpec, FlashSpec,
                                  ViterbiDecoder, erdos_renyi_hmm,
                                  random_emissions, relative_error,
                                  viterbi_vanilla)
    from repro_torch.launch import serve

    g = np.random.default_rng(11)
    B, T, K = SERVE_B, 511, SERVE_K
    hmm = erdos_renyi_hmm(g, K, 50, 0.253, device=dev)
    em = random_emissions(g, B * T, K, device=dev).reshape(B, T, K)
    exact = [viterbi_vanilla(hmm.log_pi, hmm.log_A, e) for e in em]
    total = {name: 0 for name in kernels.launch_counts()}

    def held(what, spec, paths, scores, launches):
        for i in range(len(paths)):
            p_v, s_v = exact[i]
            err = float(relative_error(float(s_v), float(scores[i])))
            if not torch.equal(paths[i], p_v) or err != 0.0:
                raise SystemExit(f"FAIL paper workload {what}: sequence {i} "
                                 f"!= viterbi_vanilla (relative error {err})")
        for name, n in launches.items():
            total[name] += n
        print(f"paper workload {what} {spec!r}: {len(paths)} paths == "
              f"viterbi_vanilla, relative error 0; launches "
              f"{ {n: v for n, v in launches.items() if v} }")

    batched = (("flash", FlashSpec(parallelism=8)),
               ("flash_bs", FlashBSSpec(beam_width=K)))
    single = (("checkpoint", CheckpointSpec()),
              ("beam_static", BeamStaticSpec(beam_width=K)),
              ("beam_static_mp", BeamStaticMPSpec(beam_width=K)))
    for what, spec in batched + single:
        kernels.reset_launches()
        t0 = time.perf_counter()
        if spec.batch_method is not None:
            paths, scores = ViterbiDecoder(spec, hmm.log_pi, hmm.log_A
                                           ).decode_batch(em)
        else:
            out = [spec.run(hmm.log_pi, hmm.log_A, e) for e in em]
            paths, scores = [p for p, _ in out], [s for _, s in out]
        torch.cuda.synchronize()
        print(f"paper workload {what}: (B,T,K)=({B},{T},{K}) in "
              f"{time.perf_counter() - t0:.4f} s on the host clock")
        held(what, spec, paths, scores, kernels.launch_counts())
    if not (total["bs_initial_pass_batch"] and
            total["bs_segment_decode_batch"]):
        raise SystemExit("FAIL paper workload: a beam pass never ran")

    # assoc at (T, K) = (4096, 64): T * K^2 * 4 = 67 MB of prefix products
    Ta, Ka = 4096, 64
    hmm_a = erdos_renyi_hmm(g, Ka, 50, 0.253, device=dev)
    em_a = random_emissions(g, Ta, Ka, device=dev)
    kernels.reset_launches()
    p, s = AssocSpec().run(hmm_a.log_pi, hmm_a.log_A, em_a)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    p_v, s_v = viterbi_vanilla(hmm_a.log_pi, hmm_a.log_A, em_a)
    err = float(relative_error(float(s_v), float(s)))
    # the scan groups the adds as a tree, so the score may round apart from
    # the sequential DP's: held to tests/test_core_viterbi.py's rtol 1e-5
    if not torch.equal(p, p_v) or err > 1e-5:
        raise SystemExit(f"FAIL paper workload assoc: path or score != "
                         f"viterbi_vanilla (relative error {err})")
    p_c, s_c = AssocSpec().run(hmm_a.log_pi.cpu(), hmm_a.log_A.cpu(),
                               em_a.cpu())
    if not (torch.equal(p.cpu(), p_c) and float(s) == float(s_c)):
        raise SystemExit("FAIL paper workload assoc: card != the CPU run")
    for name, n in launches.items():
        total[name] += n
    print(f"paper workload assoc (T,K)=({Ta},{Ka}): path == viterbi_vanilla, "
          f"relative error {err:.3e} (rtol 1e-5: the scan groups the adds as "
          f"a tree); path and score == the CPU run (bitwise); launches "
          f"{ {n: v for n, v in launches.items() if v} }")
    # one values-only launch per level of the scan, one argmax launch for
    # the backtrack's table, one backtrack launch, nothing else
    check_launches("paper workload assoc", launches, dict(
        tropical_matmul_batch=len(scan_levels(Ta - 1)) + 1,
        viterbi_backtrack_batch=1))

    # the planner in the serve: an exact FLASH rung and a beam rung
    for kb in ("1024", "32"):
        kernels.reset_launches()
        serve.main(["--device", "cuda", "--budget-kb", kb])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        for name, n in launches.items():
            total[name] += n
        print(f"budget serve {kb} KiB: launches "
              f"{ {n: v for n, v in launches.items() if v} }")
    return total


def chunk_bound(N: int, C: int, K: int, B: int, n_first: int):
    """A chunk launch's work (`kernels.work.chunk_work`) as a bound."""
    from repro_torch.kernels import work
    return bound_ms(*work.chunk_work(N, C, K, B, n_first))


def padded_beam_model(dev, log_pi, log_A, B: int, kchunk: int):
    """(log_pi, log_A, K_pad) padded as `OnlineBeamDecoder` pads them (the
    decoder's own tensors)."""
    from repro_torch.core import OnlineBeamDecoder
    dec = OnlineBeamDecoder(log_pi, log_A, beam_width=B, kchunk=kchunk)
    return dec.log_pi, dec.log_A, dec.K_pad


def phase_stream_kernels(dev) -> dict[str, float]:
    """1d: the beam kernel's chunk mode and the forward kernel at the
    streaming and slot shapes against their plain versions, bitwise."""
    from repro_torch.core import (LexiconConstraint, erdos_renyi_hmm,
                                  left_to_right_hmm)
    from repro_torch.core.constraints import init_penalty, transition_penalty
    from repro_torch.kernels import ref
    from repro_torch.kernels import viterbi_dp as vdp
    from repro_torch.kernels.beam_stream import bs_chunk_batch, pass_instance
    from repro_torch.serving.inflight import _inflight_step

    err = {"bs_chunk_batch": 0.0, "viterbi_fwd_batch": 0.0}
    g = np.random.default_rng(12)

    def emissions(N, C, K, K_real=None):
        em = torch.from_numpy((2.0 * g.standard_normal((N, C + 1, K))).astype(
            np.float32)).to(dev)[:, 1:]     # strided along N, as views are
        if K_real is not None and K_real < K:
            em[..., K_real:] = -2e9
        return em

    def chunk(what, lp, A, em, sc, st, first, B, kchunk):
        N, C, K = em.shape
        out = bs_chunk_batch(lp, A, em, sc, st, first, B, kchunk)
        want = ref.beam_chunk_ref(lp, A, em, sc, st, first, B, kchunk)
        e = check_same(f"bs_chunk_batch {what} (N,C,K,B)=({N},{C},{K},{B}),"
                       f" {int(first.sum())} of {N} seeding, "
                       f"{pass_instance(K, B, 0)} log_A", out, want)
        err["bs_chunk_batch"] = max(err["bs_chunk_batch"], e)
        return out

    def carry(N, B, K):
        sc = torch.from_numpy(g.standard_normal((N, B)).astype(
            np.float32)).to(dev)
        st = torch.from_numpy(np.stack([g.permutation(K)[:B]
                                        for _ in range(N)]).astype(
            np.int32)).to(dev)
        return sc, st

    def flags(N, first):
        return torch.full((N,), first, dtype=torch.bool, device=dev)

    K, B = SERVE_K, 128
    serve = left_to_right_hmm(np.random.default_rng(0), K, 64, device=dev)
    lp, A = serve.log_pi, serve.log_A
    for N in (1, 8):          # the serve model, seeding and carried
        sc, st = carry(N, B, K)
        em = emissions(N, 64, K)
        out = chunk("serve model, seeding", lp, A, em, sc, st, flags(N, True),
                    B, 128)
        chunk("serve model, carried", lp, A, emissions(N, 64, K), out[0],
              out[1], flags(N, False), B, 128)
        chunk("random carried beams", lp, A, em, sc, st, flags(N, False), B,
              128)
    # a seeding feed of one row (the seed alone), a full beam, mixed flags
    sc, st = carry(1, B, K)
    chunk("seed alone", lp, A, emissions(1, 1, K), sc, st, flags(1, True), B,
          128)
    sc, st = carry(2, K, K)
    chunk("full beam", lp, A, emissions(2, 16, K), sc, st, flags(2, True), K,
          K)
    sc, st = carry(16, B, K)
    mixed = torch.from_numpy(g.random(16) < 0.5).to(dev)
    chunk("more beams than clusters", lp, A, emissions(16, 9, K), sc, st,
          mixed, B, 128)
    # K = 200 padded to 256 with kchunk 128, as the decoder pads it: a padded
    # state's seed is -4e9, the sentinel's score
    er = erdos_renyi_hmm(g, 200, 50, 0.253, device=dev)
    for Bp in (16, 128, 200):
        lp2, A2, K_pad = padded_beam_model(dev, er.log_pi, er.log_A, Bp, 128)
        sc, st = carry(2, Bp, 200)
        out = chunk("K = 200 padded to 256", lp2, A2, emissions(2, 33, K_pad,
                                                                200),
                    sc, st, flags(2, True), Bp, 128)
        chunk("K = 200 padded to 256, carried", lp2, A2,
              emissions(2, 33, K_pad, 200), out[0], out[1], flags(2, False),
              Bp, 128)
    # K = 3 (CTAs without columns) and K = 1024 (the global instance)
    for Kx, Bx in ((3, 2), (1024, 128)):
        hx = erdos_renyi_hmm(g, Kx, 50, 0.253, device=dev)
        sc, st = carry(3, Bx, Kx)
        chunk(f"K = {Kx}", hx.log_pi, hx.log_A, emissions(3, 17, Kx), sc, st,
              torch.tensor([True, False, True], device=dev), Bx,
              Kx if Kx < 128 else 128)
    # the lexicon-constrained serve model: penalties push scores to
    # multiples of NEG_INF, so real entries tie each other and the sentinels
    c = LexiconConstraint(LEXICON)
    lpc = lp + torch.from_numpy(init_penalty(c, K)).to(dev)
    Ac = (A + torch.from_numpy(transition_penalty(c, K)).to(dev)).contiguous()
    sc, st = carry(4, B, K)
    out = chunk("lexicon-constrained serve model", lpc, Ac,
                emissions(4, 64, K), sc, st, flags(4, True), B, 128)
    # three chained feeds, each carrying the last one's output
    first = flags(1, True)
    out = (None, None)
    for i, C in enumerate((1, 17, 64)):
        s0, t0 = out[:2] if i else carry(1, B, K)
        out = chunk(f"chained feed {i + 1}", lp, A, emissions(1, C, K), s0,
                    t0, first if i == 0 else flags(1, False), B, 128)

    # the forward kernel at the streaming chunk shapes (B = 1) and the
    # inflight slot shape (64, 16, 512)
    for T in (63, 64):
        em = emissions(1, T, K)
        d0 = lp[None] + emissions(1, 1, K)[:, 0]
        e, _, _ = check_forward(vdp, ref, A, em, d0.contiguous(), None,
                                f"streaming chunk (B,T,K)=(1,{T},{K})")
        err["viterbi_fwd_batch"] = max(err["viterbi_fwd_batch"], e)
    S, blk = 64, 16
    delta = (lp[None] + emissions(S, 1, K)[:, 0]).contiguous()
    for name, nfeed in (("nfeed drawn from 0..16", g.integers(0, 17, S)),
                        ("every nfeed 0", np.zeros(S, np.int64)),
                        ("every nfeed 16", np.full(S, 16))):
        e, _, _ = check_forward(vdp, ref, A, emissions(S, blk, K), delta,
                                pad_of(nfeed, blk, dev),
                                f"slot step (S,block,K)=({S},{blk},{K}), "
                                f"{name}")
        err["viterbi_fwd_batch"] = max(err["viterbi_fwd_batch"], e)
    # a fresh re-seed of some rows, through the scheduler's own step
    fresh = torch.from_numpy(g.random(S) < 0.3).to(dev)
    em0 = emissions(S, 1, K)[:, 0].contiguous()
    em = emissions(S, blk, K).contiguous()
    nfeed = torch.from_numpy(g.integers(0, 17, S).astype(np.int32)).to(dev)
    psi, dT = _inflight_step(lp, A, em0, fresh, em, delta, nfeed)
    seeded = torch.where(fresh[:, None], lp[None, :] + em0, delta)
    pad = torch.arange(blk, device=dev)[None, :] >= nfeed[:, None]
    psi_r, dT_r = ref.viterbi_forward_masked_ref(A, em, seeded, pad)
    torch.cuda.synchronize()
    if not (torch.equal(psi, psi_r) and torch.equal(dT, dT_r)):
        raise SystemExit("FAIL slot step with a fresh re-seed != plain")
    print(f"forward kernel == plain (bitwise) at the slot step with "
          f"{int(fresh.sum())} of {S} rows re-seeded")
    return err


def piece_sizes(rng, T: int) -> list[int]:
    """Ragged pieces of a T-frame request: sizes drawn from 1..100."""
    sizes = []
    while sum(sizes) < T:
        sizes.append(min(int(rng.integers(1, 101)), T - sum(sizes)))
    return sizes


STREAM_BLOCKS = (32, 128, 512)
STREAM_CONFIGS = (("online", dict(method="online")),
                  ("online_beam", dict(method="online_beam", beam_width=128)),
                  ("max_lag=64", dict(method="online", max_lag=64)))


def stream_drain(dev, log_pi, log_A, cfg, requests, seed: int = 0):
    """The 32 requests through one `StreamMux` on `dev`: session i opens
    with block STREAM_BLOCKS[i % 3], and the requests' ragged pieces arrive
    interleaved, round robin.  Returns ({sid: (path, score)}, {sid:
    block})."""
    from repro_torch.serving import StreamMux
    rng = np.random.default_rng(seed)
    mux = StreamMux(log_pi, log_A, cfg, blocks=STREAM_BLOCKS, device=dev)
    sids = [mux.open(block=STREAM_BLOCKS[i % 3]) for i in range(len(requests))]
    blocks = {sid: s.block for sid, s in mux._sessions.items()}
    pieces = [piece_sizes(rng, len(em)) for em in requests]
    cursor = [0] * len(requests)
    while any(pieces):
        for i, sid in enumerate(sids):
            if pieces[i]:
                n = pieces[i].pop(0)
                mux.feed(sid, requests[i][cursor[i]:cursor[i] + n])
                cursor[i] += n
    return {sid: mux.finish(sid) for sid in sids}, blocks


def phase_streaming(dev) -> dict[str, int]:
    """9: the 32 serve requests through the streaming tier at K = 512."""
    from repro_torch import kernels
    from repro_torch.core import (left_to_right_hmm, relative_error,
                                  viterbi_vanilla)
    from repro_torch.serving import StreamConfig

    hmm = left_to_right_hmm(np.random.default_rng(0), SERVE_K, 64, device=dev)
    reqs = serve_requests()
    exact = [viterbi_vanilla(hmm.log_pi, hmm.log_A,
                             torch.from_numpy(em).to(dev)) for em in reqs]
    lp_c, la_c = hmm.log_pi.cpu(), hmm.log_A.cpu()
    total = {name: 0 for name in kernels.launch_counts()}
    for what, kw in STREAM_CONFIGS:
        cfg = StreamConfig(**kw)
        kernels.reset_launches()
        t0 = time.perf_counter()
        done, blocks = stream_drain(dev, hmm.log_pi, hmm.log_A, cfg, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        # every decoder feed is a whole block or the remainder at finish;
        # each runs one launch (no request is 1 frame long)
        feeds = sum(-(-len(em) // blocks[sid]) for sid, em in
                    zip(sorted(done), reqs))
        kernel = ("bs_chunk_batch" if kw["method"] == "online_beam"
                  else "viterbi_fwd_batch")
        print(f"streaming {what}: 32 requests in {wall:.4f} s on the host "
              f"clock, {feeds} block feeds, launches "
              f"{ {n: v for n, v in launches.items() if v} }")
        check_launches(f"streaming {what}", launches, {kernel: feeds})
        for name, n in launches.items():
            total[name] += n
        if what == "online":
            for sid, (path, score) in done.items():
                p_v, s_v = exact[sid]
                if not (np.array_equal(path, p_v.cpu().numpy())
                        and np.float32(score) == np.float32(float(s_v))):
                    raise SystemExit(f"FAIL streaming online: session {sid}"
                                     f" != viterbi_vanilla")
            print("streaming online: all 32 paths and scores == "
                  "viterbi_vanilla (bitwise)")
            continue
        # the same sessions decoded on the CPU by the plain versions, fed
        # the same pieces: 8 sampled, one of each block size among them
        cpu_done, _ = stream_drain(torch.device("cpu"), lp_c, la_c, cfg,
                                   reqs[:8])
        for sid in range(8):
            (p, s), (p_c, s_c) = done[sid], cpu_done[sid]
            if not (np.array_equal(p, p_c) and np.float32(s) ==
                    np.float32(s_c)):
                raise SystemExit(f"FAIL streaming {what}: session {sid} != "
                                 f"the CPU run")
        errs = [float(relative_error(float(exact[sid][1]), done[sid][1]))
                for sid in done]
        print(f"streaming {what}: 8 sampled sessions == the same decode on "
              f"the CPU (bitwise); relative error vs exact (all 32): "
              f"mean={np.mean(errs):.2e} max={np.max(errs):.2e}")
    return total


def inflight_drain(dev, log_pi, log_A, reqs, seed: int = 0,
                   record=None):
    """The requests into one `InflightScheduler(max_slots=64, block=16)`:
    three sessions join every tick (even ones exact, odd ones max_lag=16),
    every live session is fed a piece of 1..24 frames a tick, and the pool
    takes one `step()` a tick; then each session finishes.  Returns
    (scheduler, [sid], {sid: (path, score)})."""
    from repro_torch.serving import InflightScheduler
    rng = np.random.default_rng(seed)
    sched = InflightScheduler(log_pi, log_A, max_slots=64, block=16,
                              device=dev)
    sids, cursor, todo = [], {}, list(range(len(reqs)))
    while todo or any(cursor[s] < len(reqs[i]) for i, s in enumerate(sids)):
        for _ in range(3):
            if todo:
                i = todo.pop(0)
                sid = sched.submit(max_lag=None if i % 2 == 0 else 16)
                sids.append(sid)
                cursor[sid] = 0
        for i, sid in enumerate(sids):
            c = cursor[sid]
            if c < len(reqs[i]):
                n = int(rng.integers(1, 25))
                sched.feed(sid, reqs[i][c:c + n])
                cursor[sid] = c + n
        sched.step()
        if record is not None:
            record()
    return sched, sids, {sid: sched.finish(sid) for sid in sids}


def phase_inflight(dev) -> dict[str, int]:
    """10: the 32 serve requests through the inflight pool at K = 512."""
    from repro_torch import kernels
    from repro_torch.core import left_to_right_hmm, viterbi_vanilla
    from repro_torch.serving import InflightScheduler, StreamConfig, StreamMux
    from repro_torch.serving import inflight as inflight_mod

    hmm = left_to_right_hmm(np.random.default_rng(0), SERVE_K, 64, device=dev)
    reqs = serve_requests()
    shapes = []
    step_fn = inflight_mod.viterbi_slot_step

    def recorded(log_A, em, delta, nfeed, **kw):
        shapes.append((tuple(em.shape), tuple(delta.shape)))
        return step_fn(log_A, em, delta, nfeed, **kw)

    inflight_mod.viterbi_slot_step = recorded
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        sched, sids, done = inflight_drain(dev, hmm.log_pi, hmm.log_A, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        inflight_mod.viterbi_slot_step = step_fn
    steps = sched.stats["steps"]
    print(f"inflight: 32 requests in {wall:.4f} s on the host clock, "
          f"{steps} steps, launches "
          f"{ {n: v for n, v in launches.items() if v} }")
    check_launches("inflight", launches, {"viterbi_fwd_batch": steps})
    if len(shapes) != steps or set(shapes) != {((64, 16, SERVE_K),
                                                 (64, SERVE_K))}:
        raise SystemExit(f"FAIL inflight: {len(shapes)} slot steps for "
                         f"{steps} steps, shapes {set(shapes)}")
    forced = 0
    for i, sid in enumerate(sids):
        em = torch.from_numpy(reqs[i]).to(dev)
        spec = sched.session_spec(sid)
        p_o, s_o = spec.run(hmm.log_pi, hmm.log_A, em)
        path, score = done[sid]
        if not (np.array_equal(path, p_o.cpu().numpy())
                and np.float32(score) == np.float32(float(s_o))):
            raise SystemExit(f"FAIL inflight: session {sid} (max_lag "
                             f"{spec.max_lag}) != OnlineSpec(stream_chunk=16,"
                             f" max_lag={spec.max_lag}).run")
        if spec.max_lag is None:
            p_v, s_v = viterbi_vanilla(hmm.log_pi, hmm.log_A, em)
            if not (np.array_equal(path, p_v.cpu().numpy())
                    and np.float32(score) == np.float32(float(s_v))):
                raise SystemExit(f"FAIL inflight: exact session {sid} != "
                                 f"viterbi_vanilla")
        forced += sched._sessions[sid].dec.stats["forced"]
    lag = sched.slo_report()["commit_lag"]
    print(f"inflight: every step one forward launch at (S,block,K)=(64,16,"
          f"{SERVE_K}); all 32 paths and scores == the OnlineSpec oracle, the"
          f" 16 exact ones == viterbi_vanilla (bitwise); {forced} forced "
          f"flushes; commit lag peak p50 {lag['peak_p50']} p99 "
          f"{lag['peak_p99']}")

    # the mux routes online sessions into a pool
    kernels.reset_launches()
    pool = InflightScheduler(hmm.log_pi, hmm.log_A, max_slots=64, block=16,
                             device=dev)
    mux = StreamMux(hmm.log_pi, hmm.log_A, StreamConfig(), inflight=pool,
                    device=dev)
    mids = [mux.open() for _ in range(8)]
    rng = np.random.default_rng(1)
    cursor = [0] * 8
    pieces = [piece_sizes(rng, len(em)) for em in reqs[:8]]
    while any(pieces):
        for i, sid in enumerate(mids):
            if pieces[i]:
                n = pieces[i].pop(0)
                mux.feed(sid, reqs[i][cursor[i]:cursor[i] + n])
                cursor[i] += n
    routed = {sid: mux.finish(sid) for sid in mids}
    torch.cuda.synchronize()
    mux_launches = kernels.launch_counts()
    check_launches("mux into inflight", mux_launches,
                   {"viterbi_fwd_batch": pool.stats["steps"]})
    for i, sid in enumerate(mids):
        p_v, s_v = viterbi_vanilla(hmm.log_pi, hmm.log_A,
                                   torch.from_numpy(reqs[i]).to(dev))
        if not (np.array_equal(routed[sid][0], p_v.cpu().numpy())
                and np.float32(routed[sid][1]) == np.float32(float(s_v))):
            raise SystemExit(f"FAIL mux into inflight: session {sid} != "
                             f"viterbi_vanilla")
    print(f"mux into inflight: {mux.stats['routed_inflight']} sessions "
          f"routed into the pool, {pool.stats['steps']} steps, launches "
          f"{ {n: v for n, v in mux_launches.items() if v} }; all == "
          f"viterbi_vanilla (bitwise)")
    return {n: launches[n] + mux_launches[n] for n in launches}


# ---------------------------------------------------------------------------
# 11: sharded decoding, the load test and the fault drills
# ---------------------------------------------------------------------------

TP_T, TP_MESH = 511, (2, 2)     # the paper's (T, K) = (511, 512); (data, model)
SHARD_RANKS = 4                 # ranks of phase 11's worlds, all on the card
#: readings a phase leaves for phase 18: 11a's one 2-D decode's launches
#: summed over the world, 17b's rank-0 timed step and peak
SEEN: dict = {}
# the load test at the serve deployment's width
LOAD = dict(states=SERVE_K, edge_prob=0.253, lengths=(128, 256, 511),
            buckets=SERVE_T, requests=32, max_batch=SERVE_B,
            stream_frac=0.25)


def tp_steps(T: int, P: int) -> int:
    """DP steps of one 2-D FLASH decode on a rank, one tropical launch each:
    the initial pass's Tp - 1 and every layer's s - 1."""
    from repro_torch.core import plan_padding
    Tp, _ = plan_padding(T, P)
    steps, s = Tp - 1, Tp // P
    while s >= 2:
        steps, s = steps + s - 1, s // 2
    return steps


def phase_tp_kernel(dev) -> float:
    """11: the tropical kernel with the argmax at the TP steps' shapes
    against its plain version, bitwise: row (1, M, K/2) x (1, K/2, K) and
    column (1, M, K) x (1, K, K/2) for M tiles of a layer, on normal and
    tie-heavy integer inputs.  Returns the max |value difference|."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.tropical import tropical_matmul_batch

    g = np.random.default_rng(19)
    kl = SERVE_K // TP_MESH[1]
    err = 0.0
    for layout, (k, j) in (("row", (kl, SERVE_K)), ("col", (SERVE_K, kl))):
        for M in (1, 2, 64, 127, 128, 255, 256):
            for kind, draw in (("normal", g.standard_normal),
                               ("integer", lambda s: g.integers(-3, 4, s))):
                a, b = (torch.from_numpy(draw(s).astype(np.float32)).to(dev)
                        for s in ((1, M, k), (1, k, j)))
                err = max(err, check_same(
                    f"tropical_matmul_batch TP {layout} {kind} (N,I,K,J)="
                    f"(1,{M},{k},{j})", tropical_matmul_batch(a, b),
                    ref.tropical_matmul_ref(a, b)))
    return err


def sharded_world(dev) -> dict:
    """11a-11c in one rank of a world of SHARD_RANKS on the card (gloo).

    A failed check raises in the rank that sees it, which fails the world.
    Launches are counted around the sharded calls only, in every rank, and
    summed over the world; rank 0 returns them with the lines to print."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import (NEG_INF, FlashBSSpec, FusedSpec,
                                  LexiconConstraint, ViterbiDecoder,
                                  erdos_renyi_hmm,
                                  left_to_right_hmm, random_emissions,
                                  viterbi_vanilla)
    from repro_torch.core.distributed import make_flash_viterbi_2d
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.serve import BUCKETS
    from repro_torch.serving import BatchScheduler, make_alignment_head

    rank = dist.get_rank()
    mesh2d = Mesh(TP_MESH, ("data", "model"))
    mesh4 = Mesh((SHARD_RANKS,), ("data",))
    total = {name: 0 for name in kernels.launch_counts()}
    lines = []

    def fail(what):
        raise SystemExit(f"FAIL rank {rank} {what}")

    # 11a: the 2-D decoder at the paper's default workload, both layouts;
    # on the serve's left-to-right model; and on an equal-weight
    # left-to-right model (self-loop 1/2, steps 1/4: log(1/4) is exactly
    # 2 log(1/2) in float32) with a uniform start and emissions in {0, 1},
    # whose paths tie across the two model shards: the row layout keeps the
    # highest tying shard, so the layouts' paths differ there
    g = np.random.default_rng(11)
    er = erdos_renyi_hmm(g, SERVE_K, 50, 0.253, device=dev)
    ltr = left_to_right_hmm(np.random.default_rng(0), SERVE_K, 64, device=dev)
    d = np.arange(SERVE_K)[None, :] - np.arange(SERVE_K)[:, None]
    ties = (torch.zeros(SERVE_K, device=dev), torch.from_numpy(np.where(
        d == 0, np.log(0.5), np.where((d == 1) | (d == 2), np.log(0.25),
                                      NEG_INF)).astype(np.float32)).to(dev))
    models = (("erdos-renyi", (er.log_pi, er.log_A),
               random_emissions(g, TP_T, SERVE_K, device=dev)),
              ("left-to-right", (ltr.log_pi, ltr.log_A), torch.from_numpy(
                  (2.0 * g.standard_normal((TP_T, SERVE_K))).astype(
                      np.float32)).to(dev)),
              ("tie-heavy", ties, torch.from_numpy(
                  np.random.default_rng(7).integers(0, 2, (TP_T, SERVE_K))
                  .astype(np.float32)).to(dev)))
    steps = tp_steps(TP_T, TP_MESH[0])
    cpu = torch.device("cpu")
    for model, (log_pi, log_A), em in models:
        p_v, s_v = viterbi_vanilla(log_pi, log_A, em)
        paths = {}
        for shard in ("row", "col"):
            dec = make_flash_viterbi_2d(mesh2d, TP_T, SERVE_K, shard=shard)
            dist.barrier()
            t0 = time.perf_counter()
            (path, score), counts = counted(total, dec, log_pi, log_A,
                                            em)
            wall = time.perf_counter() - t0
            n = counts["tropical_matmul_batch"]
            check_launches(f"rank {rank} 2-D {model} {shard}", counts,
                           dict(tropical_matmul_batch=steps))
            if score.cpu().numpy().tobytes() != s_v.cpu().numpy().tobytes():
                fail(f"2-D {model} {shard}: score {float(score)} != "
                     f"viterbi_vanilla's {float(s_v)}")
            if model == "erdos-renyi" and not torch.equal(path, p_v):
                fail(f"2-D {model} {shard}: path != viterbi_vanilla")
            if model != "erdos-renyi":
                p_c, s_c = dec(log_pi.to(cpu), log_A.to(cpu), em.to(cpu))
                if not (torch.equal(path.cpu(), p_c)
                        and float(s_c) == float(score)):
                    fail(f"2-D {model} {shard}: != the same decode on the "
                         f"CPU")
            paths[shard] = path
            if (model, shard) == ("erdos-renyi", "row"):
                one_decode = counts      # phase 18 (c) predicts these
            lines.append(f"2-D FLASH {model} (T,K)=({TP_T},{SERVE_K}) mesh "
                         f"(data,model)={TP_MESH} {shard}: {wall:.4f} s on "
                         f"the host clock (rank {rank}), {n} tropical "
                         f"launches a rank")
        differ = int((paths["row"] != paths["col"]).sum())
        if model == "erdos-renyi":
            if differ:
                fail("2-D erdos-renyi: row path != col path")
            lines.append("2-D FLASH erdos-renyi: both layouts' paths and "
                         "scores == viterbi_vanilla (bitwise)")
            continue
        if model == "tie-heavy" and not differ:
            fail("2-D tie-heavy: the layouts' paths are equal: the case no "
                 "longer reaches the row layout's tie rule")
        lines.append(f"2-D FLASH {model}: both layouts' scores == "
                     f"viterbi_vanilla, paths == the same decode on CPU "
                     f"tensors (bitwise); row and col paths differ in "
                     f"{differ} steps")

    # 11b: the serve deployment sharded over data = SHARD_RANKS, each bucket
    # against the unsharded decode of the same bucket
    cases = (("fused", FusedSpec()),
             ("flash_bs", FlashBSSpec(beam_width=128, parallelism=8,
                                      lanes=None)),
             ("fused lexicon", FusedSpec(constraint=LexiconConstraint(
                 LEXICON))))
    for what, spec in cases:
        dec = ViterbiDecoder(spec, ltr.log_pi, ltr.log_A, device=dev)
        buckets, launches, wall = [], dict.fromkeys(total, 0), 0.0

        def both(padded, lens, dec=dec, what=what):
            nonlocal wall
            dist.barrier()
            t0 = time.perf_counter()
            (ps, ss), counts = counted(total, dec.decode_sharded, padded,
                                       lens, mesh=mesh4)
            wall += time.perf_counter() - t0
            for name, n in counts.items():
                launches[name] += n
            buckets.append(padded.shape[1])
            p0, s0 = dec.decode_batch(padded, lens)
            if not (torch.equal(ps, p0) and torch.equal(ss, s0)):
                fail(f"sharded {what}: bucket {padded.shape} != unsharded")
            return ps, ss

        sched = BatchScheduler(both, max_batch=SERVE_B, buckets=BUCKETS)
        for em in serve_requests():
            sched.submit(em)
        if len(sched.drain()) != 32:
            fail(f"sharded {what}: not all 32 requests served")
        nb = len(buckets)
        want = (beam_launches(buckets) if what == "flash_bs" else
                dict(viterbi_fwd_batch=nb, viterbi_backtrack_batch=nb))
        check_launches(f"rank {rank} sharded {what}", launches, want)
        lines.append(f"sharded serve {what} ({type(spec).__name__}) over data="
                     f"{SHARD_RANKS}: 32 requests in {nb} buckets, all == "
                     f"the unsharded decode (bitwise), {wall:.4f} s on the "
                     f"host clock (rank {rank}), launches a rank "
                     f"{ {k: v for k, v in launches.items() if v} }")

    # 11c: the sharded alignment head on a bucket of 5 (padded to 8)
    reqs = serve_requests()[:5]
    lens = np.asarray([len(r) for r in reqs], np.int32)
    Tb = next(b for b in BUCKETS if b >= lens.max())
    padded = np.zeros((5, Tb, SERVE_K), np.float32)
    for i, r in enumerate(reqs):
        padded[i, :len(r)] = r
    head = make_alignment_head(ltr.log_pi, ltr.log_A, FusedSpec(), mesh=mesh4,
                               device=dev)
    (hp, hs), counts = counted(total, head, padded, lens)
    p0, s0 = head.decoder.decode_batch(padded, lens)
    if not (hp.shape == (5, Tb) and torch.equal(hp, p0)
            and torch.equal(hs, s0)):
        fail("sharded alignment head: bucket of 5 != the unsharded decode")
    lines.append(f"sharded alignment head: a bucket of 5 at T={Tb} over "
                 f"data={SHARD_RANKS} (padded with 3 dummies) == the "
                 f"unsharded decode (bitwise); launches a rank "
                 f"{ {k: v for k, v in counts.items() if v} }")

    names = sorted(total)
    summed = torch.tensor([[total[k] for k in names],
                           [one_decode[k] for k in names]], dtype=torch.int64)
    dist.all_reduce(summed)
    return {"launches": dict(zip(names, summed[0].tolist())),
            "decode_2d": dict(zip(names, summed[1].tolist())),
            "lines": lines}


def load_report_line(what: str, rep: dict, card: str) -> str:
    tp, lat = rep["throughput"], rep["latency_s"]

    def pct(key):
        p = lat[key]
        return "n/a" if p is None else f"p50 {p['p50']:.4f} p99 {p['p99']:.4f}"

    lag = rep["stream"]["commit_lag_frames"]
    return (f"loadtest {what}: {rep['requests']['delivered']}/"
            f"{rep['requests']['total']} delivered ({rep['requests']['stream']}"
            f" streamed), {tp['requests_per_s']:.2f} req/s, "
            f"{tp['frames_per_s']:.0f} frames/s over {tp['elapsed_s']:.4f} s; "
            f"offline latency s {pct('offline')}; stream finish s "
            f"{pct('stream_finish')}; feed s {pct('stream_feed')}; commit lag "
            f"frames p50 {lag['p50'] if lag else 'n/a'} p99 "
            f"{lag['p99'] if lag else 'n/a'} [{card}]")


def phase_sharded(dev, card: str) -> dict[str, int]:
    """11a-11c: sharded decoding in a world of SHARD_RANKS ranks sharing the
    card (gloo); returns the launches summed over the ranks."""
    from repro_torch.launch.mesh import run_spmd

    t0 = time.perf_counter()
    world = run_spmd(sharded_world, SHARD_RANKS, device=dev.type,
                     backend="gloo")
    for line in world["lines"]:
        print(f"{line} [{card}]")
    print(f"sharded world of {SHARD_RANKS} ranks: "
          f"{time.perf_counter() - t0:.1f} s wall, spawn included; launches "
          f"summed over ranks "
          f"{ {k: v for k, v in world['launches'].items() if v} }")
    SEEN["11a decode_2d"] = world["decode_2d"]
    return world["launches"]


def offline_launches(spec, buckets) -> dict[str, int]:
    """Kernel launches of offline batches of padded lengths `buckets` under
    `spec`: the fused forward and backtrack once a batch, FLASH-BS's beam
    passes (`beam_launches`), none for exact FLASH (its DP steps are tensor
    operations of the host loop, `core/flash.py`)."""
    n = len(buckets)
    if spec.method == "fused":
        return dict(viterbi_fwd_batch=n, viterbi_backtrack_batch=n)
    if spec.method == "flash_bs":
        lanes = spec.parallelism if spec.lanes == -1 else spec.lanes
        return beam_launches(buckets, spec.parallelism, lanes)
    if spec.method == "flash":
        return {}
    raise SystemExit(f"FAIL loadtest: no launch count for {spec!r}")


def stream_feeds(work, block: int) -> int:
    """Forward launches of the workload's exact streams through a mux of
    one `block`: one a whole block, one for the remainder at finish (no
    length here is 1 more than a multiple of the block)."""
    return sum(-(-len(work.payloads[rid]) // block)
               for rid, kind in work.kinds.items() if kind == "stream")


def phase_load(dev, card: str) -> dict[str, int]:
    """11d-11e: the load test at the serve deployment's width and the three
    fault drills at K = 512.

    Each load-test run is counted with its oracle off and its launches held
    to exactly the offline batches' and the streams' (`offline_launches`,
    `stream_feeds`); the oracle then runs outside the count.  Returns those
    launches.  The drills' launches are not counted: their oracles run
    inside them (and the rescale drill's in its ranks)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.launch import loadtest as lt

    t0 = time.perf_counter()
    total = {name: 0 for name in kernels.launch_counts()}

    # 11d: the load test at full width
    for what, kw in (("fused", dict(method="fused")),
                     ("flash_bs", dict(method="flash_bs")),
                     ("--budget-kb 32", dict(budget_kb=32.0)),
                     ("--budget-kb 1024", dict(budget_kb=1024.0))):
        cfg = lt.LoadConfig(**LOAD, **kw, check_oracle=False,
                            device=dev.type)
        harness = lt.LoadHarness(cfg)
        buckets, decode = [], harness.sched.fn

        def recorded(padded, lens, decode=decode, buckets=buckets):
            buckets.append(padded.shape[1])
            return decode(padded, lens)

        harness.sched.fn = recorded
        rep, launches = counted(total, harness.run)
        want = offline_launches(harness.spec, buckets)
        want["viterbi_fwd_batch"] = (want.get("viterbi_fwd_batch", 0)
                                     + stream_feeds(harness.work,
                                                    cfg.stream_block))
        check_launches(f"loadtest {what} {harness.spec!r}", launches, want)
        oracle = harness.oracle()
        r = rep["requests"]
        if not (r["delivered"] == r["total"] == LOAD["requests"]
                and r["duplicates"] == 0 and oracle["ok"]):
            raise SystemExit(f"FAIL loadtest {what}: {r}, oracle "
                             f"{oracle['offline']['mismatches'][:3]} "
                             f"{oracle['stream']['mismatches'][:3]}")
        print(load_report_line(f"{what} ({rep['spec']['type']})", rep, card))
        print(f"loadtest {what}: {len(buckets)} offline batches (buckets "
              f"{buckets}), launches exactly the batches' and the stream "
              f"feeds' { {k: v for k, v in launches.items() if v} }; oracle "
              f"ok (run after the count)")
    cfg = lt.LoadConfig(**LOAD, device=dev.type)
    rep = lt.run_inflight_compare(cfg)
    if not rep["oracle_ok"] or rep["retraces"] != 0:
        raise SystemExit(f"FAIL loadtest inflight compare: oracle "
                         f"{rep['oracle_ok']}, retraces {rep['retraces']}, "
                         f"slot steps {rep['inflight']['slot_step']}, "
                         f"launches {rep['inflight']['launches']}")
    feeds = stream_feeds(lt.make_workload(dataclasses.replace(
        cfg, stream_frac=1.0)), cfg.stream_block)
    check_launches("loadtest inflight compare, bucketed side",
                   rep["bucketed"]["launches"], {"viterbi_fwd_batch": feeds})
    for side in ("bucketed", "inflight"):
        for name, n in rep[side]["launches"].items():
            total[name] += n
    p99 = rep["p99_completion_s"]
    print(f"loadtest inflight compare: 32 streams, peak concurrency "
          f"{rep['peak_concurrent_sessions']}; p99 completion s bucketed "
          f"{p99['bucketed']:.4f} inflight {p99['inflight']:.4f}; feed s p50 "
          f"{rep['inflight']['feed_latency_s']['p50']:.4f} p99 "
          f"{rep['inflight']['feed_latency_s']['p99']:.4f}; bucketed "
          f"{feeds} forward launches (one a block feed), inflight one "
          f"slot-step launch a step and no other kernel "
          f"{rep['inflight']['slot_step']} (retraces 0); oracle ok [{card}]")

    # 11e: the three drills at K = 512
    drill_cfg = lt.LoadConfig(**{**LOAD, "requests": 16, "stream_frac": 0.0,
                                 "method": "fused", "device": dev.type})
    keys = ("detected_dead", "restored_from_step", "resubmitted",
            "downgraded", "under_budget", "probe_bit_identical",
            "delivered_before_rescale", "delivered", "duplicates")
    drills = (("worker_death kill batch 1",
               lambda: lt.drill_worker_death(drill_cfg, kill_batch=1)),
              ("worker_death kill batch 0",
               lambda: lt.drill_worker_death(drill_cfg, kill_batch=0)),
              # the serve's planner budgets: exact FLASH (P = 16) shrinks to
              # FLASH-BS (P = 1, beam 256)
              ("budget_shrink 1024 -> 32 KB", lambda: lt.drill_budget_shrink(
                  drill_cfg, big_kb=1024.0, small_kb=32.0)),
              ("mesh_rescale 4 -> 2",
               lambda: lt.drill_mesh_rescale(drill_cfg, from_devices=4,
                                             to_devices=2)))
    for what, run in drills:
        t1 = time.perf_counter()
        d = run()
        if not d["ok"]:
            raise SystemExit(f"FAIL drill {what}: {json.dumps(d, default=str)[:2000]}")
        print(f"drill {what}: ok in {time.perf_counter() - t1:.1f} s, "
              f"{ {k: d[k] for k in keys if k in d} } [{card}]")

    # the budget drill at its default rungs, 64 -> 2 KB (exact FLASH, P = 1,
    # to FLASH-BS, P = 1, beam 16): an open fault (ROADMAP Queue 3) makes
    # the narrow beam report a score that is not its path's, so the oracle
    # must flag the beam phase, with that mismatch and no other
    t1 = time.perf_counter()
    d = lt.drill_budget_shrink(drill_cfg)
    small, big = d["oracle"]["small"], d["oracle"]["big"]
    kinds = {m["what"] for m in small["mismatches"]}
    if not (not d["ok"] and kinds == {"reported_score_vs_path"}
            and big["ok"] and big["exact"] and d["downgraded"]
            and d["under_budget"] and d["delivered"] == d["expected"]
            and d["duplicates"] == 0):
        raise SystemExit(f"FAIL drill budget_shrink 64 -> 2 KB: expected "
                         f"the beam phase flagged by reported_score_vs_path "
                         f"alone, got {json.dumps(d, default=str)[:2000]}")
    print(f"drill budget_shrink 64 -> 2 KB (defaults; known fault, ROADMAP "
          f"Queue 3): flagged as expected in {time.perf_counter() - t1:.1f} "
          f"s, {d['plans']['small']['spec']}: "
          f"{len(small['mismatches'])} of {small['checked']} requests "
          f"reported_score_vs_path {small['mismatches']}; exact phase ok, "
          f"{ {k: d[k] for k in keys if k in d} } [{card}]")
    print(f"load test and drills: {time.perf_counter() - t0:.1f} s wall; "
          f"launches of the load-test runs (oracles outside the count; the "
          f"drills' not counted) { {k: v for k, v in total.items() if v} }")
    return total


#: phase 12: the e2e alignment step's batch, seed and parity batch
E2E_B, E2E_SEED, E2E_PARITY_B = 8, 0, 2
#: 12a: max / mean |emissions, card - CPU| at full width, 2 layers, float32
#: (float32 against float64 on the CPU reads 0.0095 / 4.6e-5 there: the
#: stacked init draws with 1/sqrt(2), so each product grows the ulps)
E2E_PARITY_TOL = (0.05, 1e-3)
#: 12b: max / mean |emissions, bf16 model - the same weights in float32|
#: on the card, 48 layers: 3.0132 / 0.4864 measured on an H100 (PERF.md
#: §5), the bounds 1.5x that.  JAX's init draws stacked layers with 1/sqrt(48), so
#: every product grows its input about 5x and bf16's rounding moves the
#: emissions far; the JAX package's own bf16 model moves as far from its
#: float32 one (tests/test_torch_models.py)
E2E_BF16_TOL = (4.5, 0.75)


def encoder_work(cfg, n_params: int, B: int, S: int):
    """(FLOPs of the bf16 products (projections, MLP, head), FLOPs of the
    float32 attention (scores and values), bytes) of one encoder forward
    and its emissions at (B, S): the `n_params` bf16 weights read once, the
    frames read and the emissions written once."""
    d, h, hk, hd, f, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.hd, cfg.d_ff, cfg.num_layers)
    mm = 2.0 * B * S * (L * (d * (h + 2 * hk) * hd + h * hd * d + 2 * d * f)
                        + d * cfg.vocab)
    attn = 2.0 * 2 * B * L * h * S * S * hd
    nbytes = 2 * n_params + 4 * B * S * d + 4 * B * S * cfg.vocab
    return mm, attn, nbytes


def median_ms(fn, runs: int = 7, warmup: int = 2) -> float:
    """Median over `runs` calls of one call's time between two CUDA events
    (host work between the call's launches included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_e2e(dev, card: str) -> dict[str, int]:
    """12: the end-to-end forced-alignment step (`make_e2e_align_step`):
    the hubert-xlarge encoder, log-softmax emissions over its 504 classes,
    then FLASH-BS (beam 128, P = 8) or `fused` over a left-to-right HMM of
    one state a class.  Returns the launches of the two steps' runs."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.paper_hmm import FORCED_ALIGNMENT
    from repro_torch import kernels
    from repro_torch.core import (HMM, FusedSpec, ViterbiDecoder,
                                  left_to_right_hmm, viterbi_vanilla)
    from repro_torch.models import build_model
    from repro_torch.serving import AlignmentConfig, make_e2e_align_step

    t0 = time.perf_counter()
    arch = get_arch("hubert_xlarge")
    C, S, B, d = (arch.NUM_CLASSES, FORCED_ALIGNMENT.seq_len, E2E_B,
                  arch.CONFIG.d_model)
    hmm = left_to_right_hmm(np.random.default_rng(E2E_SEED), C, 64,
                            device=dev)
    lp_cpu, la_cpu = hmm.log_pi.cpu(), hmm.log_A.cpu()

    # 12a: full width at 2 layers in float32, the same weights on the card
    # and on the CPU (TF32 is off)
    cfg2 = dataclasses.replace(arch.CONFIG, num_layers=2,
                               dtype=torch.float32)
    m_cpu = build_model(cfg2).init(torch.Generator().manual_seed(E2E_SEED),
                                   device="cpu")
    m_card = copy.deepcopy(m_cpu).to(dev)
    x = torch.from_numpy(np.random.default_rng(E2E_SEED + 1).standard_normal(
        (E2E_PARITY_B, S, d)).astype(np.float32))
    hmm_cpu = HMM(lp_cpu, la_cpu, hmm.log_B.cpu())
    em_c = make_e2e_align_step(m_cpu, hmm_cpu, FusedSpec(), C,
                               device="cpu").emissions({"embeds": x})
    em_g = make_e2e_align_step(m_card, hmm, FusedSpec(), C).emissions(
        {"embeds": x})
    err = (em_g.cpu() - em_c).abs()
    print(f"e2e 12a width parity: {cfg2.name} at 2 layers (d {d}, "
          f"{cfg2.num_heads} x {cfg2.hd} heads, d_ff {cfg2.d_ff}, vocab "
          f"{cfg2.vocab}), float32, (B, S) = ({E2E_PARITY_B}, {S}): "
          f"emissions card vs CPU max abs err {float(err.max()):.6g}, mean "
          f"{float(err.mean()):.6g} (bounds {E2E_PARITY_TOL}), max "
          f"|emission| {float(em_c.abs().max()):.4g}")
    if not (bool(torch.isfinite(em_g).all())
            and float(err.max()) <= E2E_PARITY_TOL[0]
            and float(err.mean()) <= E2E_PARITY_TOL[1]):
        raise SystemExit("FAIL e2e 12a: the card's emissions != the CPU's")
    del m_cpu, m_card, em_g

    # 12b: the whole model, 48 layers in bf16, drawn on the card
    cfg = arch.CONFIG
    gen = torch.Generator(device=dev).manual_seed(E2E_SEED)
    t1 = time.perf_counter()
    model = build_model(cfg).init(gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    embeds = torch.randn((B, S, d), generator=gen, device=dev)
    batch = {"embeds": embeds}
    allocated = torch.cuda.memory_allocated()
    n_params = model.param_count()
    print(f"e2e 12b: {cfg.name} {cfg.num_layers} layers, {cfg.dtype}, "
          f"{n_params} parameters drawn on the card in "
          f"{init_s:.2f} s ({allocated / 2**30:.3f} GiB allocated), (B, S) = "
          f"({B}, {S}), K = {C}")
    # Tp = 256 = P * 2^5 (core/flash.py's plan_padding, P = 8): one initial
    # pass, then the wavefront's layers of tiles of 32, 16, 8, 4 and 2
    # steps, one tile launch each (lanes=None)
    expected = {"flash_bs": beam_launches([S]),
                "fused": dict(viterbi_fwd_batch=1, viterbi_backtrack_batch=1)}
    if expected["flash_bs"] != dict(bs_initial_pass_batch=1,
                                    bs_segment_decode_batch=5):
        raise SystemExit(f"FAIL e2e: FLASH-BS launches at S = {S} derive "
                         f"as {expected['flash_bs']}")
    steps = {"flash_bs": make_e2e_align_step(model, hmm, AlignmentConfig(),
                                             C),
             "fused": make_e2e_align_step(model, hmm, FusedSpec(), C)}
    em = steps["fused"].emissions(batch)
    em_cpu = em.cpu()
    total = {name: 0 for name in kernels.launch_counts()}
    peaks = {}
    for what, step in steps.items():
        torch.cuda.reset_peak_memory_stats()
        (paths, scores), launches = counted(total, step, batch)
        peaks[what] = torch.cuda.max_memory_allocated()
        check_launches(f"e2e {what}", launches, expected[what])
        steps_ok = paths[:, 1:] - paths[:, :-1]
        if not (paths.shape == (B, S) and paths.dtype == torch.int32
                and int(paths.min()) >= 0 and int(paths.max()) < C
                and bool((steps_ok >= 0).all())
                and bool(torch.isfinite(scores).all())):
            raise SystemExit(f"FAIL e2e {what}: paths out of range, not "
                             f"monotone, or scores not finite")
        p2, s2 = step.decode(em)
        if not (torch.equal(paths, p2) and torch.equal(scores, s2)):
            raise SystemExit(f"FAIL e2e {what}: the step != its decode of "
                             f"the same emissions")
        if what == "flash_bs":
            p_c, s_c = ViterbiDecoder(step.decoder.spec, lp_cpu, la_cpu,
                                      device="cpu").decode_batch(em_cpu)
            oracle = "the plain FLASH-BS on the CPU"
        else:
            rows = [viterbi_vanilla(lp_cpu, la_cpu, e) for e in em_cpu]
            p_c = torch.stack([p for p, _ in rows])
            s_c = torch.stack([s for _, s in rows])
            oracle = "viterbi_vanilla on the CPU"
        if not (torch.equal(paths.cpu(), p_c) and torch.equal(scores.cpu(),
                                                               s_c)):
            raise SystemExit(f"FAIL e2e {what}: decode != {oracle}")
        print(f"e2e 12b {what} ({step.decoder.spec!r}): paths in [0, {C}) "
              f"and monotone, max state {int(paths.max())}; decode == "
              f"{oracle} (bitwise); launches exactly {launches_of(launches)}"
              f"; peak allocated {peaks[what] / 2**30:.3f} GiB")

    # 12b: the bf16 model against the same weights in float32 on the card
    m32 = model.cast(torch.float32)
    em32 = make_e2e_align_step(m32, hmm, FusedSpec(), C).emissions(batch)
    del m32
    diff = (em - em32).abs()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    diff_r = (steps["fused"].emissions(batch) - em32).abs()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"e2e 12b bf16 vs float32 weights on the card: emissions max abs "
          f"err {float(diff.max()):.6g}, mean {float(diff.mean()):.6g} "
          f"(bounds {E2E_BF16_TOL}; max |emission| "
          f"{float(em32.abs().max()):.4g}); with cuBLAS's reduced-precision "
          f"bf16 reductions allowed: max {float(diff_r.max()):.6g}, mean "
          f"{float(diff_r.mean()):.6g}")
    if not (bool(torch.isfinite(em).all())
            and float(diff.max()) <= E2E_BF16_TOL[0]
            and float(diff.mean()) <= E2E_BF16_TOL[1]):
        raise SystemExit("FAIL e2e 12b: bf16 emissions outside their bound")
    del em32, diff, diff_r
    torch.cuda.empty_cache()

    # 12c: times (CUDA events, warm, median of 7), the device's idle share
    # of a step under the profiler, peak memory
    mm, attn, nbytes = encoder_work(cfg, n_params, B, S)
    t_bf16 = mm / BF16_OPS_PER_S * 1e3
    t_typed = t_bf16 + attn / F32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    enc = median_ms(lambda: steps["fused"].emissions(batch))
    print(f"timing e2e encoder (emissions) (B, S) = ({B}, {S}): {enc:.4f} "
          f"ms; bound {max(t_typed, t_bytes):.4f} ms (operations: "
          f"{mm / 1e12:.4f} TFLOP of bf16 products at 989 TFLOP/s = "
          f"{t_bf16:.4f} ms, plus {attn / 1e12:.4f} TFLOP of float32 "
          f"attention at 67 TFLOP/s; bytes {nbytes / 1e9:.4f} GB = "
          f"{t_bytes:.4f} ms); {card}")
    # every timing before the first profiler trace: a step timed after a
    # trace runs slower (the steps are timed again after the traces below)
    rows = {what: (median_ms(lambda: step.decode(em)),
                   median_ms(lambda: step(batch)))
            for what, step in steps.items()}
    for what, (dec, whole) in rows.items():
        print(f"timing e2e {what}: decode {dec:.4f} ms, whole step "
              f"{whole:.4f} ms, {B * S / whole * 1e3:.1f} frames/s, peak "
              f"allocated {peaks[what] / 2**30:.3f} GiB (weights "
              f"{2 * n_params / 2**30:.3f} GiB, {allocated / 2**30:.3f} "
              f"GiB allocated before the first step); {card}")
    for what, step in steps.items():
        drain_device_share(lambda: (lambda: step(batch)),
                           f"e2e step {what}", card)
    print(f"timing e2e whole step after the profiler traces: "
          + ", ".join(f"{what} {median_ms(lambda: step(batch)):.4f} ms"
                      for what, step in steps.items()) + f"; {card}")
    print(f"e2e phase: {time.perf_counter() - t0:.1f} s wall; launches "
          f"{launches_of(total)}; {card}")
    del model, steps, em, embeds
    torch.cuda.empty_cache()
    return total


def launches_of(counts: dict[str, int]) -> dict[str, int]:
    return {k: v for k, v in counts.items() if v}


# ---------------------------------------------------------------------------
# 13: the analysis gate's card checks and the five Viterbi examples
# ---------------------------------------------------------------------------

#: the gate's report, under the checkout's ignored build directory
GATE_REPORT = Path(__file__).resolve().parent / "build" / "analysis" / \
    "report.json"
#: the memory contract's points: the gate's grid and the serve's (K, T)
GATE_EXTRA_MEMORY = ((SERVE_K, 511),)
EXAMPLES = ("torch_quickstart", "torch_batch_decode", "torch_adaptive_edge",
            "torch_streaming_decode", "torch_map_matching")


def phase_gate(dev, card: str) -> list[dict]:
    """13a: the analysis gate on the card (`repro_torch.analysis`): the
    Python mirror of the kernels' shared-memory arithmetic equal to the C
    entries at every K from 1 to 29 056, the resource check with the live
    ptxas log, the memory contracts at the gate's grid and (512, 511), the
    launch guard on one decode per spec, and the deep flashprove run
    (PV102 on the card); any unwaived finding fails.  Returns each kernel
    entry's resources at the serve's K."""
    from repro_torch.analysis import kernel_check as kc
    from repro_torch.analysis.contracts import MEMORY_GRID, check_contracts
    from repro_torch.analysis.prove import run_prove
    from repro_torch.analysis.retrace import LaunchError, check_launch_guard
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    log = "\n".join(build.build_logs().values())
    bad = kc.check_mirror(build.load("viterbi_dp"), build.load("beam_stream"),
                          range(1, 29057))
    if bad:
        raise SystemExit(f"FAIL gate: the Python mirror differs from the C "
                         f"entries at {len(bad)} point(s): {bad[:5]}")
    print(f"gate: the Python mirror of the shared-memory layouts == "
          f"viterbi_fwd_smem_bytes, beam_pass_smem_bytes and "
          f"viterbi_backtrack_plan at every K from 1 to 29056 "
          f"({time.perf_counter() - t0:.1f} s)")

    t1 = time.perf_counter()
    rep = check_contracts(device=dev,
                          memory_grid=MEMORY_GRID + GATE_EXTRA_MEMORY)
    for line in rep.waived:
        print(f"gate contract waived: {line}")
    if not rep.ok:
        raise SystemExit("FAIL gate contracts: " + "; ".join(rep.failures))
    ratios = ", ".join(f"{m} ({K}, {T}) {r:.4f}"
                       for (m, K, T), r in sorted(rep.memory_ratios.items()))
    print(f"gate contracts: {len(rep.checks)} passed, {len(rep.waived)} "
          f"waived; allocated / model on the card: {ratios}; "
          f"{time.perf_counter() - t1:.1f} s; {card}")

    t1 = time.perf_counter()
    try:
        passed = check_launch_guard(dev)
    except LaunchError as e:
        raise SystemExit(f"FAIL gate launch guard: {e}") from None
    print(f"gate launch guard: {'; '.join(passed)} "
          f"({time.perf_counter() - t1:.1f} s)")

    t1 = time.perf_counter()
    report = run_prove(dev, deep=True, ptxas_log=log)
    GATE_REPORT.parent.mkdir(parents=True, exist_ok=True)
    report.dump(GATE_REPORT)
    for f, reason in report.waived:
        print(f"gate prove waived: {f.code} {f.subject}")
    if not report.ok:
        raise SystemExit("FAIL gate prove: "
                         + "; ".join(str(f) for f in report.findings))
    peaks = ", ".join(f"{s.split(':', 2)[2]} {v['ratio']}"
                      for s, v in report.stats.items()
                      if s.startswith("dispatch:") and "ratio" in v)
    print(f"gate prove[deep, cuda]: {len(report.checks)} entries, 0 active "
          f"findings, {len(report.waived)} waived, skipped "
          f"{report.skipped}; peak live / model: {peaks}; report "
          f"{GATE_REPORT}; {time.perf_counter() - t1:.1f} s")

    resources = []
    for name, r in kc.harvest_kernels(log).items():
        if r["spill_bytes"] != 0 or r["registers"] is None:
            raise SystemExit(f"FAIL gate resources: {name} {r}")
        resources.append(dict(name=name, K=r["K"], instance=r["instance"],
                              registers=r["registers"],
                              spill_bytes=r["spill_bytes"],
                              smem_bytes=r["smem_bytes"], card=card))
    print(f"gate phase: {time.perf_counter() - t0:.1f} s wall")
    return resources


def load_example(name: str):
    """The checkout's examples/<name>.py as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def held_equal(what: str, card, cpu) -> None:
    """Paths (arrays) and scores (floats) of a card run bitwise the CPU's."""
    for i, (a, b) in enumerate(zip(card, cpu)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.tobytes() != b.tobytes():
            raise SystemExit(f"FAIL example {what}: output {i} on the card "
                             f"!= the CPU's")


def phase_examples(dev, card: str) -> dict[str, int]:
    """13b: each Viterbi example at its defaults on the card (its main,
    launches counted), every path bitwise the same example's on the CPU
    (FLASH-BS's path and score too, as phase 8 holds them)."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    total = {name: 0 for name in kernels.launch_counts()}
    for name in EXAMPLES:
        ex = load_example(name)
        kernels.reset_launches()
        out = ex.main(["--device", "cuda"])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        for k, n in launches.items():
            total[k] += n
        if name == "torch_quickstart":
            K, T = 512, 512
            pi, A, em = ex.make_model(0, K, T, cpu)
            for spec in ex.SPECS:
                p, s = ex.decode(spec, pi, A, em, cpu)
                held_equal(f"{name} {ex.spec_name(spec)}",
                           out["results"][ex.spec_name(spec)],
                           (p.numpy(), float(s)))
        elif name == "torch_batch_decode":
            pi, A, em, lengths = ex.make_model(0, cpu)
            p, s = ex.decode_batch(pi, A, em, lengths)
            held_equal(name, (out["paths"], out["scores"]),
                       (p.numpy(), s.numpy()))
            if not (out["looped_equal"] and out["served_equal"]):
                raise SystemExit(f"FAIL example {name}: {out}")
        elif name == "torch_adaptive_edge":
            K, T = 512, 512
            pi, A, em = ex.make_model(0, K, T, cpu)
            p, s = ex.decode(out["plan"].spec, pi, A, em, cpu)
            held_equal(name, (out["path"], out["score"]),
                       (p.numpy(), float(s)))
        elif name == "torch_streaming_decode":
            pi, A, em = ex.make_model(0, cpu)
            p, s, _ = ex.stream_exact(pi, A, em, cpu, report=lambda line: 0)
            (p1, s1), (p2, s2) = ex.mux_two(pi, A, em, cpu)
            held_equal(name, (out["path"], out["score"]), (p, s))
            held_equal(f"{name} beam 16", out["beam"], (p2, s2))
        else:
            pi, A, em, _, band = ex.make_model(7, cpu)
            p1, s1 = ex.decode_single(band, pi, A, em[0], cpu)
            pb, sb = ex.decode_batch(band, pi, A, em, ex.LENGTHS, cpu)
            p3, s3, _ = ex.decode_stream(band, pi, A, em[0], cpu)
            held_equal(f"{name} single", out["single"],
                       (p1.numpy(), float(s1)))
            held_equal(f"{name} batch", out["batch"],
                       (pb.numpy(), sb.numpy()))
            held_equal(f"{name} stream", out["stream"], (p3, float(s3)))
        print(f"example {name}: card == CPU (bitwise); launches "
              f"{launches_of(launches)}")
    print(f"examples phase: {time.perf_counter() - t0:.1f} s wall; {card}")
    return total


def phase_timing(dev, card: str) -> dict[str, dict]:
    from repro_torch.core import left_to_right_hmm
    from repro_torch.kernels import ref
    from repro_torch.kernels import viterbi_dp as vdp

    g = np.random.default_rng(2)
    B, K = SERVE_B, SERVE_K
    hmm = left_to_right_hmm(g, K, 64, device=dev)
    rows = {}
    for T_req in SERVE_T:
        T = T_req - 1                                  # forward steps
        em_full = torch.from_numpy(
            (2.0 * g.standard_normal((B, T_req, K))).astype(np.float32)).to(dev)
        delta0 = hmm.log_pi[None, :] + em_full[:, 0, :]
        em = em_full[:, 1:]
        pad = pad_of([T] * B, T, dev)
        mask = pad > 0.5
        psi, dT = vdp.viterbi_forward_batch(hmm.log_A, em, delta0, pad)
        ms = cuda_ms(lambda: vdp.viterbi_forward_batch(
            hmm.log_A, em, delta0, pad), reps=10)
        plain = cuda_ms(lambda: ref.viterbi_forward_masked_ref(
            hmm.log_A, em, delta0, mask), reps=3)
        bms, by = fwd_bound(B, T, K, B * T)
        print(f"timing viterbi_fwd_batch (B,T,K)=({B},{T},{K}): kernel "
              f"{ms:.4f} ms, {1e3 * ms / T:.4f} us per DP step, "
              f"{forward_layout(vdp, K)}, plain {plain:.4f} ms, bound "
              f"{bms:.6f} ms ({by}); {card}")
        rows["viterbi_fwd_batch"] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                         bound_by=by)
        rows["viterbi_backtrack_batch"] = time_backtrack(
            vdp, ref, psi, dT, "forward psi, serve model", card)
    # the backtrack at the other shapes its callers give it, on random-state
    # psi: more sequences than clusters (psi 42 MB: mostly out of L2), map
    # matching's window, assoc's table
    for shape in ((40, 511, 512), (1, 511, 193), (1, 4095, 64)):
        psi, dT = random_psi(g, dev, *shape)
        time_backtrack(vdp, ref, psi, dT, "random-state psi", card)
    del psi, dT

    # the masked kernel: the lexicon serve shape with both masks (kept for
    # the kernels line), then the map-matching batch with the band's smask
    from repro_torch.core import compiled_penalties
    from repro_torch.kernels.ops import band_windows
    T = SERVE_T[-1] - 1
    log_A, tmask, em, smask, delta0 = lexicon_problem(dev, g, B, T)
    log_pi_g, log_A_g, em_g, _, band = grid_problem(dev)
    Kg = log_A_g.shape[0]
    s_pen = torch.from_numpy(compiled_penalties(band, Kg, GRID_T)[2]).to(dev)
    delta0_g = log_pi_g[None, :] + (em_g[:, 0] + s_pen[0])
    masked = [(log_A, em, delta0, tmask, smask, "tmask+smask"),
              (log_A_g, em_g[:, 1:], delta0_g, None, s_pen[1:], "smask")]
    for i, (A, e, d0, tm, sm, what) in enumerate(masked):
        B, T, Km = e.shape
        pad = pad_of([T] * B, T, dev)
        mask = pad > 0.5
        ms = cuda_ms(lambda: vdp.viterbi_forward_batch_masked(
            A, e, d0, pad, tm, sm), reps=5)
        plain = cuda_ms(lambda: ref.viterbi_forward_masked_pen_ref(
            A, e, d0, mask, tm, sm), reps=2, warmup=1)
        bms, by = masked_bound(B, T, Km, tm is not None, sm is not None,
                               B * T)
        print(f"timing viterbi_fwd_batch_masked {what} (B,T,K)=({B},{T},"
              f"{Km}): kernel {ms:.4f} ms, {1e3 * ms / T:.4f} us per DP "
              f"step, {forward_layout(vdp, Km)}, plain {plain:.4f} ms, bound "
              f"{bms:.6f} ms ({by}); {card}")
        if i == 0:
            rows["viterbi_fwd_batch_masked"] = dict(
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)

    # the banded kernel on the map-matching grid at the band's width (Kb =
    # 193, the mbarrier exchange: the map-matching decode's launch, kept for
    # the kernels line) and at Kb = 17 (CTAs without columns: a cluster
    # barrier a step)
    e0 = em_g[0]
    for width, exchange in ((band.width, "mbarrier exchange"),
                            (8, "cluster barrier a step")):
        c, starts = (x.to(dev) for x in band_windows(band.centers, Kg, width))
        Kb = min(2 * width + 1, Kg)
        plain = cuda_ms(lambda: ref.viterbi_banded_forward_ref(
            log_A_g, log_pi_g, e0, c, starts, width), reps=2, warmup=1)
        bms, by = banded_bound(Kg, starts, Kb)
        ms = cuda_ms(lambda: vdp.viterbi_banded_forward(
            log_A_g, log_pi_g, e0, c, starts, width), reps=10)
        print(f"timing viterbi_banded_fwd (T,K,Kb)=({GRID_T},{Kg},{Kb}), "
              f"{exchange}: kernel {ms:.4f} ms, "
              f"{1e3 * ms / (GRID_T - 1):.4f} us per DP step, plain "
              f"{plain:.4f} ms, bound {bms:.6f} ms ({by}); {card}")
        if width == band.width:
            rows["viterbi_banded_fwd"] = dict(ms=ms, plain_ms=plain,
                                              bound_ms=bms, bound_by=by)
    print("timing viterbi_banded_fwd: each DP step depends on the one before "
          "(the exchange of delta among the cluster's CTAs), so the serial "
          "step latency, not the bytes or operations bound, sets its floor")

    # the beam kernel at the FLASH-BS serve's widths: the initial pass of a
    # batch (8 beams) and the last layer of a 512 bucket (2048 beams); the
    # kernels line keeps the last layer
    from repro_torch.kernels.beam_stream import beam_step_batch
    from repro_torch.kernels.tropical import tropical_matmul_batch
    for N in (8, 2048):
        A, e, sc, st = beam_case(dev, g, N, SERVE_K, 128)
        ms = cuda_ms(lambda: beam_step_batch(A, e, sc, st, 128), reps=20)
        plain = cuda_ms(lambda: ref.beam_transition_ref(A, e, sc, st, 128),
                        reps=3)
        bms, by = beam_bound(A, sc, st, 128)
        print(f"timing beam_step_batch (N,K,B,chunk)=({N},{SERVE_K},128,128):"
              f" kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.6f} ms "
              f"({by}); {card}")
        rows["beam_step_batch"] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                       bound_by=by)
    # the two passes at the serve's shapes (a 512 bucket of 8 sequences, no
    # pad steps): the initial pass and the first and last layers' tile
    # launches; the kernels line keeps the initial pass and the first layer
    from repro_torch.kernels.beam_stream import (bs_initial_pass_batch,
                                                 bs_segment_decode_batch)
    lp, A, em, pad = pass_problem(dev, g, SERVE_K, SERVE_B, 512)
    bnd = (np.arange(1, 8) * 64 - 1).astype(np.int64)
    N, T, K, B = SERVE_B, 512, SERVE_K, 128
    ms = cuda_ms(lambda: bs_initial_pass_batch(lp, A, em, pad, bnd, B),
                 reps=5)
    plain = cuda_ms(lambda: ref.bs_initial_pass_ref(lp, A, em, pad, bnd, B,
                                                    128), reps=1, warmup=1)
    bms, by = pass_bound(N, T, K, B, out_words=N * (len(bnd) + 2))
    print(f"timing bs_initial_pass_batch (N,Tp,K,B,P)=({N},{T},{K},{B},8): "
          f"kernel {ms:.4f} ms per launch, {ms / (T - 1):.6f} ms per DP "
          f"step, plain {plain:.4f} ms, bound {bms:.6f} ms ({by}); {card}")
    rows["bs_initial_pass_batch"] = dict(ms=ms, plain_ms=plain, bound_ms=bms,
                                         bound_by=by)
    for s_len in (64, 2):
        tiles = tiles_of(dev, g, em, pad, s_len, K)
        M = tiles[0].shape[0]
        ms = cuda_ms(lambda: bs_segment_decode_batch(lp, A, *tiles, B),
                     reps=10)
        plain = cuda_ms(lambda: ref.bs_segment_decode_ref(lp, A, *tiles, B,
                                                          128),
                        reps=1, warmup=1)
        bms, by = pass_bound(M, s_len, K, B, out_words=M, extra_bytes=17 * M)
        print(f"timing bs_segment_decode_batch (M,s,K,B)=({M},{s_len},{K},"
              f"{B}): kernel {ms:.4f} ms per launch, "
              f"{ms / (s_len - 1):.6f} ms per DP step, plain {plain:.4f} ms, "
              f"bound {bms:.6f} ms ({by}); {card}")
        if s_len == 64:
            rows["bs_segment_decode_batch"] = dict(ms=ms, plain_ms=plain,
                                                   bound_ms=bms, bound_by=by)
    print("timing beam passes: each DP step depends on the one before (two "
          "cluster barriers and a selection over K), so the serial step "
          "latency, not the bytes or operations bound, sets their floor")

    # the tropical kernel, with the argmax and values-only: levels of the
    # assoc scan at K = 64 and one K = 512 product, by back-to-back CUDA
    # events (as earlier rows were timed) and by CUDA-graph replay (device
    # time); the kernels line keeps the values-only (the assoc scan's) at N
    # = 256, device time
    for N, K in ((1, 64), (255, 64), (256, 64), (2047, 64), (1, 512)):
        a, b = (torch.from_numpy(g.standard_normal((N, K, K)).astype(
            np.float32)).to(dev) for _ in range(2))
        plain = cuda_ms(lambda: ref.tropical_matmul_ref(a, b), reps=3)
        for with_args in (True, False):
            ms = cuda_ms(lambda: tropical_matmul_batch(a, b, with_args),
                         reps=20)
            dms = graph_ms(lambda: tropical_matmul_batch(a, b, with_args), 20)
            bms, by = tropical_bound(a, b, with_args)
            print(f"timing tropical_matmul_batch (N,I,K,J)=({N},{K},{K},{K})"
                  f"{'' if with_args else ' values-only'}: kernel {dms:.4f} "
                  f"ms device time ({ms:.4f} ms by back-to-back events), "
                  f"plain {plain:.4f} ms, bound {bms:.6f} ms ({by}); {card}")
            if (N, with_args) == (256, False):
                rows["tropical_matmul_batch"] = dict(
                    ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by)
    # one assoc decode at (T, K) = (4096, 64): its 22 values-only tropical
    # launches (the levels' shapes replayed in one graph), the argmax launch
    # of its backtrack's table (replayed), the decode's own tropical and
    # backtrack launches under the profiler, and the whole decode on the
    # host clock
    from repro_torch.analysis.retrace import scan_levels
    from repro_torch.core import AssocSpec, erdos_renyi_hmm, random_emissions
    levels = scan_levels(4095)
    pairs = [tuple(torch.from_numpy(g.standard_normal((n, 64, 64)).astype(
        np.float32)).to(dev) for _ in range(2)) for n in levels]
    total = graph_ms(lambda: [tropical_matmul_batch(a, b, False)
                              for a, b in pairs], 1)
    bound = sum(tropical_bound(a, b, False)[0] for a, b in pairs)
    a, b = (torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(
        dev) for shape in ((1, 4095, 64), (1, 64, 64)))
    table = graph_ms(lambda: tropical_matmul_batch(a, b), 20)
    table_bound = tropical_bound(a, b)[0]
    hmm_a = erdos_renyi_hmm(g, 64, 50, 0.253, device=dev)
    em_a = random_emissions(g, 4096, 64, device=dev)
    traced = ["not measured" if x is None else f"{x:.4f} ms"
              for x in profiled_ms(lambda: AssocSpec().run(
                  hmm_a.log_pi, hmm_a.log_A, em_a), "tropical", "backtrack")]
    print(f"timing assoc (T,K)=(4096,64): its {len(levels)} values-only "
          f"tropical launches ({sum(levels)} products of 64 x 64 x 64) take "
          f"{total:.4f} ms of device time replayed (bound {bound:.6f} ms), "
          f"its backtrack table (the argmax instance at (1,4095,64,64)) "
          f"{table:.4f} ms replayed (bound {table_bound:.6f} ms); under the "
          f"profiler in a decode its {len(levels) + 1} tropical launches "
          f"{traced[0]}, its backtrack launch {traced[1]}; {card}")
    del pairs, a, b
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        AssocSpec().run(hmm_a.log_pi, hmm_a.log_A, em_a)
        torch.cuda.synchronize()
        print(f"timing assoc decode (T,K)=(4096,64) {rep + 1}: "
              f"{time.perf_counter() - t0:.4f} s on the host clock; {card}")

    # the FLASH-BS serve's drain of the 32 default requests, host clock
    from repro_torch import kernels
    from repro_torch.serving import (AlignmentConfig, BatchScheduler,
                                     make_alignment_head)
    from repro_torch.launch.serve import BUCKETS
    hmm0 = left_to_right_hmm(np.random.default_rng(0), SERVE_K, 64,
                             device=dev)
    for method in ("flash_bs", "fused"):
        head = make_alignment_head(hmm0.log_pi, hmm0.log_A,
                                   AlignmentConfig(method=method))
        for rep in range(2):
            sched = BatchScheduler(head, max_batch=SERVE_B, buckets=BUCKETS)
            for em_r in serve_requests():
                sched.submit(em_r)
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sched.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {n: v for n, v in kernels.launch_counts().items() if v}
            print(f"timing {method} serve drain {rep + 1}: 32 requests in "
                  f"{wall:.4f} s on the host clock ({32 / wall:.1f} req/s), "
                  f"launches {counts}; {card}")
        drain_device_share(lambda: batch_drain(head), method, card)
    return rows   # fwd and backtrack at T = 511; masked with both masks


def batch_drain(head):
    """A `BatchScheduler` over `head` with the 32 serve requests submitted;
    returns its drain."""
    from repro_torch.launch.serve import BUCKETS
    from repro_torch.serving import BatchScheduler
    sched = BatchScheduler(head, max_batch=SERVE_B, buckets=BUCKETS)
    for em_r in serve_requests():
        sched.submit(em_r)
    return sched.drain


def phase_stream_timing(dev, card: str) -> dict[str, dict]:
    """3, continued: the beam kernel's chunk mode and the inflight slot step
    by CUDA events (and graph replay), the three streaming drains and the
    inflight drain on the host clock, twice each, and once each under
    `torch.profiler`."""
    from repro_torch import kernels
    from repro_torch.core import left_to_right_hmm
    from repro_torch.kernels import ref
    from repro_torch.kernels.beam_stream import bs_chunk_batch
    from repro_torch.kernels import viterbi_dp as vdp
    from repro_torch.serving import StreamConfig

    g = np.random.default_rng(13)
    K, B, C = SERVE_K, 128, 64
    hmm = left_to_right_hmm(np.random.default_rng(0), K, 64, device=dev)
    lp, A = hmm.log_pi, hmm.log_A
    rows = {}
    for N in (1, 8):
        em = torch.from_numpy((2.0 * g.standard_normal((N, C, K))).astype(
            np.float32)).to(dev)
        first = torch.ones((N,), dtype=torch.bool, device=dev)
        sc, st, _, _ = bs_chunk_batch(lp, A, em, torch.zeros((N, B),
                                                             device=dev),
                                      torch.zeros((N, B), dtype=torch.int32,
                                                  device=dev), first, B, 128)
        for what, fl in (("seeding", first), ("carried", ~first)):
            args = (lp, A, em, sc, st, fl, B, 128)
            ms = cuda_ms(lambda: bs_chunk_batch(*args), reps=20)
            dms = graph_ms(lambda: bs_chunk_batch(*args), 10)
            plain = cuda_ms(lambda: ref.beam_chunk_ref(*args), reps=1,
                            warmup=1)
            n_first = int(fl.sum())
            bms, by = chunk_bound(N, C, K, B, n_first)
            steps = C - (1 if what == "seeding" else 0)
            print(f"timing bs_chunk_batch (N,C,K,B)=({N},{C},{K},{B}) {what}:"
                  f" kernel {ms:.4f} ms per launch ({dms:.4f} ms device time"
                  f" replayed), {ms / steps:.6f} ms per DP step, plain "
                  f"{plain:.4f} ms, bound {bms:.6f} ms ({by}); {card}")
            if (N, what) == (1, "carried"):
                rows["bs_chunk_batch"] = dict(ms=ms, plain_ms=plain,
                                              bound_ms=bms, bound_by=by)
    print("timing bs_chunk_batch: each row's transition depends on the one "
          "before (two cluster barriers and a selection over K), so the "
          "serial step latency, not the bytes or operations bound, sets its "
          "floor")

    # the inflight slot step at (64, 16, 512): a full pool and a mixed one
    S, blk = 64, 16
    em = torch.from_numpy((2.0 * g.standard_normal((S, blk, K))).astype(
        np.float32)).to(dev)
    delta = (lp[None] + em[:, 0]).contiguous()
    for what, nfeed in (("every nfeed 16", np.full(S, 16)),
                        ("nfeed drawn from 0..16", g.integers(0, 17, S))):
        pad = pad_of(nfeed, blk, dev)
        ms = cuda_ms(lambda: vdp.viterbi_forward_batch(A, em, delta, pad),
                     reps=20)
        dms = graph_ms(lambda: vdp.viterbi_forward_batch(A, em, delta, pad),
                       20)
        plain = cuda_ms(lambda: ref.viterbi_forward_masked_ref(
            A, em, delta, pad > 0.5), reps=3)
        bms, by = fwd_bound(S, blk, K, int(nfeed.sum()))
        print(f"timing slot step viterbi_fwd_batch (S,block,K)=({S},{blk},"
              f"{K}) {what}: kernel {dms:.4f} ms device time replayed "
              f"({ms:.4f} ms by back-to-back events), {1e3 * dms / blk:.4f} "
              f"us per DP step, plain {plain:.4f} ms, bound {bms:.6f} ms "
              f"({by}); {card}")

    # the drains on the host clock, twice each, then once under the profiler
    reqs = serve_requests()
    for what, kw in STREAM_CONFIGS:
        cfg = StreamConfig(**kw)
        for rep in range(2):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream_drain(dev, lp, A, cfg, reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {n: v for n, v in kernels.launch_counts().items() if v}
            print(f"timing streaming {what} drain {rep + 1}: 32 requests in "
                  f"{wall:.4f} s on the host clock ({32 / wall:.1f} req/s), "
                  f"launches {counts}; {card}")
        drain_device_share(
            lambda: (lambda: stream_drain(dev, lp, A, cfg, reqs)),
            f"streaming {what}", card)
    for rep in range(2):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched, _, _ = inflight_drain(dev, lp, A, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep_ = sched.slo_report()
        print(f"timing inflight drain {rep + 1}: 32 requests in {wall:.4f} s "
              f"on the host clock ({32 / wall:.1f} req/s), "
              f"{sched.stats['steps']} steps, launches "
              f"{ {n: v for n, v in kernels.launch_counts().items() if v} }, "
              f"block latency p50 {rep_['block_latency_s']['p50'] * 1e3:.4f}"
              f" ms p99 {rep_['block_latency_s']['p99'] * 1e3:.4f} ms, "
              f"commit lag peak p50 {rep_['commit_lag']['peak_p50']} p99 "
              f"{rep_['commit_lag']['peak_p99']}, forced flushes "
              f"{rep_['commit_lag']['forced_flushes']}; {card}")
    drain_device_share(lambda: (lambda: inflight_drain(dev, lp, A, reqs)),
                       "inflight", card)
    return rows


def time_backtrack(vdp, ref, psi, dT, what: str, card: str) -> dict:
    """Device time of the backtrack by CUDA-graph replay (20 launches back
    to back on one psi, which stays in L2 where it fits, as on the decode
    path, where the forward launch has just written it), and by back-to-back
    CUDA events; the plain version by events.  Prints and returns the
    kernels-line entry."""
    B, T, K = psi.shape
    ms = graph_ms(lambda: vdp.viterbi_backtrack_batch(psi, dT), 20)
    ems = cuda_ms(lambda: vdp.viterbi_backtrack_batch(psi, dT), reps=20)
    plain = cuda_ms(lambda: ref.viterbi_backtrack_ref(psi, dT), reps=3)
    bms, by = backtrack_bound(B, T, K)
    print(f"timing viterbi_backtrack_batch (B,T,K)=({B},{T},{K}) {what}, "
          f"{backtrack_layout(vdp, T, K)}: kernel {ms:.4f} ms device time "
          f"({ems:.4f} ms by back-to-back events), plain {plain:.4f} ms, "
          f"bound {bms:.7f} ms ({by}); {card}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


def drain_device_share(prepare, what: str, card: str, top: int = 0) -> None:
    """One drain under `torch.profiler`: `prepare()` sets it up and returns
    it, untimed.  Prints the device time of its kernels and copies and the
    share of the drain's wall time (host clock, under the profiler) in which
    the device ran nothing, and with `top` the kernels (by name, cut to 60
    characters) that took the most device time.  The profiler records the device's activity
    alone (no host op events, which nothing here reads: they stretch a
    host-bound drain, and an xLSTM prefill's 309 000 launches would take
    the trace about two minutes to parse); a CPU rehearsal, with no device,
    records the host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    drain = prepare()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA if torch.cuda.is_available()
                  else ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"{what} drain device share: not measured (the profiler "
              f"recorded no device events); {card}")
        return
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:          # the union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = [b - a for a, b, name in spans
               if not name.startswith(("Memcpy", "Memset"))]
    print(f"{what} drain device share: wall {wall_us / 1e3:.3f} ms under the "
          f"profiler, device busy {busy / 1e3:.3f} ms ({len(spans)} device "
          f"events; {len(kernels)} kernel launches, "
          f"{sum(kernels) / 1e3:.3f} ms), device idle "
          f"{1 - busy / wall_us:.4f} of the wall time; {card}")
    if top:
        by_name: dict[str, list[float]] = {}
        for a, b, name in spans:
            by_name.setdefault(name[:60], []).append(b - a)
        ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
        print(f"{what} top {top} kernels by device time: " + "; ".join(
            f"{name} {sum(us) / 1e3:.3f} ms in {len(us)}"
            for name, us in ranked) + f"; {card}")


# ---------------------------------------------------------------------------
# 14: causal-LM serving of the transformer family
# ---------------------------------------------------------------------------

#: the six causal LMs, in ROADMAP's order (dense GQA / MQA / window, MoE, MLA)
LM_IDS = ("tinyllama_1_1b", "granite_8b", "gemma_2b", "h2o_danube_3_4b",
          "moonshot_v1_16b_a3b", "deepseek_v2_236b")
LM_SEED = 0
#: 14a: layers at full width in float32 (2; 1 for the MoE configs, whose
#: float32 layer and embeddings take about 5 and 20 GB on each side)
LM_PARITY_LAYERS = dict(moonshot_v1_16b_a3b=1, deepseek_v2_236b=1)
#: 14a: (B, S) of the prompts, max_len, greedy decode steps
LM_PARITY = (2, 64, 128, 4)
#: 14a: max |logits, card - CPU| / max |logit| over the prefill and the
#: decode steps, float32 (TF32 off): 1.5x the largest of the six measured
#: on an H100 (1.7663e-4, danube; PERF.md §5)
LM_F32_TOL = 2.65e-4
#: 14a: max |first decode step's logits - the last-position logits of a
#: prefill over all S + 1 tokens| / max |logit|, float32 on the card: 1.5x
#: the largest of the six measured on an H100 (8.431e-5, granite)
LM_F32_TF_TOL = 1.27e-4
#: 14b / 14c: prompt length and max_len; (batch, decode steps) a config
LM_PROMPT, LM_MAX_LEN = 511, 1024
LM_SERVE = dict(granite_8b=(8, 64))
LM_SERVE_DEFAULT = (4, 16)
#: 14c / 15d: the depth cuts (the full models do not fit one card:
#: moonshot's 48 layers would be 56 GB in bf16 plus a 35 GB float32 draw of
#: its wg leaf, deepseek-v2's 60 layers 479 GB).  llava-next-34b's 60
#: layers are 68.8 GB in bf16; the init draws each stacked leaf in float32
#: beside everything drawn before it, so its peak (`init_peak_bytes`) is
#: 0.917 + 1.703 L GB at L layers: 72.22 GiB at 45 layers, as measured on
#: an H100 (PERF.md §4).  At 47 (75.4 GiB modeled) the init ran out of the
#: card's 79.18 GiB, 3.21 GiB of it cached by the allocator in blocks too
#: small for the last 12.85 GiB cast; 45 leaves about 3 GiB beside that
LM_DEPTH = dict(moonshot_v1_16b_a3b=16, deepseek_v2_236b=2,
                llava_next_34b=45)
#: 14b / 14c: max |first decode step's logits - the last-position logits
#: of a prefill over all 512 tokens| / max |logit|, bf16: 1.5x each
#: config's measured on an H100 (PERF.md §5).  JAX's init draws stacked
#: layers with 1/sqrt(L), so activations grow through the stack and bf16's
#: rounding of a (B, 1) step and a (B, 512) prefill moves the logits
#: (0.026-0.088); in moonshot's 16 MoE layers it also flips router
#: choices between near-equal experts (0.71)
LM_BF16_TOL = dict(granite_8b=0.132, tinyllama_1_1b=0.0743,
                   gemma_2b=0.0386, h2o_danube_3_4b=0.0776,
                   moonshot_v1_16b_a3b=1.063, deepseek_v2_236b=0.0921)
#: 14d: danube's ring: batch, first prefill, single-token steps, then
#: greedy steps from each cache
LM_RING = (2, 4096, 1024, 16)
#: 14d: max |diff| / max |logit| of the wrapped ring's last step against
#: the rolled prefill, and of the greedy steps from the two caches,
#: float32: 1.5x the measured 3.7875e-6 and 1.7557e-3 on an H100 (the
#: 1/sqrt(2)-scaled init saturates the softmax, so the two caches'
#: rounding moves later steps more; PERF.md §5)
LM_RING_TOL = (5.7e-6, 2.64e-3)


def copy_to(model, device):
    """A copy of `model` with every weight on `device`."""
    from repro_torch.models import build_model

    def conv(t):
        return ([conv(v) for v in t] if isinstance(t, list) else
                {k: conv(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().to(device))
    return build_model(model.cfg).load(conv(model.tree()))


def greedy(model, batch: dict, max_len: int, steps: int,
           timed: bool = False):
    """Prefill `batch` (its tokens (B, S), and llava's image embeddings),
    then `steps` greedy decode steps: (the prefill's and each step's logits
    (B, 1 + steps, vocab), the greedy tokens (B, 1 + steps), the cache,
    each step's ms by CUDA events when `timed`)."""
    logits, cache = model.prefill(batch, max_len=max_len)
    outs, toks, times = [logits], [logits[:, -1].argmax(-1, keepdim=True)], []
    for _ in range(steps):
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        logits, cache = model.decode_step(toks[-1], cache)
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
        if timed:
            end.record()
            times.append((start, end))
        outs.append(logits)
    torch.cuda.synchronize()
    return (torch.cat(outs, 1), torch.cat(toks, 1), cache,
            [a.elapsed_time(b) for a, b in times])


def _matrix_params(tree: dict, stacked: int = 0) -> int:
    """The parameters of a layout's matrices (its leaves of 2 or more
    axes besides the `stacked` leading ones); a depthwise conv's (W, R)
    taps count as a matrix, as a token takes W R multiply-adds of them."""
    return sum(_matrix_params(v, stacked) if isinstance(v, dict) else
               (int(np.prod(v[0])) if len(v[0]) >= 2 + stacked else 0)
               for v in tree.values())


def _attn_f32(acfg, B: int, S: int) -> float:
    """Float32 FLOPs of one layer's blockwise attention over (B, S): every
    (q, kv) pair of the blocks, masked ones included."""
    if acfg.kv_lora is not None:
        hd_k = acfg.head_dim + acfg.rope_head_dim
        hd_v = acfg.v_head_dim or acfg.head_dim
    else:
        hd_k = hd_v = acfg.head_dim
    return 2.0 * B * acfg.num_heads * S * S * (hd_k + hd_v)


def recurrent_prefill_work(cfg, B: int, S: int):
    """(FLOPs of the bf16 products, FLOPs in float32) of a Griffin or xLSTM
    prefill of (B, S), as the port computes it.  Products: every matrix
    (and conv tap) once a token, the head at the last position.  Float32:
    Griffin's attention layers as `_attn_f32`, each RG-LRU's gates (12 a
    channel and position) and its log-depth scan (4 a channel and position
    a pass, ceil(log2 S) passes); xLSTM's mLSTM parallel form over every
    (t, s) pair of its chunks ((4 hd + 8) a pair and head: scores, values,
    the decay matrix), its recurrence over the prompt (7 hd^2 a position
    and head: the k v outer product, C's update, the read) and the sLSTM
    recurrence (20 a channel and position)."""
    import math

    from repro_torch.models import build_model
    model, N, d = build_model(cfg), B * S, cfg.d_model
    lay = model.layout()
    mm = 2.0 * N * (_matrix_params(lay["units"], stacked=1) + sum(
        _matrix_params(v) for k, v in lay.items() if k.startswith("tail")))
    mm += 2.0 * B * d * cfg.vocab
    if cfg.family == "griffin":
        n_rec = model.kinds.count("rec")
        passes = math.ceil(math.log2(S)) if S > 1 else 0
        f32 = n_rec * N * model.rcfg.d_rnn * (12 + 4 * passes)
        f32 += model.n_units * _attn_f32(cfg.attn_config(), B, S)
        return mm, f32
    H, hd = cfg.num_heads, 2 * d // cfg.num_heads
    f32 = model.n_units * (B * S * S * H * (4 * hd + 8)
                           + N * H * 7 * hd * hd + N * d * 20)
    return mm, f32


def lm_prefill_work(cfg, B: int, S: int):
    """(FLOPs of the bf16 products, FLOPs in float32) of a causal prefill
    of (B, S), as the port computes it: each layer's projections and MLP
    (MoE: the shared experts a token, every expert over its capacity
    buffer; the router in float32), attention in float32 over every (q,
    kv) pair of the blocks (masked pairs included), the head at the last
    position; the recurrent families as `recurrent_prefill_work`."""
    if cfg.family != "transformer":
        return recurrent_prefill_work(cfg, B, S)
    from repro_torch.models.transformer import layer_layout
    lay, acfg, N = layer_layout(cfg), cfg.attn_config(), B * S
    d, L = cfg.d_model, cfg.num_layers
    dense = _matrix_params(lay["attn"])
    f32 = 0.0
    experts = 0.0
    if cfg.moe is not None:
        e = cfg.moe
        C = max(1, int(N * e.top_k * e.capacity_factor / e.num_experts))
        dense += _matrix_params(lay["moe"].get("shared", {}))
        experts = 2.0 * e.num_experts * C * 3 * d * e.d_ff_expert
        f32 += 2.0 * N * d * e.num_experts
    else:
        dense += _matrix_params(lay["mlp"])
    f32 += _attn_f32(acfg, B, S)
    mm = L * (2.0 * N * dense + experts) + 2.0 * B * d * cfg.vocab
    return mm, L * f32


def _tensors(tree) -> list:
    """The tensors of a nested dict (a cache entry)."""
    return [t for v in tree.values()
            for t in (_tensors(v) if isinstance(v, dict) else [v])]


def lm_decode_bytes(model, cache) -> float:
    """Bytes a decode step must move: every weight it reads once (all of
    them but an untied embedding table, of which it gathers B rows: the
    dense dispatch runs every expert), an attention cache's filled slots
    read (the new position's entries written), and every recurrent state
    (RG-LRU h and conv tail; mLSTM C, n, m; sLSTM c, n, m, h; their conv
    tails) read and written."""
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if not model.cfg.tie_embeddings:
        nbytes -= model.embed.numel() * model.embed.element_size()
    for c in cache:
        if "pos" not in c:
            nbytes += 2 * sum(t.numel() * t.element_size()
                              for t in _tensors(c))
            continue
        filled = int((c["pos"] >= 0).sum())
        for name in ("k", "v", "latent"):
            if name in c:
                t = c[name]
                nbytes += t.shape[0] * filled * t.shape[2] * t.element_size()
    return float(nbytes)


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for c in cache
               for t in _tensors(c))


def free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def fan_in_weights(model) -> str:
    """Scale each of the model's block matrices in place from the std JAX's
    init draws a stacked leaf with (1/sqrt(units), or 1/sqrt(layers) for a
    transformer's stack) to 1/sqrt(its d_in) (the next-to-last axis: a
    matrix's rows, or each expert's of MoE's (E, d_in, d_out) stack).
    Returns a label for the printed line."""
    import math
    if hasattr(model, "blocks"):
        n_stack, blocks = model.n_units, model.blocks
    else:
        n_stack, blocks = model.cfg.num_layers, model.layers
    with torch.no_grad():
        for block in blocks:
            for p in block.parameters():
                if p.dim() >= 2:
                    p.mul_(math.sqrt(n_stack / p.shape[-2]))
    return "block matrices rescaled to std 1/sqrt(d_in)"


def width_parity(dev, card: str, arch: str, layers: int, what: str,
                 tol: float, tf_tol: float, n_image: int = 0,
                 prepare=None) -> None:
    """One config at full width in float32 (cut to `layers`), the same
    weights on the card and on the CPU (drawn on the card from a seed,
    `prepare(model)` applied when given, then copied), a prefill of
    LM_PARITY's prompts (after `n_image` image rows drawn from the seed for
    a VLM) and greedy decode steps on both: logits within `tol` x max
    |logit| of the CPU's, greedy tokens equal, the first step against a
    prefill over S + 1 tokens within `tf_tol` (for xLSTM its
    `mlstm_state_gap`)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    B, S, max_len, steps = LM_PARITY
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch).CONFIG, num_layers=layers,
                              dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    m_card = build_model(cfg).init(gen, device=dev)
    weights = f", {prepare(m_card)}" if prepare else ""
    m_cpu = copy_to(m_card, "cpu")
    rng = np.random.default_rng(LM_SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S), dtype=np.int32))}
    if n_image:
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, n_image, cfg.d_model), dtype=np.float32))
    on_card = {k: v.to(dev) for k, v in batch.items()}
    lg, tg, _, _ = greedy(m_card, on_card, max_len, steps)
    lc, tc, _, _ = greedy(m_cpu, batch, max_len, steps)
    scale = float(lc.abs().max())
    err = float((lg.cpu() - lc).abs().max()) / scale
    tf, _, state = lm_teacher_forced(no_drop(m_card) if cfg.moe else m_card,
                                     on_card, tg[:, :1])
    image = f"{n_image} image rows + " if n_image else ""
    print(f"lm {what} width parity {cfg.name}: layers {layers} at full "
          f"width (d {cfg.d_model}, {cfg.num_heads} x {cfg.hd} heads, "
          f"kv {cfg.num_kv_heads}, vocab {cfg.vocab}){weights}, float32, "
          f"(B, S) = ({B}, {image}{S}), max_len {max_len}, {steps} greedy "
          f"steps: max |logits card - CPU| / max |logit| {err:.6g} (bound "
          f"{tol}), max |logit| {scale:.4g}, greedy tokens equal "
          f"{torch.equal(tg.cpu(), tc)}; teacher-forced on the card "
          f"(the first decode step against a prefill over {S + 1} "
          f"tokens{', MoE capacity dropping nothing' if cfg.moe else ''})"
          f": {teacher_forced_text(tf, state, tf_tol)}; "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    if not (bool(torch.isfinite(lg).all()) and err <= tol
            and torch.equal(tg.cpu(), tc)
            and (tf if state is None else state) <= tf_tol):
        raise SystemExit(f"FAIL lm {what} {arch}: the card's logits or "
                         f"greedy tokens != the CPU's")
    del m_card, m_cpu, lg
    free_card()


def lm_width_parity(dev, card: str) -> None:
    """14a: each transformer-family config at full width in float32, card
    against CPU (`width_parity`)."""
    for arch in LM_IDS:
        width_parity(dev, card, arch, LM_PARITY_LAYERS.get(arch, 2), "14a",
                     LM_F32_TOL, LM_F32_TF_TOL)


def no_drop(model):
    """The model on the same weight tensors with an MoE capacity that
    drops no assignment: capacity factor (E + 1) / K, so C >= N, and an
    expert takes at most one assignment a token."""
    import dataclasses

    from repro_torch.models import build_model
    cfg = model.cfg
    moe = dataclasses.replace(
        cfg.moe, capacity_factor=(cfg.moe.num_experts + 1) / cfg.moe.top_k)
    return build_model(dataclasses.replace(cfg, moe=moe)).load(model.tree())


def mlstm_state_gap(stepped, full) -> float:
    """max |stepped - prefilled| / max |prefilled| over xLSTM unit 0's mLSTM
    state (C, n, m) and conv tail, the largest of the four: the mLSTM
    block's input is the embeddings on both paths, and a prefill's
    `_mlstm_final_state` runs the decode step's recurrence, so the two
    agree to rounding (the products' shapes differ).  The logits do not:
    JAX's `mlstm_step` builds its normaliser from unscaled keys (ROADMAP
    Queue 3), and every later block takes that gap in."""
    a, b = stepped[0]["m"], full[0]["m"]
    pairs = [(a["conv"], b["conv"])] + [(a["rec"][k], b["rec"][k])
                                        for k in ("C", "n", "m")]
    return max(float((x.float() - y.float()).abs().max())
               / float(y.float().abs().max()) for x, y in pairs)


def stepped_vs_prefill(model, batch: dict, n_prefill: int,
                       max_len: int) -> tuple[float, float, float | None]:
    """(max |the last of the single-token decode steps that take a prefill
    of batch's first `n_prefill` tokens (after its image rows) to the end
    of its tokens - the last-position logits of a prefill over all of
    them| / max |logit|, max |logit|, for xLSTM the `mlstm_state_gap` of
    their caches, else None)."""
    tokens = batch["tokens"]
    _, cache = model.prefill(dict(batch, tokens=tokens[:, :n_prefill]),
                             max_len=max_len)
    for t in range(n_prefill, tokens.shape[1]):
        step, cache = model.decode_step(tokens[:, t:t + 1], cache)
    full, full_cache = model.prefill(batch, max_len=max_len)
    scale = float(full.abs().max())
    state = (mlstm_state_gap(cache, full_cache)
             if model.cfg.family == "xlstm" else None)
    return float((step - full).abs().max()) / scale, scale, state


def teacher_forced_text(err: float, state: float | None, bound) -> str:
    """A teacher-forced check's reading beside its bound: the logits' gap,
    or for xLSTM (`state` not None) the logits' gap, not held, and the
    unit-0 mLSTM state's gap, held."""
    if state is None:
        return f"{err:.6g} (bound {bound})"
    return (f"{err:.6g} (the reference's normaliser gap, not held); unit "
            f"0's mLSTM state and conv tail against the prefill's, max "
            f"|diff| / max |value| {state:.6g} (bound {bound})")


def lm_teacher_forced(model, batch: dict, first):
    """`stepped_vs_prefill` of one decode step, of `first`, after a prefill
    of `batch`."""
    tokens = torch.cat([batch["tokens"], first], 1)
    return stepped_vs_prefill(model, dict(batch, tokens=tokens),
                              batch["tokens"].shape[1], LM_MAX_LEN)


def lm_serve(dev, card: str, arch: str) -> None:
    """14b / 14c: one config at full width in bf16 (cut to LM_DEPTH
    layers), weights drawn on the card: prompts of LM_PROMPT tokens,
    greedy decode steps, the teacher-forced check, times and bounds."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    full_cfg = get_arch(arch).CONFIG
    cfg = dataclasses.replace(
        full_cfg, num_layers=LM_DEPTH.get(arch, full_cfg.num_layers))
    B, steps = LM_SERVE.get(arch, LM_SERVE_DEFAULT)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    model = build_model(cfg).init(gen, device=dev)
    n_params = model.param_count()
    prompts = torch.randint(0, cfg.vocab, (B, LM_PROMPT), generator=gen,
                            device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    cut = ("" if cfg.num_layers == full_cfg.num_layers else
           f", cut from {full_cfg.num_layers} layers")
    print(f"lm {cfg.name}: {cfg.num_layers} layers{cut}, {cfg.dtype}, "
          f"{n_params} parameters ({build_model(full_cfg).param_count()} "
          f"at full depth, {model.active_param_count()} active a token) "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")

    torch.cuda.reset_peak_memory_stats()
    logits, toks, cache, step_ms = greedy(model, {"tokens": prompts},
                                          LM_MAX_LEN, steps,
                                          timed=True)
    peak = torch.cuda.max_memory_allocated()
    if not (bool(torch.isfinite(logits).all())
            and logits.shape == (B, 1 + steps, cfg.vocab)
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab):
        raise SystemExit(f"FAIL lm {arch}: logits not finite or tokens out "
                         f"of range")
    # teacher-forced: the first decode step (token 512) against a prefill
    # over all 512 tokens; MoE on a capacity that drops nothing, since a
    # step routes B tokens and a prefill B x 512 with their own capacities
    first = toks[:, :1]
    if cfg.moe is None:
        err, scale, _ = lm_teacher_forced(model, {"tokens": prompts},
                                          first)
        what = ""
    else:
        err, scale, _ = lm_teacher_forced(no_drop(model),
                                          {"tokens": prompts}, first)
        served, _, _ = lm_teacher_forced(model, {"tokens": prompts}, first)
        what = (f" (on capacity factor (E + 1) / K, no assignment dropped; with "
                f"the configured capacity {served:.6g})")
    print(f"lm {cfg.name} teacher-forced: max |decode step logits - "
          f"prefill over all {LM_PROMPT + 1} tokens| / max |logit| "
          f"{err:.6g}{what} (bound {LM_BF16_TOL[arch]}), max |logit| "
          f"{scale:.4g}; every logit of the prefill and the {steps} greedy "
          f"steps finite")
    if not err <= LM_BF16_TOL[arch]:
        raise SystemExit(f"FAIL lm {arch}: the decode step's logits are "
                         f"outside their bound of the prefill's")

    nbytes = lm_decode_bytes(model, cache)
    pre = median_ms(lambda: model.prefill({"tokens": prompts},
                                          max_len=LM_MAX_LEN))
    mm, f32 = lm_prefill_work(cfg, B, LM_PROMPT)
    t_mm, t_f32 = mm / BF16_OPS_PER_S * 1e3, f32 / F32_OPS_PER_S * 1e3
    dec = float(np.median(step_ms))
    print(f"timing lm {cfg.name} prefill (B, S) = ({B}, {LM_PROMPT}): "
          f"{pre:.4f} ms ({B * LM_PROMPT / pre * 1e3:.1f} tokens/s); bound "
          f"{t_mm + t_f32:.4f} ms (operations: {mm / 1e12:.4f} TFLOP of "
          f"bf16 products at 989 TFLOP/s = {t_mm:.4f} ms, plus "
          f"{f32 / 1e12:.4f} TFLOP in float32 at 67 TFLOP/s); {card}")
    print(f"timing lm {cfg.name} decode step at B = {B}: median "
          f"{dec:.4f} ms over {steps} greedy steps (min {min(step_ms):.4f}, "
          f"max {max(step_ms):.4f}), {B / dec * 1e3:.1f} tokens/s; bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes: "
          f"{nbytes / 1e9:.4f} GB of weights and filled cache at 3.35 "
          f"TB/s); peak allocated {peak / 2**30:.3f} GiB, cache "
          f"{cache_bytes(cache) / 2**30:.4f} GiB ({LM_MAX_LEN} slots); "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    # after every timing: a step timed after a profiler trace runs slower
    tok = toks[:, -1:]
    drain_device_share(lambda: (lambda: model.decode_step(tok, cache)),
                       f"lm {cfg.name} decode step", card)
    drain_device_share(lambda: (lambda: model.prefill(
        {"tokens": prompts}, max_len=LM_MAX_LEN)), f"lm {cfg.name} prefill",
        card)
    del model, cache, logits
    free_card()


def lm_ring(dev, card: str) -> None:
    """14d: danube's 4096-slot window ring at full width, 2 layers, float32
    on the card: a prefill of 4096 tokens and 1024 single-token steps (the
    ring wraps once) against a prefill of all 5120 (rolled by 1024), then
    greedy steps from each cache."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    B, S1, n1, steps = LM_RING
    cfg = dataclasses.replace(get_arch("h2o_danube_3_4b").CONFIG,
                              num_layers=2, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    model = build_model(cfg).init(gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, S1 + n1), generator=gen,
                           device=dev, dtype=torch.int32)
    max_len = S1 + n1 + steps + 1
    _, c1 = model.prefill({"tokens": tokens[:, :S1]}, max_len=max_len)
    for t in range(S1, S1 + n1):
        l1, c1 = model.decode_step(tokens[:, t:t + 1], c1)
    l2, c2 = model.prefill({"tokens": tokens}, max_len=max_len)
    ring = c2[0]["k"].shape[1]
    scale = float(l2.abs().max())
    err = float((l1 - l2).abs().max()) / scale
    first = l2[:, -1].argmax(-1, keepdim=True)
    outs, toks = [], []
    for c in (c1, c2):
        tok, lg, tk = first, [], []
        for _ in range(steps):
            logits, c = model.decode_step(tok, c)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            lg.append(logits)
            tk.append(tok)
        outs.append(torch.cat(lg, 1))
        toks.append(torch.cat(tk, 1))
    err2 = float((outs[0] - outs[1]).abs().max()) / scale
    same = torch.equal(toks[0], toks[1])
    print(f"lm 14d {cfg.name} ring ({ring} slots, window {cfg.window}), 2 "
          f"layers, float32, B = {B}: prefill {S1} + {n1} decode steps vs "
          f"a prefill of {S1 + n1} (roll {(S1 + n1 - ring) % ring}): max "
          f"|diff| / max |logit| {err:.6g}; then {steps} greedy steps from "
          f"each cache: {err2:.6g} (bounds {LM_RING_TOL}), greedy tokens "
          f"equal {same}; {time.perf_counter() - t0:.1f} s; {card}")
    if not (ring == cfg.window and err <= LM_RING_TOL[0]
            and err2 <= LM_RING_TOL[1] and same):
        raise SystemExit("FAIL lm 14d: the wrapped ring != the rolled "
                         "prefill's cache")
    del model, c1, c2
    free_card()


def phase_lm(dev, card: str) -> dict[str, int]:
    """14: causal-LM serving of the transformer family: 14a width parity
    (float32, card against CPU), 14b granite-8b whole in bf16, 14c the
    other five (moonshot and deepseek-v2 cut in depth), 14d danube's window
    ring.  No Viterbi kernel may launch."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.reset_launches()
    lm_width_parity(dev, card)
    for arch in ("granite_8b",) + tuple(a for a in LM_IDS
                                        if a != "granite_8b"):
        lm_serve(dev, card, arch)
    lm_ring(dev, card)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launches("lm", launches, {})
    print(f"lm phase: {time.perf_counter() - t0:.1f} s wall; no Viterbi "
          f"kernel launched; {card}")
    return launches


# ---------------------------------------------------------------------------
# 15: the recurrent families (Griffin, xLSTM) and llava's image tokens
# ---------------------------------------------------------------------------

REC_IDS = ("recurrentgemma_2b", "xlstm_350m", "llava_next_34b")
#: 15a: layers at full width in float32 (Griffin: one (rec, rec, attn)
#: unit and the two tail rec layers; xLSTM: one (mLSTM, sLSTM) unit), and
#: llava's image rows (JAX's `_embed_tokens` takes any number)
REC_PARITY_LAYERS = dict(recurrentgemma_2b=5, xlstm_350m=2, llava_next_34b=2)
REC_PARITY_IMAGE = 32
#: 15a: max |logits, card - CPU| / max |logit| and the teacher-forced
#: check on the card (the first step against a prefill over 65 tokens),
#: float32 (TF32 off): 1.5x the values measured on an H100 (PERF.md §6):
#: recurrentgemma 2.42092e-3 and 6.20179e-4 (JAX's init draws the
#: unit's matrices with std 1/sqrt(units) = 1, so the softmax and the
#: RG-LRU's gates saturate), llava 5.3906e-6 and 4.89726e-6, xlstm
#: 3.55691e-6 and, of unit 0's mLSTM state and conv tail
#: (`mlstm_state_gap`), 1.12398e-6.  xlstm runs on its block matrices
#: rescaled to std 1/sqrt(d_in) (`fan_in_weights`): on JAX's init it is
#: chaotic, the card's and the CPU's float32 logits 1.41052 x max |logit|
#: apart with other greedy tokens (my chip run 1 of PR 23, PERF.md §6).
#: Its teacher-forced logits' gap (0.970949) is the reference's:
#: `mlstm_step` builds its normaliser from unscaled keys (ROADMAP Queue 3)
REC_F32_TOL = dict(recurrentgemma_2b=3.63e-3, xlstm_350m=5.35e-6,
                   llava_next_34b=8.09e-6)
REC_F32_TF_TOL = dict(recurrentgemma_2b=9.3e-4, xlstm_350m=1.69e-6,
                      llava_next_34b=7.35e-6)
#: 15b-d: (batch, prompt tokens, max_len, greedy steps).  xLSTM's prompt is
#: a multiple of its mLSTM chunk (256) and llava's 2880 image rows + 192
#: tokens a multiple of the attention's kv block (1024), as JAX's prefill
#: requires of a sequence longer than one block (511 tokens would give
#: 3391 positions, which both packages refuse)
REC_SERVE = dict(recurrentgemma_2b=(8, 511, 1024, 64),
                 xlstm_350m=(8, 512, 1024, 64),
                 llava_next_34b=(2, 192, 4096, 16))
#: 15b-d: the teacher-forced checks, bf16, as (prompt tokens prefilled,
#: tokens in all): single-token steps from a prefill of the first
#: against a prefill of all, the last step's logits.  recurrentgemma: the
#: step after 511 against 512; xLSTM (A) 256 + 256 against 512 (the
#: recurrent form against the chunked parallel form) and (B) 255 + 1
#: against 256; llava: 2880 image rows + 192 tokens, then 1024 steps,
#: against a prefill of 2880 + 1216 (the next length the blocks take)
REC_TF = dict(recurrentgemma_2b={"recurrentgemma_2b": (511, 512)},
              xlstm_350m={"xlstm_a": (256, 512), "xlstm_b": (255, 256)},
              llava_next_34b={"llava_next_34b": (192, 1216)})
#: 15b-d: their bounds, 1.5x the values measured on an H100 (PERF.md
#: §6): max |diff| / max |logit|, recurrentgemma 0.0609568 and llava
#: 0.0738393; for xLSTM `mlstm_state_gap`, 0 in both (A) and (B): unit 0's
#: stepped mLSTM state and conv tail equal the prefill's bitwise (its
#: logits' gaps, 1.43655 and 1.1439, are the reference's normaliser gap
#: grown through 12 units, printed, not held)
REC_BF16_TOL = dict(recurrentgemma_2b=0.0914, xlstm_a=0.0, xlstm_b=0.0,
                    llava_next_34b=0.111)
#: 15b-d: the timed prefills after one warm-up (median of them): xLSTM's
#: takes 5.2 s and llava's 1.9 s (NVIDIA H100 80GB HBM3, 700.00 W), and
#: the smoke's 1 200 s no longer leave room for the 2 + 7 of phase 14's
REC_PREFILL_RUNS = 3


def init_peak_bytes(layout, itemsize: int) -> int:
    """The most memory `init_params` holds while it draws `layout` leaf by
    leaf: the leaves drawn so far in the dtype, plus, at a drawn leaf, its
    float32 draw (scaled in place) beside its cast."""
    done = peak = 0

    def walk(lay):
        nonlocal done, peak
        for v in lay.values():
            if isinstance(v, dict):
                walk(v)
                continue
            n = int(np.prod(v[0]))
            draw = 4 * n if v[2] in ("normal", "embed") and itemsize != 4 \
                else 0
            peak = max(peak, done + draw + n * itemsize)
            done += n * itemsize
    walk(layout)
    return peak


def recurrent_serve(dev, card: str, arch: str) -> None:
    """15b-d: one config at full width in bf16 (cut to LM_DEPTH layers),
    weights (and llava's image embeddings) drawn on the card from
    LM_SEED: the init's peak beside its model, greedy decode, the
    teacher-forced checks, times and bounds, the device's idle share."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    full_cfg = get_arch(arch).CONFIG
    cfg = dataclasses.replace(
        full_cfg, num_layers=LM_DEPTH.get(arch, full_cfg.num_layers))
    B, S, max_len, steps = REC_SERVE[arch]
    checks = REC_TF[arch]
    n_text = max(n for _, n in checks.values())
    n_img = cfg.num_image_tokens
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg).init(gen, device=dev)
    init_peak = torch.cuda.max_memory_allocated()
    modeled = init_peak_bytes(model.layout(), 2)
    n_params = model.param_count()
    text = torch.randint(0, cfg.vocab, (B, max(S, n_text)), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": text[:, :S]}
    if n_img:
        batch["image_embeds"] = torch.randn(
            (B, n_img, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    torch.cuda.synchronize()
    cut = ("" if cfg.num_layers == full_cfg.num_layers else
           f", cut from {full_cfg.num_layers} layers")
    print(f"lm 15 {cfg.name}: {cfg.num_layers} layers{cut}, {cfg.dtype}, "
          f"{n_params} parameters ({build_model(full_cfg).param_count()} "
          f"at full depth) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s: peak {init_peak / 2**30:.3f} "
          f"GiB during the init (modeled from the layout "
          f"{modeled / 2**30:.3f} GiB), "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated after "
          f"it, {torch.cuda.mem_get_info()[1] / 2**30:.3f} GiB on the card")

    torch.cuda.reset_peak_memory_stats()
    logits, toks, cache, step_ms = greedy(model, batch, max_len, steps,
                                          timed=True)
    peak = torch.cuda.max_memory_allocated()
    if not (bool(torch.isfinite(logits).all())
            and logits.shape == (B, 1 + steps, cfg.vocab)
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab):
        raise SystemExit(f"FAIL lm 15 {arch}: logits not finite or tokens "
                         f"out of range")
    for name, (n_pre, n_all) in checks.items():
        t1 = time.perf_counter()
        err, scale, state = stepped_vs_prefill(
            model, dict(batch, tokens=text[:, :n_all]), n_pre, max_len)
        print(f"lm 15 {cfg.name} teacher-forced ({name}): a prefill of "
              f"{n_img + n_pre} positions and {n_all - n_pre} decode steps "
              f"against a prefill of all {n_img + n_all}: max |diff| / max "
              f"|logit| "
              f"{teacher_forced_text(err, state, REC_BF16_TOL[name])}, max "
              f"|logit| {scale:.4g}; every logit of the prefill and the "
              f"{steps} greedy steps finite; "
              f"{time.perf_counter() - t1:.1f} s")
        if not (err if state is None else state) <= REC_BF16_TOL[name]:
            raise SystemExit(f"FAIL lm 15 {arch}: the decode steps' logits "
                             f"are outside their bound of the prefill's")

    nbytes = lm_decode_bytes(model, cache)
    pre = median_ms(lambda: model.prefill(batch, max_len=max_len),
                    runs=REC_PREFILL_RUNS, warmup=1)
    mm, f32 = lm_prefill_work(cfg, B, n_img + S)
    t_mm, t_f32 = mm / BF16_OPS_PER_S * 1e3, f32 / F32_OPS_PER_S * 1e3
    dec = float(np.median(step_ms))
    image = f"{n_img} image rows + " if n_img else ""
    print(f"timing lm 15 {cfg.name} prefill (B, S) = ({B}, {image}{S}): "
          f"{pre:.4f} ms ({B * (n_img + S) / pre * 1e3:.1f} positions/s); "
          f"bound {t_mm + t_f32:.4f} ms (operations: {mm / 1e12:.4f} TFLOP "
          f"of bf16 products at 989 TFLOP/s = {t_mm:.4f} ms, plus "
          f"{f32 / 1e12:.4f} TFLOP in float32 at 67 TFLOP/s); {card}")
    print(f"timing lm 15 {cfg.name} decode step at B = {B}: median "
          f"{dec:.4f} ms over {steps} greedy steps (min {min(step_ms):.4f}, "
          f"max {max(step_ms):.4f}), {B / dec * 1e3:.1f} tokens/s; bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes: "
          f"{nbytes / 1e9:.4f} GB of weights, states read and written and "
          f"filled ring slots at 3.35 TB/s); peak allocated "
          f"{peak / 2**30:.3f} GiB, cache {cache_bytes(cache) / 2**30:.4f} "
          f"GiB (max_len {max_len}); {time.perf_counter() - t0:.1f} s; "
          f"{card}")
    # after every timing: a step timed after a profiler trace runs slower
    tok = toks[:, -1:]
    drain_device_share(lambda: (lambda: model.decode_step(tok, cache)),
                       f"lm 15 {cfg.name} decode step", card)
    drain_device_share(lambda: (lambda: model.prefill(batch,
                                                      max_len=max_len)),
                       f"lm 15 {cfg.name} prefill", card)
    del model, cache, logits, batch
    free_card()


def phase_recurrent(dev, card: str) -> dict[str, int]:
    """15: the recurrent families and llava's image tokens: 15a width
    parity (float32, card against CPU), 15b recurrentgemma-2b whole, 15c
    xlstm-350m whole, 15d llava-next-34b at full width cut in depth (bf16).
    No Viterbi kernel may launch."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.reset_launches()
    for arch in REC_IDS:
        layers = REC_PARITY_LAYERS[arch]
        n_image = REC_PARITY_IMAGE if arch == "llava_next_34b" else 0
        width_parity(dev, card, arch, layers, "15a", REC_F32_TOL[arch],
                     REC_F32_TF_TOL[arch], n_image=n_image,
                     prepare=fan_in_weights if arch == "xlstm_350m" else
                     None)
    for arch in REC_IDS:
        recurrent_serve(dev, card, arch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launches("hybrid", launches, {})
    print(f"recurrent phase: {time.perf_counter() - t0:.1f} s wall; no "
          f"Viterbi kernel launched; {card}")
    return launches


# ---------------------------------------------------------------------------
# 16: training
# ---------------------------------------------------------------------------

TRAIN_SEED = 0
#: 16a / 16b: bounds, card against CPU, float32 (TF32 off): (|loss| rel,
#: |grad_norm| rel, max over leaves of max |m card - m CPU| / max |m|,
#: max |w card - w CPU| / lr over the weights whose gradient is resolved
#: (|m| above 1e-3 x its leaf's max; an unresolved one may flip the sign
#: of its normalised step, held to 2.05 lr)): 1.5x an H100 probe run
#: (PERF.md §6), the loss's at least 2.4e-7 (two float32 ulps;
#: several configs measured 0).  JAX's init draws a stacked leaf with
#: std 1/sqrt(layers), and the recurrent SMOKEs' backward amplifies the
#: card's and the CPU's float32 rounding most: Griffin's first moment
#: 4.0e-3, xLSTM's 2.9e-3 of max |m| apart.  16b ("tinyllama_1_1b/width")
#: runs on matrices rescaled to std 1/sqrt(d_in) (`fan_in_weights`): on
#: JAX's 1/sqrt(2) its softmax saturates, and one probe's first moments
#: were 7.9e-2 x max |m| apart, resolved weights 2 lr
TRAIN_F32_TOL = {
    "recurrentgemma_2b": (1.03e-6, 2.82e-3, 6.0e-3, 0.287),
    "deepseek_v2_236b": (2.4e-7, 2.86e-5, 1.23e-4, 3.58e-4),
    "moonshot_v1_16b_a3b": (2.4e-7, 3.43e-5, 5.86e-5, 3.58e-4),
    "tinyllama_1_1b": (2.4e-7, 7.81e-6, 7.17e-5, 2.68e-4),
    "h2o_danube_3_4b": (2.4e-7, 6.96e-6, 3.14e-5, 1.79e-4),
    "granite_8b": (2.4e-7, 1.72e-5, 7.13e-5, 1.79e-4),
    "gemma_2b": (2.4e-7, 1.82e-5, 1.03e-4, 1.54e-3),
    "xlstm_350m": (2.58e-7, 4.63e-4, 4.34e-3, 0.0965),
    "hubert_xlarge": (2.4e-7, 1.83e-5, 7.82e-5, 1.79e-4),
    "llava_next_34b": (2.4e-7, 2.03e-5, 1.25e-4, 2.79e-4),
    "tinyllama_1_1b/compress": (2.4e-7, 4.28e-6, 1.18e-2, 1.79e-4),
    "tinyllama_1_1b/width": (2.4e-7, 3.39e-4, 3.41e-4, 3.35e-5),
}
#: 16a: (B, S) of the batch (two microbatches of 2), 16b: (B, S)
TRAIN_PARITY = (4, 16)
TRAIN_WIDTH = (2, 512)
#: 16c: microbatch, accum_steps, sequence length
TRAIN_MAIN = (2, 2, 4096)
#: 16d: tests/test_system.py's tinyllama SMOKE runs
TRAIN_LOOP = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cuda"]
TRAIN_RESUME_TOL = (2e-4, 2e-5)


def _np_leaves(tree) -> list:
    """The numpy leaves of a nested dict, in its key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _np_leaves(v)]
    return [np.asarray(tree)]


def train_batch(cfg, rng: np.random.Generator, B: int, S: int) -> dict:
    """A numpy batch of the config's inputs (tokens after llava's image
    embeddings, or an encoder's frame embeddings), labels and a mask."""
    b = {"labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
         "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if not cfg.embed_inputs and not cfg.num_image_tokens:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model),
                                          dtype=np.float32)
        return b
    n = cfg.num_image_tokens
    b["tokens"] = rng.integers(0, cfg.vocab, (B, S - n), dtype=np.int32)
    if n:
        b["image_embeds"] = rng.standard_normal((B, n, cfg.d_model),
                                                dtype=np.float32)
    return b


def _np_paths(tree, prefix: str = "") -> dict:
    """{path: numpy leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _np_paths(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def step_gaps(st, met, ref_st, ref_met):
    """((loss rel, grad_norm rel, max over leaves of max |m - m ref| / max
    |m ref|, max |w - w ref| / lr over the weights whose gradient is
    resolved (|m ref| above 1e-3 x its leaf's max)), max |w - w ref| / lr
    anywhere, every leaf of `st` finite) of two train states in JAX's
    layout (numpy) and their metrics; leaves matched by path."""
    lr = ref_met["lr"]
    loss = abs(met["loss"] - ref_met["loss"]) / abs(ref_met["loss"])
    gn = abs(met["grad_norm"] - ref_met["grad_norm"]) / ref_met["grad_norm"]
    m, ref_m = _np_paths(st["opt"]["m"]), _np_paths(ref_st["opt"]["m"])
    mom = max(float(np.abs(m[k] - b).max() / max(np.abs(b).max(), 1e-30))
              for k, b in ref_m.items())
    w, ref_w = _np_paths(st["params"]), _np_paths(ref_st["params"])
    w_res = w_all = 0.0
    for k, b in ref_w.items():
        gap = np.abs(w[k] - b) / lr
        resolved = np.abs(ref_m[k]) > 1e-3 * np.abs(ref_m[k]).max()
        w_all = max(w_all, float(gap.max()))
        w_res = max(w_res, float(gap[resolved].max(initial=0.0)))
    finite = all(np.isfinite(x).all() for x in _np_leaves(st))
    return (loss, gn, mom, w_res), w_all, finite


def train_parity(dev, card: str, cfg, B: int, S: int, what: str,
                 tol, compress: bool = False, prepare=None) -> None:
    """One train step of `cfg` at accum_steps 2 on the card and on the CPU
    from the same weights (drawn on the card from TRAIN_SEED, then
    `prepare(model)` when given) and batch: the gaps of `TRAIN_F32_TOL`,
    printed beside their bounds, each fatal."""
    from repro_torch.models import build_model
    from repro_torch.models.convert import (train_state_from_jax,
                                            train_state_to_numpy)
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    t0 = time.perf_counter()
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10),
                       accum_steps=2, compress_accum=compress)
    m_card = build_model(cfg)
    s_card = init_train_state(
        m_card, torch.Generator(device=dev).manual_seed(TRAIN_SEED),
        device=dev)
    weights = f", {prepare(m_card)}" if prepare else ""
    m_cpu = build_model(cfg)
    s_cpu = train_state_from_jax(train_state_to_numpy(s_card, m_card),
                                 m_cpu, device="cpu")
    batch = train_batch(cfg, np.random.default_rng(TRAIN_SEED), B, S)
    out = []
    for model, state, d in ((m_card, s_card, dev), (m_cpu, s_cpu, "cpu")):
        state, met = make_train_step(model, tcfg)(
            state, {k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        out.append((train_state_to_numpy(state, model),
                    {k: float(v) for k, v in met.items()}))
    torch.cuda.synchronize()
    (card_st, card_m), (cpu_st, cpu_m) = out
    gaps, w_all, finite = step_gaps(card_st, card_m, cpu_st, cpu_m)
    loss, gn, mom, w_res = gaps
    kind = ", compress_accum (int8 error feedback)" if compress else ""
    print(f"train {what} {cfg.name}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, float32, (B, S) = ({B}, {S}),"
          f" accum_steps 2{kind}{weights}: loss {card_m['loss']:.6f} "
          f"(card) "
          f"{cpu_m['loss']:.6f} (CPU); card - CPU: loss rel {loss:.4g}, "
          f"grad_norm rel {gn:.4g}, first moment {mom:.4g} x max |m|, "
          f"weights {w_res:.4g} lr where the gradient is resolved "
          f"({w_all:.4g} lr anywhere; bound 2.05); bounds {tol}; "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    if not (finite and w_all <= 2.05
            and all(g <= t for g, t in zip(gaps, tol))):
        raise SystemExit(f"FAIL train {what} {cfg.name}: the card's step "
                         f"!= the CPU's")
    del m_card, s_card
    free_card()


def lm_train_work(cfg, B: int, S: int):
    """(FLOPs of the bf16 products, FLOPs in float32 the step needs, FLOPs
    in float32 the port computes) of one training step of a transformer
    over (B, S): `lm_prefill_work`'s forward with the head over every
    position, times 3 (forward, and backward at twice the forward); the
    recomputation of each layer in backward is not counted.  The float32
    attention the step needs counts the causal (q, kv) pairs
    (`launch.model_flops.attention_fwd_flops`); the port computes every
    pair of the blocks, masked ones included."""
    from repro_torch.launch.model_flops import attention_fwd_flops
    mm, f32_all = lm_prefill_work(cfg, B, S)
    mm += 2.0 * B * (S - 1) * cfg.d_model * cfg.vocab
    f32 = (f32_all - cfg.num_layers * _attn_f32(cfg.attn_config(), B, S)
           + attention_fwd_flops(cfg, S, B))
    return 3 * mm, 3 * f32, 3 * f32_all


def train_main(dev, card: str) -> None:
    """16c: tinyllama-1.1b whole in bf16 at S = 4096."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import (SyntheticTokenPipeline,
                                           TokenPipelineConfig)
    from repro_torch.launch.model_flops import useful_flops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    t0 = time.perf_counter()
    mb, A, S = TRAIN_MAIN
    B = mb * A
    cfg = get_arch("tinyllama_1_1b").CONFIG
    model = build_model(cfg)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(TRAIN_SEED),
        device=dev)
    n_params = model.param_count()
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=TRAIN_SEED))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch(i).items()} for i in range(7)]
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100)
    steps = {c: make_train_step(model, TrainConfig(
        opt=opt, accum_steps=A, compress_accum=c)) for c in (False, True)}
    torch.cuda.synchronize()
    print(f"train 16c {cfg.name}: {cfg.num_layers} layers, {cfg.dtype}, "
          f"{n_params} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated "
          f"(weights and AdamW's moments); {card}")

    torch.cuda.reset_peak_memory_stats()
    times, metrics = {False: [], True: []}, []
    plan = [False] + [False] * 3 + [True] * 2
    for i, compress in enumerate(plan):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, met = steps[compress](state, batches[i])
        end.record()
        metrics.append(met)
        if i:
            times[compress].append((start, end))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    vals = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(np.isfinite([v["loss"], v["grad_norm"]]).all() for v in vals):
        raise SystemExit("FAIL train 16c: a loss or grad_norm is not finite")
    plain = [a.elapsed_time(b) for a, b in times[False]]
    comp = [a.elapsed_time(b) for a, b in times[True]]
    ms = float(np.mean(plain))
    mm, f32, f32_all = lm_train_work(cfg, B, S)
    t_mm, t_f32 = mm / BF16_OPS_PER_S * 1e3, f32 / F32_OPS_PER_S * 1e3
    t_all = t_mm + f32_all / F32_OPS_PER_S * 1e3
    useful = useful_flops(model, "train", S, B)
    bytes_w = n_params * 2
    print(f"train 16c {cfg.name} losses "
          f"{[round(v['loss'], 4) for v in vals]}, grad_norm "
          f"{[round(v['grad_norm'], 4) for v in vals]} (warm-up, 3 plain, "
          f"2 compress_accum), every one finite; {card}")
    print(f"timing train 16c {cfg.name} step (B, S) = ({B}, {S}) as "
          f"{A} microbatches of {mb}: {ms:.2f} ms a step (steps "
          f"{[round(t, 2) for t in plain]} ms), {B * S / ms * 1e3:.1f} "
          f"tokens/s; with compress_accum {[round(t, 2) for t in comp]} ms"
          f"; bound {t_mm + t_f32:.2f} ms (operations: {mm / 1e12:.2f} "
          f"TFLOP of bf16 products at 989 TFLOP/s = {t_mm:.2f} ms, plus "
          f"{f32 / 1e12:.2f} TFLOP in float32 attention over the causal "
          f"pairs at 67 TFLOP/s = {t_f32:.2f} ms, forward + backward x "
          f"3), {ms / (t_mm + t_f32):.2f}x the bound; counted over every "
          f"pair of the blocks, as the port computes them (masked ones "
          f"included, {f32_all / 1e12:.2f} TFLOP in float32), it would be "
          f"{t_all:.2f} ms; useful FLOPs (launch.model_flops) "
          f"{useful:.4g} a step = {useful / ms / 1e9:.2f} TFLOP/s, "
          f"{useful / ms / 1e9 / 989:.4f} of 989 TFLOP/s; peak allocated "
          f"{peak / 2**30:.3f} GiB: weights {bytes_w / 2**30:.3f} GiB, "
          f"AdamW's m and v {n_params * 8 / 2**30:.3f} GiB, the float32 "
          f"accumulators {n_params * 4 / 2**30:.3f} GiB, with "
          f"compress_accum the int8 buffers {n_params / 2**30:.3f} GiB and "
          f"the float32 residual {n_params * 4 / 2**30:.3f} GiB instead; "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    batch = batches[-1]
    drain_device_share(lambda: (lambda: steps[False](state, batch)),
                       f"train 16c {cfg.name} step", card, top=8)
    del model, state, batches
    free_card()


def train_loop(card: str) -> None:
    """16d: `launch.train.main` on the card: tests/test_system.py's runs."""
    import shutil

    from repro_torch.launch.train import main as train

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "train_smoke"
    shutil.rmtree(root, ignore_errors=True)
    losses = train(TRAIN_LOOP + [
        "--steps", "30", "--batch", "4", "--seq", "64", "--lr", "1e-2",
        "--ckpt-dir", str(root / "loss"), "--ckpt-every", "10",
        "--log-every", "100"])
    fall = losses[0] - losses[-1]
    args = TRAIN_LOOP + ["--batch", "2", "--seq", "32", "--lr", "1e-3",
                           "--horizon", "10", "--ckpt-every", "5",
                           "--log-every", "100"]
    full = train(["--steps", "10", "--ckpt-dir", str(root / "a")] + args)
    part = train(["--steps", "5", "--ckpt-dir", str(root / "b")] + args)
    resumed = train(["--steps", "10", "--resume",
                     "--ckpt-dir", str(root / "b")] + args)
    rtol, atol = TRAIN_RESUME_TOL
    gap = np.abs(np.asarray(full[5:]) - np.asarray(resumed))
    ok_resume = bool(np.all(gap <= atol + rtol * np.abs(full[5:])))
    print(f"train 16d launch.train: tinyllama SMOKE, 30 steps of (4, 64) at lr "
          f"1e-2: loss {losses[0]:.4f} -> {losses[-1]:.4f} (fell "
          f"{fall:.4f}, must exceed 0.3); resume: 5 steps, then 5 more "
          f"from the step-5 checkpoint against 10 uninterrupted: max "
          f"|diff| {gap.max():.4g} (rtol {rtol}, atol {atol}), the first 5 "
          f"equal {part == full[:5]}, the resumed equal "
          f"{resumed == full[5:]}; {time.perf_counter() - t0:.1f} s; "
          f"{card}")
    if not (np.isfinite(losses).all() and fall > 0.3 and ok_resume):
        raise SystemExit("FAIL train 16d: the loss did not fall by 0.3 or "
                         "the resumed run departs from the uninterrupted")


def phase_train(dev, card: str) -> dict[str, int]:
    """16: training; 16a each family's SMOKE and 16b tinyllama at full
    width (2 layers), card against CPU; 16c tinyllama-1.1b whole at S =
    4096; 16d `launch.train.main`.  No Viterbi kernel may launch."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import ARCH_IDS, get_arch

    t0 = time.perf_counter()
    kernels.reset_launches()
    B, S = TRAIN_PARITY
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_arch(arch).SMOKE, dtype=torch.float32)
        train_parity(dev, card, cfg, B, S, "16a", TRAIN_F32_TOL[arch])
    cfg = dataclasses.replace(get_arch("tinyllama_1_1b").SMOKE,
                              dtype=torch.float32)
    train_parity(dev, card, cfg, B, S, "16a",
                 TRAIN_F32_TOL["tinyllama_1_1b/compress"], compress=True)
    cfg = dataclasses.replace(get_arch("tinyllama_1_1b").CONFIG,
                              num_layers=2, dtype=torch.float32)
    train_parity(dev, card, cfg, *TRAIN_WIDTH, "16b",
                 TRAIN_F32_TOL["tinyllama_1_1b/width"],
                 prepare=fan_in_weights)
    train_main(dev, card)
    train_loop(card)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launches("train", launches, {})
    print(f"train phase: {time.perf_counter() - t0:.1f} s wall; no Viterbi "
          f"kernel launched; {card}")
    return launches


# ---------------------------------------------------------------------------
# 17: sharded training
# ---------------------------------------------------------------------------

#: 17a: the two test meshes, each with its rules' name
SHARD_MESHES = ((("data", "model"), (4, 2), "SINGLE_POD_RULES"),
                (("pod", "data", "model"), (2, 2, 2), "MULTI_POD_RULES"))
#: 17a: (B, S) of the global batch: two microbatches of 4, one row of each
#: a data rank
SHARD_PARITY = (8, 16)
#: 17a: bounds, the sharded step against the single-process step on the
#: card, float32 (TF32 off), as `TRAIN_F32_TOL`'s gaps: 1.5x an H100 probe
#: run (PERF.md §6; both meshes measured the same), the relative ones at
#: least 2.4e-7 and the weights' at least 2.4e-4 lr (two float32 ulps each:
#: a weight in [1, 2) at lr 1e-3 moves in steps of 1.19e-4 lr).  On
#: JAX's init xLSTM's SMOKE step amplifies float32 rounding to a 3.9e-2 x
#: max |m| and 2 lr gap against its own float64 step (one process, CPU),
#: and so did the sharded step against the single-process one on the card
#: (3.4e-2 and 2 lr): it is held on block matrices rescaled to std
#: 1/sqrt(d_in) (`SHARD_FAN_IN`, `fan_in_weights`), where that float64 gap
#: is 6.1e-6 and 1.2e-4 lr.  The dense family runs Megatron compute over
#: "model" (`sharding.tensor_parallel`), whose row-parallel sums and
#: vocab-parallel logsumexp order float32 reductions otherwise; each of its
#: bounds held on the card but three, raised so: gemma's grad_norm from
#: 2.4e-7 to 7.62e-6 and first moment from 1.09e-6 to 1.67e-4 (1.5x JAX's
#: own SPMD-vs-unsharded gap on the same weights and batch, 5.08e-6 and
#: 1.11e-4, tests/test_torch_train_sharded.py; the card measured 1.307e-6
#: and 1.427e-5), and tinyllama/compress's weights from 2.4e-4 to 3.22e-3
#: lr (1.5x the card's 2.146e-3: JAX's gap there, 0.999 lr, is one int8
#: quantum and would hold nothing).  xLSTM, tensor-parallel since 17e
#: joined, kept its bounds on the card (first moment 2.273e-6 x max |m|,
#: weights 5.96e-5 lr; PERF.md §6)
SHARD_TRAIN_TOL = {
    "recurrentgemma_2b": (2.4e-7, 3.71e-4, 9.14e-4, 0.027),
    "deepseek_v2_236b": (2.4e-7, 1.16e-5, 5.96e-5, 3.8e-4),
    "moonshot_v1_16b_a3b": (2.4e-7, 2.81e-5, 4.35e-4, 1.88e-3),
    "tinyllama_1_1b": (2.4e-7, 1.0e-5, 2.33e-5, 2.4e-4),
    "h2o_danube_3_4b": (2.4e-7, 2.45e-6, 2.16e-5, 2.4e-4),
    "granite_8b": (2.4e-7, 6.47e-6, 9.71e-5, 2.4e-4),
    "gemma_2b": (2.4e-7, 7.62e-6, 1.67e-4, 2.4e-4),
    "xlstm_350m": (2.4e-7, 2.4e-7, 5.31e-6, 2.4e-4),
    "hubert_xlarge": (2.4e-7, 3.31e-5, 2.4e-4, 2.4e-4),
    "llava_next_34b": (2.4e-7, 1.47e-5, 3.11e-5, 2.4e-4),
    "tinyllama_1_1b/compress": (2.4e-7, 1.73e-5, 1.18e-2, 3.22e-3),
}
#: 17a: the configs held on `fan_in_weights`
SHARD_FAN_IN = ("xlstm_350m",)
#: 17b: (data, model) ranks, rows a data rank a microbatch, accum_steps, S;
#: train_4k's global batch of 256 is cut to data x rows x accum_steps = 4,
#: and its S of 4096 to 2048: at 4096 a rank's plan is 16.9 GiB, 69 GiB
#: for four with their contexts, too close to the card's 79.18 GiB for
#: four allocators' slack (NVIDIA H100 80GB HBM3, 700.00 W; a probe at
#: 4096 ran out; PERF.md §6)
SHARD_MAIN = ((2, 2), 1, 2, 2048)
#: 17b: the train_4k cell's S and global batch that SHARD_MAIN cuts
SHARD_MAIN_CELL = (4096, 256)
#: 17b: bytes at rest a rank may hold beside its blocks: a probe (NVIDIA
#: H100 80GB HBM3, 700.00 W) measured 256 MiB more allocated from the
#: first step on, the same after every step (not the training state); a
#: whole copy of the weights would add 2.05 GiB
SHARD_REST_SLACK = 512 * 2**20
#: 17b / 17c / 17d: the steps each runs (the first a warm-up, the other
#: timed): one timed step each, as a smoke with 17b's 3 and 17c's 2 and
#: 17d's 20-22 s steps took 1 171.9 s of its 1 200 on a host whose gloo
#: ran 17b's steps in 12.8 s, not PR 27's 7.5-8.4 (NVIDIA H100 80GB HBM3,
#: 700.00 W; PERF.md §6)
SHARD_STEPS = {"17b": 2, "17c": 2, "17d": 2, "17e": 2}
#: 17c: moonshot-v1-16b-a3b at full width (bf16), tensor- and
#: expert-parallel on SHARD_MAIN's mesh, rows, accum_steps and S, at this
#: many of its 48 layers, its block matrices rescaled to std 1/sqrt(d_in)
#: (`fan_in_weights`: JAX's init draws a 3-layer stack at std 1/sqrt(3),
#: where a probe at 2 layers (std 1/sqrt(2)) gave grad_norms of 3042 in
#: float32, 3386 in bf16 and 2222 tensor-parallel, so no yardstick holds).
#: The cut, by the plan printed in the run: four ranks hold about 6 bytes
#: a parameter each in a step (blocks, float32 sums, bf16 gradients)
#: beside their activations and contexts; a probe (NVIDIA H100 80GB HBM3,
#: 700.00 W) planned 60.00 GiB at 3 layers and 72.75 GiB at 4, of 75.35
#: GiB free (0.85 of it: 64.05); the float32 single-process reference
#: (about 22 bytes a parameter) peaked at 50.99 GiB at 3 layers.  Since
#: 17e joined the smoke it runs 2 layers, for time: without 17e the whole
#: smoke took 1 099.2 s of its 1 200 on a host with slow gloo, 17e adds
#: about 45-61 s and 17c's 3 layers took 91.8 s (NVIDIA H100 80GB HBM3,
#: 700.00 W; PERF.md §6)
SHARD_MOE_LAYERS = 2
#: 17d: recurrentgemma-2b at full width (bf16), tensor-parallel on
#: SHARD_MAIN's mesh, rows, accum_steps and S, at this many of its 8
#: (rec, rec, attn) units and none of its 2 tail layers, its block
#: matrices rescaled to std 1/sqrt(d_in) (`fan_in_weights`, as 17c's).
#: The cut, by the plan printed in the run (a rank's blocks, float32
#: sums and bf16 gradients, about 6 bytes a parameter, beside one row's
#: activations and a context; NVIDIA H100 80GB HBM3, 700.00 W): alone, 6
#: units planned 68.876 GiB for four ranks against 0.85 x 78.16 GiB free
#: = 66.44, 5 units 64.003; after the smoke's earlier phases, whose
#: allocator cache of 2.648 GiB stays with this process, 5 units planned
#: 64.329 GiB against 0.85 x 75.71 = 64.354 (two whole smokes alike): a
#: margin of 0.024 GiB, so 17d ran 4 units (101.4 s of that 1 099.2 s
#: smoke).  The float32 single-process reference peaked at 50.543 GiB at 6
#: units and 45.212 at 5.  Since 17e joined the smoke, 17d runs 2 units,
#: for time (`SHARD_MOE_LAYERS`)
SHARD_GRIFFIN_UNITS = 2
#: 17e: xlstm-350m at full width (bf16), tensor-parallel on SHARD_MAIN's
#: mesh, rows and accum_steps, at this many of its 12 (mLSTM, sLSTM)
#: units and this S, its block matrices rescaled to std 1/sqrt(d_in)
#: (`fan_in_weights`: JAX's init is chaotic for xLSTM, 17a's docstring).
#: The cut is time, not memory: the sLSTM's scan and its backward launch
#: their ops once a position (PERF.md §5: 309 073 launches for one
#: (8, 512) prefill of 12 units), and four ranks share the card.  S = 512
#: is a multiple of the loss chunk (512) that takes two mLSTM chunks of
#: 256; at it a row's 512 positions are fewer than d = 1024, so the fused
#: w_up leaves move their products, not their weights (PERF.md §6)
SHARD_XLSTM_UNITS = 2
SHARD_XLSTM_S = 512


def card_settings() -> None:
    """The float settings of every phase: TF32 off, bf16 products reduced
    in float32 (`main` and every spawned rank)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def shard_cases() -> list[tuple[str, bool]]:
    from repro_torch.configs import ARCH_IDS
    return [(a, False) for a in ARCH_IDS] + [("tinyllama_1_1b", True)]


def shard_parity_cfg(arch: str):
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).SMOKE, dtype=torch.float32)


def shard_parity_tcfg(compress: bool):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig
    return TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10),
                       accum_steps=2, compress_accum=compress)


def shard_parity_init(dev, arch: str):
    """(the model of `arch`'s float32 SMOKE, its whole train state): the
    weights drawn on the card from TRAIN_SEED (`SHARD_FAN_IN`'s rescaled)."""
    from repro_torch.models import build_model
    from repro_torch.train import init_train_state

    model = build_model(shard_parity_cfg(arch))
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(TRAIN_SEED),
        device=dev)
    if arch in SHARD_FAN_IN:
        fan_in_weights(model)
    return model, state


def summed_launches(total: dict) -> dict:
    """`total` (launches on this rank) summed over the world."""
    import torch.distributed as dist
    names = sorted(total)
    summed = torch.tensor([total[k] for k in names], dtype=torch.int64)
    dist.all_reduce(summed)
    return dict(zip(names, summed.tolist()))


def shard_parity_world(dev, batches: dict) -> dict:
    """17a in one rank of the world of 8: each case's sharded step on both
    meshes; rank 0 returns the gathered states, metrics and the launches
    summed over the ranks."""
    from repro_torch import kernels
    from repro_torch.core.mesh import Mesh
    from repro_torch.data.pipeline import shard_rows
    from repro_torch.models.convert import train_state_to_numpy
    from repro_torch.sharding import rules as rule_tables
    from repro_torch.sharding.placement import data_axes, shard_train_state
    from repro_torch.train import make_train_step

    card_settings()
    kernels.reset_launches()
    B = SHARD_PARITY[0]
    out = {}
    for axes, shape, rules_name in SHARD_MESHES:
        mesh = Mesh(shape, axes)
        rules = getattr(rule_tables, rules_name)
        rows = shard_rows(B, mesh, 2, data_axes(rules, mesh))
        for arch, compress in shard_cases():
            model, state = shard_parity_init(dev, arch)
            state = shard_train_state(state, model, mesh, rules)
            step = make_train_step(model, shard_parity_tcfg(compress),
                                   mesh=mesh, rules=rules)
            state, met = step(state, {k: torch.from_numpy(v[rows]).to(dev)
                                      for k, v in batches[arch].items()})
            out[(rules_name, arch, compress)] = (
                train_state_to_numpy(state, model, mesh, rules),
                {k: float(v) for k, v in met.items()})
            del model, state
    out["launches"] = summed_launches(kernels.launch_counts())
    return out


def shard_parity(dev, card: str) -> dict[str, int]:
    """17a: the sharded step against the single-process step on the card,
    every SMOKE in float32 and tinyllama's with compress_accum, on the two
    test meshes."""
    from repro_torch.launch.mesh import run_spmd
    from repro_torch.models.convert import train_state_to_numpy
    from repro_torch.sharding.tensor_parallel import computes_on_blocks
    from repro_torch.train import make_train_step

    t0 = time.perf_counter()
    B, S = SHARD_PARITY
    batches = {arch: train_batch(shard_parity_cfg(arch),
                                 np.random.default_rng(TRAIN_SEED), B, S)
               for arch, _ in shard_cases()}
    refs, dense = {}, set()
    for arch, compress in shard_cases():
        model, state = shard_parity_init(dev, arch)
        if computes_on_blocks(model):
            dense.add(arch)
        state, met = make_train_step(model, shard_parity_tcfg(compress))(
            state, {k: torch.from_numpy(v).to(dev)
                    for k, v in batches[arch].items()})
        refs[(arch, compress)] = (train_state_to_numpy(state, model),
                                  {k: float(v) for k, v in met.items()})
    del model, state
    free_card()
    t_ref = time.perf_counter() - t0
    world = run_spmd(shard_parity_world, 8, device=dev.type,
                     backend="gloo", args=(batches,))
    bad = []
    for axes, shape, rules_name in SHARD_MESHES:
        for arch, compress in shard_cases():
            st, met = world[(rules_name, arch, compress)]
            ref_st, ref_met = refs[(arch, compress)]
            gaps, w_all, finite = step_gaps(st, met, ref_st, ref_met)
            key = arch + ("/compress" if compress else "")
            tol = SHARD_TRAIN_TOL[key]
            ok = (finite and w_all <= 2.05 and met["lr"] == ref_met["lr"]
                  and all(g <= t for g, t in zip(gaps, tol)))
            weights = (", block matrices rescaled to std 1/sqrt(d_in)"
                       if arch in SHARD_FAN_IN else "")
            weights += (", Megatron compute over model"
                        if arch in dense else
                        ", compute replicated over model")
            print(f"train sharded 17a {key} on {dict(zip(axes, shape))} "
                  f"({rules_name}), float32, (B, S) = ({B}, {S}), "
                  f"accum_steps 2{weights}: loss {met['loss']:.6f} (sharded) "
                  f"{ref_met['loss']:.6f} (one process); sharded - one "
                  f"process: loss rel {gaps[0]:.4g}, grad_norm rel "
                  f"{gaps[1]:.4g}, first moment {gaps[2]:.4g} x max |m|, "
                  f"weights {gaps[3]:.4g} lr where the gradient is "
                  f"resolved ({w_all:.4g} lr anywhere; bound 2.05); bounds "
                  f"{tuple(float(f'{t:.3g}') for t in tol)}; {card}")
            if not ok:
                bad.append(f"{key} on {rules_name}")
    print(f"train sharded 17a: references {t_ref:.1f} s, world of 8 "
          f"{time.perf_counter() - t0 - t_ref:.1f} s wall (spawn "
          f"included); launches summed over ranks "
          f"{ {k: v for k, v in world['launches'].items() if v} }; {card}")
    if bad:
        raise SystemExit(f"FAIL train sharded 17a: the sharded step != the "
                         f"single-process step: {bad}")
    return world["launches"]


def spec_share_bytes(model, mesh, rules) -> int:
    """A rank's bytes of the training state under `train_state_specs`:
    each leaf's bytes over the ranks its spec shards it over."""
    from repro_torch.sharding.placement import data_axes
    from repro_torch.train import abstract_train_state, train_state_specs

    specs = train_state_specs(model, rules,
                              mesh.axis_size(data_axes(rules, mesh)))

    def walk(t, spec):
        if isinstance(t, dict):
            return sum(walk(t[k], spec[k]) for k in t)
        n = t.numel() * t.element_size()
        for ax in spec:
            if ax is not None:
                n //= mesh.axis_size(ax)
        return n
    return walk(abstract_train_state(model), specs)


def seeded_shards(dev, model, mesh, rules, rescale: bool) -> dict:
    """This rank's blocks of the train state `init_train_state` makes from
    TRAIN_SEED (its block matrices through `fan_in_weights` if `rescale`):
    the weights drawn whole on the card, the zero moments never made whole
    (cut from an expanded zero, each block a copy)."""
    from torch.utils._pytree import tree_map

    from repro_torch.sharding.placement import shard_train_state

    model.init(torch.Generator(device=dev).manual_seed(TRAIN_SEED),
               device=dev)
    if rescale:
        fan_in_weights(model)
    params = model.tree()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    moments = [tree_map(lambda p: zero.expand(p.shape), params)
               for _ in range(2)]
    state = shard_train_state({"params": params, "opt": {
        "m": moments[0], "v": moments[1],
        "step": torch.zeros((), dtype=torch.int32, device=dev)}},
        model, mesh, rules)
    model.load(tree_map(lambda t: t.to("meta"), params))
    return state


def shard_main_world(dev, cfg, rescale: bool, batches: list) -> list:
    """17b / 17c in one rank of the world of 4: the model of `cfg`, a
    warm-up step and timed ones, one a batch; every rank's readings,
    gathered."""
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core.mesh import Mesh, axes_of
    from repro_torch.data.pipeline import shard_rows
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.placement import data_axes, state_bytes
    from repro_torch.sharding.rules import SINGLE_POD_RULES as rules
    from repro_torch.train import TrainConfig, make_train_step

    card_settings()
    kernels.reset_launches()
    shape, _, A, _ = SHARD_MAIN
    mesh = Mesh(shape, ("data", "model"))
    model = build_model(cfg)
    t0 = time.perf_counter()
    state = seeded_shards(dev, model, mesh, rules, rescale)
    free_card()
    t_init = time.perf_counter() - t0
    rows = shard_rows(len(batches[0]["tokens"]), mesh, A,
                      data_axes(rules, mesh))
    step = make_train_step(model, TrainConfig(
        opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100),
        accum_steps=A), mesh=mesh, rules=rules)
    #: "<collective> over <model | data>" -> [host seconds, calls, bytes]
    seen: dict[str, list] = {}

    def timed(name, fn):
        def call(x, axes, *args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(x, axes, *args, **kwargs)
            torch.cuda.synchronize()
            kind = "model" if "model" in axes_of(axes) else "data"
            s = seen.setdefault(f"{name} over {kind}", [0.0, 0, 0])
            s[0] += time.perf_counter() - t
            s[1] += 1
            s[2] += x.numel() * x.element_size()
            return out
        return call
    for name in ("all_reduce_sum", "all_reduce_max", "all_gather"):
        setattr(mesh, name, timed(name, getattr(mesh, name)))
    torch.cuda.reset_peak_memory_stats()
    readings, rest = [], []
    for batch in batches:
        local = {k: torch.from_numpy(v[rows]).to(dev)
                 for k, v in batch.items()}
        torch.cuda.synchronize()
        c0 = {k: list(v) for k, v in seen.items()}
        t = time.perf_counter()
        state, met = step(state, local)
        torch.cuda.synchronize()
        readings.append((time.perf_counter() - t, {
            k: tuple(a - b for a, b in zip(v, c0.get(k, (0.0, 0, 0))))
            for k, v in seen.items()},
            float(met["loss"]), float(met["grad_norm"])))
        del local, met
        rest.append(torch.cuda.memory_allocated())
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    free_card()
    mine = {"rank": dist.get_rank(), "coord": mesh.coord,
            "readings": readings, "peak": peak, "reserved": reserved,
            "init_s": t_init,
            "rest": torch.cuda.memory_allocated(), "rest_steps": rest,
            "blocks": state_bytes(state),
            "share": spec_share_bytes(model, mesh, rules),
            "meta": all(p.is_meta for p in model.parameters()),
            "launches": summed_launches(kernels.launch_counts())}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def shard_main_refs(dev, cfg, rescale: bool, batch: dict, A: int):
    """17b / 17c's single-process steps on the global batch from the
    seeded weights (`seeded_shards`'): (the float32 step's metrics, from
    the bf16 weights cast to float32, and its peak bytes; the bf16 step's
    metrics and its peak bytes)."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import TrainConfig, make_train_step

    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                       total_steps=100), accum_steps=A)
    local = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    model = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(TRAIN_SEED), device=dev)
    if rescale:
        fan_in_weights(model)
    torch.cuda.reset_peak_memory_stats()
    wide = model.cast(torch.float32)
    for p in wide.parameters():
        p.requires_grad_(True)
    met = make_train_step(wide, tcfg)(
        {"params": wide.tree(), "opt": adamw.init_state(wide.tree())},
        local)[1]
    ref32 = {k: float(v) for k, v in met.items()}
    peak32 = torch.cuda.max_memory_allocated()
    del wide, met
    free_card()
    torch.cuda.reset_peak_memory_stats()
    for p in model.parameters():      # init_train_state's state
        p.requires_grad_(True)
    params = model.tree()
    state, met = make_train_step(model, tcfg)(
        {"params": params, "opt": adamw.init_state(params)}, local)
    ref = {k: float(v) for k, v in met.items()}
    peak = torch.cuda.max_memory_allocated()
    del model, params, state, met, local
    free_card()
    return ref32, peak32, ref, peak


def xlstm_model_gathers(cfg) -> int:
    """17e's gathers over "model" a step: a unit's sLSTM gate weights in
    forward and the remat's recomputation, and its two fused w_up products'
    exchange in forward, the remat and backward, each microbatch."""
    A = SHARD_MAIN[2]
    return cfg.num_layers // 2 * A * (2 + 2 * 3)


def shard_main(dev, card: str, cfg, tag: str, rescale: bool = False,
               S: int = SHARD_MAIN[3]) -> dict[str, int]:
    """17b (tinyllama-1.1b whole), 17c (moonshot-v1-16b-a3b at full
    width, `SHARD_MOE_LAYERS` layers, rescaled), 17d (recurrentgemma-2b
    at full width, `SHARD_GRIFFIN_UNITS` units, rescaled) and 17e
    (xlstm-350m at full width, `SHARD_XLSTM_UNITS` units at S =
    `SHARD_XLSTM_S`, rescaled): `cfg` in bf16, tensor-parallel (MoE
    expert-parallel) on (data 2, model 2), 4 ranks sharing the card,
    against single-process steps."""
    import dataclasses

    from repro_torch.data.pipeline import (SyntheticTokenPipeline,
                                           TokenPipelineConfig)
    from repro_torch.launch.mesh import run_spmd
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    (dp, tp), rows, A, _ = SHARD_MAIN
    B = dp * rows * A
    label = f"{tag} {cfg.name}"
    pipe = SyntheticTokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=TRAIN_SEED))
    batches = [pipe.batch(i) for i in range(SHARD_STEPS[tag])]
    n = build_model(cfg).param_count()
    ref32, ref32_peak, ref, ref_peak = shard_main_refs(
        dev, cfg, rescale, batches[0], A)
    # the plan: a rank holds its blocks (weights / tp, AdamW's m and v
    # / (dp tp)), and in a step the float32 sums of its blocks, a
    # microbatch's bf16 gradients of them and one row's activations, which
    # the single-process step (B / A rows a microbatch, whole bf16 weights,
    # float32 sums and bf16 gradients) shows; activations grow with S
    held = 2 * n + 8 * n + 4 * n + 2 * n
    act_row = max(ref_peak - held, 0) / (B // A)

    def rank_plan(n, act):
        return 2 * n / tp + 8 * n / (dp * tp) + 4 * n / tp + 2 * n / tp + act
    plan = rank_plan(n, rows * act_row)
    free, total = torch.cuda.mem_get_info()
    # each rank's context: what this process holds beside its allocator's
    # cache (the CUDA context, the libraries); the cache, which `free`
    # already leaves out, stays with this process alone
    held_here = torch.cuda.memory_reserved()
    context = total - free - held_here
    need = dp * tp * (plan + context)
    cell_s, cell_b = SHARD_MAIN_CELL
    need_cell = dp * tp * (rank_plan(n, rows * act_row * cell_s / S)
                           + context)
    scaled = (", block matrices rescaled to std 1/sqrt(d_in)" if rescale
              else "")
    deeper = ""
    if tag in ("17c", "17d", "17e"):
        # one layer (a unit: 3 layers, xLSTM's 2) more: the ranks' plan
        # and the float32 reference's peak grow by their bytes a parameter
        # of its parameters, the activations by the share of its layers
        more = cfg.num_layers + {"17d": 3, "17e": 2}.get(tag, 1)
        n1 = build_model(dataclasses.replace(
            cfg, num_layers=more)).param_count()
        act1 = rows * act_row * more / cfg.num_layers
        need1 = dp * tp * (rank_plan(n1, act1) + context)
        deeper = (f"; at {more} layers ({n1} parameters) "
                  f"{dp * tp} ranks about {need1 / 2**30:.3f} GiB and the "
                  f"float32 reference about "
                  f"{(ref32_peak + 22 * (n1 - n)) / 2**30:.3f} GiB")
    print(f"train sharded {tag} plan: train_4k's global batch of {cell_b} "
          f"cut to {B} ({rows} row a data rank a microbatch, accum_steps "
          f"{A}), its S of {cell_s} cut to {S}; {cfg.name} at "
          f"{cfg.num_layers} layers, {n} parameters{scaled}; "
          f"single-process step "
          f"on the {B} rows (microbatches of {B // A}): peak "
          f"{ref_peak / 2**30:.3f} GiB (float32 {ref32_peak / 2**30:.3f} "
          f"GiB), so one row's activations about {act_row / 2**30:.3f} GiB;"
          f" a rank's peak with tensor parallelism about "
          f"{plan / 2**30:.3f} GiB beside a context of "
          f"{context / 2**30:.3f} GiB, {dp * tp} ranks {need / 2**30:.3f} "
          f"GiB of the {free / 2**30:.2f} GiB free (this process's cache "
          f"{held_here / 2**30:.3f} GiB, of it allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f}) of the card's "
          f"{total / 2**30:.2f} GiB; at S = {cell_s} {dp * tp} ranks about "
          f"{need_cell / 2**30:.3f} GiB ("
          f"{'within' if need_cell <= 0.85 * free else 'over'} 0.85 of the "
          f"free memory){deeper}; {card}")
    if need > 0.85 * free:
        raise SystemExit(f"FAIL train sharded {tag}: the plan does not fit "
                         f"the card; cut S")
    want_gathers = xlstm_model_gathers(cfg) if tag == "17e" else 0
    t1 = time.perf_counter()
    every = run_spmd(shard_main_world, dp * tp, device=dev.type,
                     backend="gloo", args=(cfg, rescale, batches))
    t_world = time.perf_counter() - t1
    first = every[0]["readings"][0]
    SEEN[tag] = {"timed": every[0]["readings"][1], "peak": every[0]["peak"]}

    def gaps(loss, gn, to):
        return (abs(loss - to["loss"]) / abs(to["loss"]),
                abs(gn - to["grad_norm"]) / to["grad_norm"])
    tp_gaps = gaps(first[2], first[3], ref32)
    bf16_gaps = gaps(ref["loss"], ref["grad_norm"], ref32)
    bounds = tuple(max(1.5 * g, 2.4e-7) for g in bf16_gaps)
    old_gaps = gaps(first[2], first[3], ref)
    losses = [r[2] for r in every[0]["readings"]]
    bad = []
    metrics = [[r[2:] for r in w["readings"]] for w in every]
    if any(m != metrics[0] for m in metrics):
        bad.append("the ranks report different losses or grad_norms")
    if not np.isfinite(losses).all():
        bad.append("a loss is not finite")
    if not all(g <= b for g, b in zip(tp_gaps, bounds)):
        bad.append("the first step departs from the float32 step further "
                   "than the bf16 single-process step does")
    timed_steps = len(every[0]["readings"]) - 1
    for w in every:
        timed = w["readings"][1:]
        step_ms = [1e3 * r[0] for r in timed]
        share = [sum(v[0] for v in r[1].values()) / r[0] for r in timed]
        kinds = "; ".join(
            f"{k} {np.mean([1e3 * r[1][k][0] for r in timed]):.1f} ms in "
            f"{timed[0][1][k][1]} calls, {timed[0][1][k][2] / 1e9:.3f} GB"
            for k in sorted(timed[0][1]))
        gathers = [r[1].get("all_gather over model", (0, 0, 0))[1]
                   for r in w["readings"]]
        print(f"timing train sharded {tag} rank {w['rank']} {w['coord']}: "
              f"init and placement {w['init_s']:.1f} s; warm-up "
              f"{1e3 * w['readings'][0][0]:.1f} ms, steps "
              f"{[round(t, 1) for t in step_ms]} ms (host clock, "
              f"synchronised), {np.mean(step_ms):.1f} ms a step, "
              f"{B * S / np.mean(step_ms) * 1e3:.1f} tokens/s over the "
              f"world; in collectives {[round(x, 4) for x in share]} of "
              f"each step ({kinds} a step; gathers over model in each of "
              f"the {timed_steps + 1} steps: {gathers}, {want_gathers} "
              f"expected); state at rest "
              f"{w['blocks'] / 2**30:.4f} GiB (the specs' share "
              f"{w['share'] / 2**30:.4f} GiB), allocated at rest "
              f"{w['rest'] / 2**30:.4f} GiB (after each step "
              f"{[round(x / 2**30, 4) for x in w['rest_steps']]}), peak "
              f"{w['peak'] / 2**30:.3f} GiB (reserved "
              f"{w['reserved'] / 2**30:.3f} GiB); model weights released "
              f"{w['meta']}; {card}")
        if w["blocks"] != w["share"] or \
                w["rest"] > w["share"] + SHARD_REST_SLACK or not w["meta"]:
            bad.append(f"rank {w['rank']} holds more than its share")
        if any(n != want_gathers for n in gathers):
            bad.append(f"rank {w['rank']} gathered over model {gathers} "
                       f"times, not {want_gathers} a step")
    print(f"train sharded {label}: {cfg.num_layers} layers, bf16,"
          f" {n} parameters, Megatron compute on (data {dp}, model {tp}); "
          f"losses {[round(x, 4) for x in losses]} (warm-up, {timed_steps} "
          f"timed), every one finite; first step against the float32 "
          f"single-process step (loss {ref32['loss']:.6f}, grad_norm "
          f"{ref32['grad_norm']:.4f}): loss {first[2]:.6f} (rel "
          f"{tp_gaps[0]:.4g}), grad_norm {first[3]:.4f} (rel "
          f"{tp_gaps[1]:.4g}); the bf16 single-process step's own gaps to it"
          f" {bf16_gaps[0]:.4g}, {bf16_gaps[1]:.4g}, so bounds "
          f"({bounds[0]:.4g}, {bounds[1]:.4g}); against the bf16 "
          f"single-process step (loss {ref['loss']:.6f}, grad_norm "
          f"{ref['grad_norm']:.4f}, not held): rel {old_gaps[0]:.4g}, "
          f"{old_gaps[1]:.4g}; world of {dp * tp} {t_world:.1f} s wall "
          f"(spawn included), {tag} {time.perf_counter() - t0:.1f} s wall; "
          f"{card}")
    if bad:
        raise SystemExit(f"FAIL train sharded {tag}: {bad}")
    return every[0]["launches"]


def phase_train_sharded(dev, card: str) -> dict[str, int]:
    """17: sharded training; 17a parity on the two test meshes, 17b
    tinyllama-1.1b whole, 17c moonshot-v1-16b-a3b, 17d recurrentgemma-2b
    and 17e xlstm-350m at full width on 4 ranks.  No Viterbi kernel may
    launch."""
    import dataclasses

    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    launches = shard_parity(dev, card)
    for tag, cfg, rescale, S in (
            ("17b", get_arch("tinyllama_1_1b").CONFIG, False, SHARD_MAIN[3]),
            ("17c", dataclasses.replace(get_arch("moonshot_v1_16b_a3b")
                                        .CONFIG,
                                        num_layers=SHARD_MOE_LAYERS), True,
             SHARD_MAIN[3]),
            ("17d", dataclasses.replace(get_arch("recurrentgemma_2b").CONFIG,
                                        num_layers=3 * SHARD_GRIFFIN_UNITS),
             True, SHARD_MAIN[3]),
            ("17e", dataclasses.replace(get_arch("xlstm_350m").CONFIG,
                                        num_layers=2 * SHARD_XLSTM_UNITS),
             True, SHARD_XLSTM_S)):
        for name, k in shard_main(dev, card, cfg, tag, rescale,
                                  S).items():
            launches[name] += k
    check_launches("train sharded", launches, {})
    print(f"train sharded phase: {time.perf_counter() - t0:.1f} s wall; no "
          f"Viterbi kernel launched in any rank; {card}")
    return launches


# ---------------------------------------------------------------------------
# 18: the dry run against the card
# ---------------------------------------------------------------------------

#: 18: rank 0's predicted peak may lie this far from 17b's measured one
DRYRUN_PEAK_TOL = 0.10


def dryrun_predict() -> dict:
    """18, in a host process of its own (it does no card work): the dry
    run's counts (`repro_torch.launch.dryrun.train_cell`, `launch.op_cost`)
    of 17b's cell (tinyllama-1.1b, `SHARD_MAIN`, its optimiser settings)
    and of 11a's 2-D FLASH decode at `TP_MESH`, `TP_T` and `SERVE_K`
    (`dryrun_viterbi.flash_2d_cell`, shard "row"), each as rank 0 of a fake
    world of 4 on fake tensors."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, dryrun_viterbi
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.rules import SINGLE_POD_RULES
    from repro_torch.train import TrainConfig

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    (dp, tp), rows, A, S = SHARD_MAIN
    B = dp * rows * A
    mesh = fake_world(dp * tp, shape=(dp, tp), axes=("data", "model"))
    batch = {k: torch.empty((B, S), dtype=d, device="meta") for k, d in (
        ("tokens", torch.int32), ("labels", torch.int32),
        ("mask", torch.float32))}
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                       total_steps=100), accum_steps=A)
    cost, state_b, batch_b = dryrun.train_cell(
        build_model(get_arch("tinyllama_1_1b").CONFIG), mesh,
        SINGLE_POD_RULES, batch, tcfg)
    t1 = time.perf_counter()
    mesh2 = fake_world(SHARD_RANKS, shape=TP_MESH, axes=("data", "model"))
    vcost = dryrun_viterbi.flash_2d_cell(mesh2, SERVE_K, TP_T, "row")
    return {"coll": cost.collective_rows(), "peak": cost.peak,
            "args": state_b + batch_b, "flops": cost.flops,
            "fused": cost.fused_bytes, "eager": cost.eager_bytes,
            "ops": cost.ops,
            "launches": {k: v[0] for k, v in vcost.launches.items()},
            "train_s": t1 - t0, "viterbi_s": time.perf_counter() - t1}


def phase_dryrun(card: str, pred: dict) -> None:
    """18: the dry run's prediction `pred` (`dryrun_predict`, computed
    beside the kernels' build and the bitwise kernel checks, which read no
    clock) against the card: (a) per (collective, axis) the
    calls and bytes of 17b's timed step on rank 0, exactly; (b) rank 0's
    peak within `DRYRUN_PEAK_TOL` of 17b's ``max_memory_allocated``; (c)
    each kernel entry's predicted launches of one 2-D decode, times the
    ranks, 11a's counted launches of that decode.  Prints the predicted
    flops beside 17b's step time as a share of the bf16 peak."""
    t0 = time.perf_counter()
    timed = SEEN["17b"]["timed"]
    measured = {k: (v[1], v[2]) for k, v in timed[1].items() if v[1]}
    predicted = {k: tuple(v) for k, v in pred["coll"].items()}
    bad = []
    for k in sorted(set(measured) | set(predicted)):
        m, p = measured.get(k, (0, 0)), predicted.get(k, (0, 0))
        print(f"dryrun 18a {k}: predicted {p[0]} calls, {p[1]} bytes; 17b "
              f"rank 0's timed step {m[0]} calls, {m[1]} bytes"
              f"{'' if m == p else ' (DIFFER)'}")
        if m != p:
            bad.append(f"18a {k}")
    peak = SEEN["17b"]["peak"]
    off = pred["peak"] / peak - 1.0
    print(f"dryrun 18b rank 0's peak: predicted {pred['peak']} bytes "
          f"({pred['peak'] / 2**30:.4f} GiB; arguments {pred['args']} "
          f"bytes), 17b's max_memory_allocated {peak} bytes "
          f"({peak / 2**30:.4f} GiB): {off:+.4f} of it (bound "
          f"+-{DRYRUN_PEAK_TOL}); {card}")
    if abs(off) > DRYRUN_PEAK_TOL:
        bad.append("18b peak")
    want = {k: v for k, v in SEEN["11a decode_2d"].items() if v}
    got = {k: n * SHARD_RANKS for k, n in pred["launches"].items()}
    print(f"dryrun 18c one 2-D decode (T,K)=({TP_T},{SERVE_K}) on "
          f"{TP_MESH}: predicted launches a rank {pred['launches']}, x "
          f"{SHARD_RANKS} ranks {got}; 11a counted {want}")
    if got != want:
        bad.append("18c launches")
    step_s = timed[0]
    print(f"dryrun 18 flops: predicted {pred['flops']:.6g} a rank a step "
          f"({pred['ops']} ops, fused bytes {pred['fused']:.6g}, eager "
          f"bytes {pred['eager']:.6g}); 17b rank 0's timed step "
          f"{step_s * 1e3:.1f} ms (host clock), so "
          f"{pred['flops'] / (step_s * BF16_OPS_PER_S):.5f} of "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s; the prediction took "
          f"{pred['train_s']:.1f} + {pred['viterbi_s']:.1f} s in its own "
          f"process, this phase {time.perf_counter() - t0:.1f} s more; "
          f"{card}")
    if bad:
        raise SystemExit(f"FAIL dryrun 18: {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # bf16 products reduce in float32 (phase 12 prints what allowing the
    # reduced-precision reductions changes)
    card_settings()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 18's prediction runs in a host process of its own beside the build
    # and the bitwise kernel checks, which time nothing, and is done before
    # the first phase that reads a clock
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        pending = pool.submit(dryrun_predict)
        for name, log in build.build_all().items():
            print(f"built {name} "
                  f"({build.library_path(build.CSRC / (name + '.cu'))})")
            for line in log.splitlines():
                if "ptxas" in line or "spill" in line:
                    print(f"  {line.strip()}")

        errs = phase_kernels(dev)
        errs |= phase_masked_kernels(dev)
        e, op_launches = phase_beam_tropical_kernels(dev)
        errs |= e | phase_beam_passes(dev)
        for name, e in phase_stream_kernels(dev).items():
            errs[name] = max(errs.get(name, 0.0), e)
        t_wait = time.perf_counter()
        predicted = pending.result(timeout=900)
        print(f"dryrun 18 prediction ready, "
              f"{time.perf_counter() - t_wait:.1f} s waited for it")
    launches = phase_serve(dev)
    for phase in (phase_lexicon, phase_map_matching, phase_flash_bs_serve,
                  phase_flash_bs_lexicon, phase_paper_workload,
                  phase_streaming, phase_inflight):
        for name, n in phase(dev).items():
            launches[name] += n
    errs["tropical_matmul_batch"] = max(errs["tropical_matmul_batch"],
                                        phase_tp_kernel(dev))
    for phase in (phase_sharded, phase_load, phase_e2e, phase_examples):
        for name, n in phase(dev, card).items():
            launches[name] += n
    resources = phase_gate(dev, card)
    for name, n in op_launches.items():
        launches[name] += n
    timing = phase_timing(dev, card) | phase_stream_timing(dev, card)
    for phase in (phase_lm, phase_recurrent):
        for name, n in phase(dev, card).items():
            launches[name] += n
    for phase in (phase_train, phase_train_sharded):
        for name, n in phase(dev, card).items():
            launches[name] += n
    phase_dryrun(card, predicted)

    csrc = "src/repro_torch/kernels/csrc/"
    replaces = {
        "viterbi_fwd_batch": ("viterbi_dp.cu",
                              "src/repro/kernels/viterbi_dp.py:45"),
        "viterbi_fwd_batch_masked": ("viterbi_dp.cu",
                                     "src/repro/kernels/viterbi_dp.py:120"),
        "viterbi_banded_fwd": ("viterbi_dp.cu", "src/repro/kernels/ops.py:360"),
        "viterbi_backtrack_batch": ("viterbi_dp.cu",
                                    "src/repro/kernels/ops.py:213"),
        "beam_step_batch": ("beam_stream.cu",
                            "src/repro/kernels/beam_stream.py:60"),
        "bs_initial_pass_batch": ("beam_stream.cu",
                                  "src/repro/kernels/beam_stream.py:60"),
        "bs_segment_decode_batch": ("beam_stream.cu",
                                    "src/repro/kernels/beam_stream.py:60"),
        "bs_chunk_batch": ("beam_stream.cu", "src/repro/core/online.py:443"),
        "tropical_matmul_batch": ("tropical.cu",
                                  "src/repro/kernels/tropical.py:30")}
    kernels = [dict(name=name, route="cuda", source=csrc + src,
                    replaces=where, launches=launches[name],
                    max_abs_err=errs[name], **timing[name], library_ms=None)
               for name, (src, where) in replaces.items()]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall, the "
          f"kernels' build included")
    print(card_line())
    print(json.dumps({"resources": resources}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
