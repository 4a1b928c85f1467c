"""Forced-alignment serving head: emissions -> Viterbi paths, as in
`repro.serving.alignment`.

The head is a thin wrapper around `core.ViterbiDecoder`: the alignment config
resolves to a typed `DecodeSpec`, and the decoder object owns the device and
the ragged `lengths` contract.  `make_lexicon_align_head` adds a
`LexiconConstraint` to the spec.  The default profile is FLASH-BS, as in the
JAX package.  With ``mesh=`` the request bucket shards over the mesh's
``data_axis`` (`ViterbiDecoder.decode_sharded`).

`make_e2e_align_step` is the serving step of the hubert cells: the encoder
forward (`models.TransformerLM.encode`), log-softmax emissions over the
first `num_classes` logits in float32, then one batched decode of the whole
batch, as the JAX package's jitted step computes them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.constraints import LexiconConstraint, with_constraint
from ..core.decoder import ViterbiDecoder
from ..core.spec import (OnlineBeamSpec, OnlineSpec, as_decode_spec,
                         spec_from_tunables)


@dataclasses.dataclass(frozen=True)
class AlignmentConfig:
    """Legacy string-form alignment profile; `to_spec()` is the typed view.

    The default is the JAX package's serving profile: FLASH-BS with a beam of
    128, P = 8 and chunks of 128 targets.  The batched serving path runs
    whole layers at once (``lanes=None``), so that is what the conversion
    pins.
    """
    method: str = "flash_bs"       # flash | flash_bs | vanilla | fused
    beam_width: int = 128
    parallelism: int = 8
    chunk: int = 128

    def to_spec(self):
        # spec_from_tunables drops the fields `method` does not consume: the
        # container always carries all four, so no warning here.
        spec, _ = spec_from_tunables(self.method, dict(
            beam_width=self.beam_width, parallelism=self.parallelism,
            chunk=self.chunk, lanes=None))
        return spec


def make_alignment_head(hmm_log_pi, hmm_log_A, cfg, *, mesh=None,
                        data_axis: str = "data", device=None):
    """Returns align(emissions (B, T, K), lengths=None) -> (paths, scores).

    `cfg` is a `DecodeSpec` (preferred) or a legacy `AlignmentConfig`.
    `lengths` (B,) gives each request's true frame count; pad frames run as
    tropical-identity steps, so results are bit-identical to unbatched
    decodes of the unpadded payloads.  This is the `decode_batch_fn`
    contract `BatchScheduler` expects.  ``device=None`` means ``cuda``.

    With ``mesh=`` (a `core.mesh.Mesh`) the bucket shards over
    ``data_axis`` through `ViterbiDecoder.decode_sharded`, which pads a
    bucket the axis does not divide with length-1 dummy rows and slices
    them back; per-request results are unaffected.
    """
    dec = ViterbiDecoder(as_decode_spec(cfg), hmm_log_pi, hmm_log_A,
                         device=device)

    def align(em, lengths=None):
        if mesh is not None:
            return dec.decode_sharded(em, lengths, mesh=mesh,
                                      data_axis=data_axis)
        return dec.decode_batch(em, lengths)

    align.decoder = dec
    return align


def make_lexicon_align_head(hmm_log_pi, hmm_log_A, words, *, cfg=None,
                            self_loops: bool = True, loop_words: bool = True,
                            mesh=None, data_axis: str = "data", device=None):
    """Lexicon-constrained forced alignment: only lexicon arcs survive.

    `words` is the `LexiconConstraint` vocabulary: a sequence of words, each
    a sequence of pronunciation alternatives, each a state sequence (e.g.
    ``[((0, 1, 2), (0, 3, 2)), ((4, 5),)]``).  The constraint compiles the
    trie's arcs into additive {0, NEG_INF} penalties that the decode fuses
    into its DP adds, so results are bit-identical to decoding the
    `constrain_inputs`-masked HMM densely.

    `cfg` is a `DecodeSpec` or legacy `AlignmentConfig`; None means
    `AlignmentConfig()`, the FLASH-BS serving profile.  Its `constraint`
    field is replaced.  Returns the same ``align(emissions, lengths=None)``
    callable as `make_alignment_head`, with ``align.decoder`` and
    ``align.constraint`` attached; ``mesh`` / ``data_axis`` as there.
    ``device=None`` means ``cuda``.
    """
    constraint = LexiconConstraint(words, self_loops=self_loops,
                                   loop_words=loop_words)
    spec = as_decode_spec(AlignmentConfig() if cfg is None else cfg)
    align = make_alignment_head(hmm_log_pi, hmm_log_A,
                                with_constraint(spec, constraint),
                                mesh=mesh, data_axis=data_axis, device=device)
    align.constraint = constraint
    return align


def make_e2e_align_step(model, hmm, cfg, num_classes: int, *, device=None):
    """Encoder forward + log-softmax emissions + Viterbi alignment.

    The serving step for the hubert cells: ``step(batch)`` with
    ``batch = {"embeds": (B, S, d)}`` returns (paths (B, S) int32, scores
    (B,)).  `model` is a `models.TransformerLM` holding its weights on the
    step's device, with an untied head (JAX's step reads ``params["head"]``);
    `hmm` has one state a class, so K == `num_classes` <= the model's vocab.
    `cfg` is a `DecodeSpec` or legacy `AlignmentConfig`; ``device=None``
    means ``cuda``.  JAX's step also takes the parameter tree and a
    ``params_treedef_hint`` it never reads; the model owns its weights here,
    so both are dropped.

    The streaming specs (`OnlineSpec`, `OnlineBeamSpec`; JAX's
    ``jittable = False``) raise ValueError.  The decode is one
    `ViterbiDecoder.decode_batch` over the batch (for FLASH-BS one launch a
    pass for every sequence), bitwise JAX's ``jax.vmap(spec.run)`` on the
    same emissions; a spec with no batched path decodes row by row.  Like
    JAX's step, every frame attends to every other, so a row's emissions
    depend on the frames it is padded with.  The step runs under
    `torch.inference_mode`; ``step.emissions(batch)`` and
    ``step.decode(em)`` are its two halves.
    """
    spec = as_decode_spec(cfg)
    if isinstance(spec, (OnlineSpec, OnlineBeamSpec)):
        raise ValueError(f"{type(spec).__name__} is a streaming spec and "
                         f"cannot run inside the e2e step; use an offline "
                         f"spec")
    if not 1 <= num_classes <= model.cfg.vocab:
        raise ValueError(f"num_classes={num_classes} must lie in [1, vocab="
                         f"{model.cfg.vocab}]")
    if int(hmm.log_A.shape[0]) != num_classes:
        raise ValueError(f"the HMM has {int(hmm.log_A.shape[0])} states; the "
                         f"step needs one a class ({num_classes})")
    if model.head is None:
        raise ValueError("the e2e step needs a model with an untied head")
    dec = ViterbiDecoder(spec, hmm.log_pi, hmm.log_A, device=device)
    if model.head.device.type != dec.device.type:
        raise ValueError(f"the model's weights are on {model.head.device}, "
                         f"the step runs on {dec.device}")

    def emissions(batch) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(batch["embeds"], device=dec.device)
            logits = (model.encode(x) @ model.head).float()
            return torch.log_softmax(logits[..., :num_classes], dim=-1)

    def decode(em) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            if spec.batch_method is not None:
                return dec.decode_batch(em)
            rows = [dec.decode(e) for e in em]
            return (torch.stack([p for p, _ in rows]),
                    torch.stack([s for _, s in rows]))

    def step(batch) -> tuple[torch.Tensor, torch.Tensor]:
        return decode(emissions(batch))

    step.emissions, step.decode, step.decoder = emissions, decode, dec
    return step


__all__ = ["AlignmentConfig", "make_alignment_head",
           "make_lexicon_align_head", "make_e2e_align_step"]
