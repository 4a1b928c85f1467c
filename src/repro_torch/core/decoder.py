"""`ViterbiDecoder`: a `DecodeSpec` bound to one HMM, as in `repro.core.decoder`.

    dec = ViterbiDecoder(FlashBSSpec(), log_pi, log_A)   # on cuda
    path,  score  = dec.decode(em)                       # one (T, K) sequence
    paths, scores = dec.decode_batch(ems, lengths=ln)    # ragged (B, T, K)
    paths, scores = dec.decode_sharded(ems, ln, mesh=m)  # over m's data axis

The decoder owns the device: the HMM tensors are placed on it once, and
emissions handed in as numpy arrays or tensors elsewhere are moved to it.
``device=None`` means ``cuda``, and raises without a GPU.  PyTorch runs
eagerly, so there is no compile cache.  ``make_streaming`` builds the
incremental decoder of a streaming spec on the same device;
``decode_sharded`` shards a batch over a `core.mesh.Mesh` of ranks.
"""

from __future__ import annotations

import torch

from .batch import viterbi_decode_batch
from .device import resolve_device
from .spec import DecodeSpec, as_decode_spec

__all__ = ["ViterbiDecoder"]


class ViterbiDecoder:
    """A `DecodeSpec` bound to one HMM on one device."""

    def __init__(self, spec: DecodeSpec, log_pi, log_A, device=None):
        self.spec = as_decode_spec(spec)
        self.device = resolve_device(device)
        self.log_pi = self._tensor(log_pi)
        self.log_A = self._tensor(log_A)

    def __repr__(self):
        return (f"ViterbiDecoder({self.spec!r}, K={int(self.log_A.shape[0])}, "
                f"device={self.device})")

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    # -- single sequence ----------------------------------------------------
    def decode(self, emissions) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode one (T, K) sequence -> (path (T,) int32, score)."""
        return self.spec.run(self.log_pi, self.log_A, self._tensor(emissions))

    # -- ragged batch -------------------------------------------------------
    def decode_batch(self, emissions, lengths=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode a (B, T, K) batch; `lengths` (B,) makes rows ragged.

        Inherits the `viterbi_decode_batch` contract: pad frames run as
        tropical-identity steps, so `paths[i, :lengths[i]]` is bit-identical
        to `decode(emissions[i, :lengths[i]])`.
        """
        if self.spec.batch_method is None:
            raise ValueError(
                f"{type(self.spec).__name__} has no batched path; "
                f"decode_batch needs a spec whose method is in "
                f"core.batch.BATCH_METHODS")
        return viterbi_decode_batch(
            self._tensor(emissions), self.log_pi, self.log_A, lengths,
            method=self.spec.batch_method, constraint=self.spec.constraint,
            **self.spec.batch_tunables())

    # -- mesh-sharded batch -------------------------------------------------
    def decode_sharded(self, emissions, lengths=None, *, mesh,
                       data_axis: str = "data"
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode a (B, T, K) batch sharded over `mesh`'s `data_axis`.

        Every rank of the mesh calls with the same batch and gets the whole
        result.  Buckets whose size the axis does not divide are padded up
        with length-1 dummy rows and sliced back (sequences are independent,
        so dummies change nothing): per-sequence results stay bit-identical
        to `decode_batch`.
        """
        if self.spec.batch_method is None:
            raise ValueError(
                f"{type(self.spec).__name__} has no batched path; "
                f"decode_sharded needs a spec whose method is in "
                f"core.batch.BATCH_METHODS")
        emissions = self._tensor(emissions)
        B, T = emissions.shape[:2]
        lengths = (torch.full((B,), T, dtype=torch.int32) if lengths is None
                   else torch.as_tensor(lengths, dtype=torch.int32))
        pad_b = -B % mesh.shape[data_axis]
        if pad_b:
            emissions = torch.cat(
                [emissions, emissions.new_zeros((pad_b,) + emissions.shape[1:])])
            lengths = torch.cat(
                [lengths, torch.ones((pad_b,), dtype=torch.int32,
                                     device=lengths.device)])
        paths, scores = viterbi_decode_batch(
            emissions, self.log_pi, self.log_A, lengths,
            method=self.spec.batch_method, mesh=mesh, data_axis=data_axis,
            constraint=self.spec.constraint, **self.spec.batch_tunables())
        return paths[:B], scores[:B]

    # -- streaming ----------------------------------------------------------
    def make_streaming(self):
        """Stateful incremental decoder for the streaming specs."""
        mk = getattr(self.spec, "make_streaming", None)
        if mk is None:
            raise ValueError(
                f"{type(self.spec).__name__} is not a streaming spec; use "
                f"OnlineSpec / OnlineBeamSpec")
        return mk(self.log_pi, self.log_A)
