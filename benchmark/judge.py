"""The comparison that decides ``correct``: the program's emitted chunks
against the plain reference's, worked out from the same input.

For each checked chunk ``k`` of a stream (and the chunk before it), the
reference computes from the stream's input alone what the step's stages
give before SOLA: the model's audio at the device rate with the input's
envelope mixed in, ``o_k`` (:meth:`Reference.outputs`). SOLA's tail from
chunk ``k-1`` is ``o_{k-1}`` read past the offset the program chose for
that chunk (the offset at which the emitted ``e_{k-1}``'s body fits
``o_{k-1}`` best). Chunk ``k``'s own offset is the reference's: the one at
which its SOLA score against that tail is highest. The reference so builds
the whole emitted chunk ``r_k``, the crossfade included, and holds the
program to it. Two numbers are compared:

- ``audio_err``: the median, over the checked chunks, of ``||e_k - r_k|| /
  ||r_k||``. It reads the precision of every layer: a program one
  precision down reads several times a sound one's;
- ``chunks_off``: the share of the checked chunks that are off: whose own
  error is over the configuration's ``chunk_limit``, or whose offset, the
  one at which ``e_k``'s body fits ``o_k`` best, scores more than
  ``sola_margin`` below the reference's in the normalised correlation SOLA
  maximises, divided by the tail's norm (``sola_gap``, a cosine in
  ``[0, 2]``; 0 where both chose alike). A fault confined to some streams
  or some chunks (a slot answered with another's audio, every other chunk
  wrong) leaves the median as a sound run's and shows here, and so does a
  SOLA that takes an offset its search would not.

A chunk whose output is not finite, or that never came back, fails the run
on its own (``failed``).
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference.step import Reference, crossfade, sola_scores
from benchmark.traffic.generate import history

#: chunks of input before the checked one that the rings still hold
HISTORY = 9
#: the numbers compared, each against the configuration's limit of that name
COMPARED = ("audio_err", "chunks_off")


def fitted_offset(emitted: torch.Tensor, out: torch.Tensor, sola: int, search: int) -> torch.Tensor:
    """``[B]``: the offset at which ``emitted``'s body (past the crossfaded head) fits ``out`` best."""
    body = emitted[:, sola:]
    n = body.shape[1]
    win = out[:, sola : sola + n + search].unfold(-1, n, 1)  # [B, search+1, n]
    return torch.argmin(((win - body[:, None]) ** 2).sum(-1), dim=-1)


@torch.no_grad()
def compare(ref: Reference, signal: torch.Tensor, checked: list, chunk_limit: float, sola_margin: float,
            block: int = 16) -> dict:
    """``checked``: ``[(stream, k, emitted_k, emitted_{k-1} or None), ...]``
    (emitted chunks as float32 arrays of ``chunk`` samples). Returns the
    numbers compared and the per-chunk readings."""
    g = ref.geo
    dev = signal.device
    need = sorted({(s, j) for s, k, _, _ in checked for j in (k - 1, k) if j >= 0})
    outs = {}
    for i in range(0, len(need), block):
        part = need[i : i + block]
        hist = torch.stack([history(signal, s, j, g.chunk, HISTORY) for s, j in part])
        o = ref.outputs(hist, torch.full((len(part),), HISTORY - 1, device=dev))
        outs.update({key: o[r] for r, key in enumerate(part)})
    errs, gapv = [], []
    for s, k, e_k, e_prev in checked:
        e_k = torch.as_tensor(e_k, device=dev, dtype=torch.float32)[None]
        o_k = outs[(s, k)][None]
        if k > 0:
            o_prev = outs[(s, k - 1)][None]
            e_prev = torch.as_tensor(e_prev, device=dev, dtype=torch.float32)[None]
            d_prev = fitted_offset(e_prev, o_prev, g.sola, g.search)
            tail = torch.gather(o_prev, 1, d_prev[:, None] + g.chunk + torch.arange(g.sola, device=dev))
        else:
            tail = torch.zeros(1, g.sola, device=dev)
        scores = sola_scores(o_k, tail, g.search)[0]
        d_ref = torch.argmax(scores)[None]
        r_k, _ = crossfade(o_k, tail, d_ref, g.chunk)
        errs.append(float(torch.linalg.vector_norm(e_k - r_k) / torch.linalg.vector_norm(r_k).clamp(min=1e-12)))
        tn = float(torch.linalg.vector_norm(tail))
        d_k = fitted_offset(e_k, o_k, g.sola, g.search)
        gapv.append(float(scores[d_ref[0]] - scores[d_k[0]]) / tn if tn > 0 else 0.0)
    off = sum(e > chunk_limit or gap > sola_margin for e, gap in zip(errs, gapv))
    return {"audio_err": statistics.median(errs), "chunks_off": off / len(errs),
            "per_chunk": {"audio_err": errs, "sola_gap": gapv}}
