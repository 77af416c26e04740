"""K4: the WHOLE T-frame argmax decode in one kernel: time GRU, then each
frame's note/duration chain (K3's) and summary feedback, straight to the
grid.

Replaces the Pallas kernel
``pctd_tpu/ops/pallas/full_decoder.py::_full_kernel`` (launched by
``decode_grid_fused``). The CUDA source is ``csrc/decoder.cu``
(``full_group_kernel``: a thread-block cluster decodes a group of 16 rows,
the time GRU's units shared out over its blocks as K3's frame is), which
shares K3's device functions for the frame projection, the slot chain and
the summary; :func:`decode_grid_full_plain` is its plain PyTorch version,
built on K3's plain pieces the same way. The JAX kernel's
``dur_width <= 7`` limit came from its TPU output tile and is gone. Both
decode in float32 only: the JAX kernel has no bf16 mode (its ``fori_loop``
carry enters in bf16 and leaves in f32, so ``decode_grid_fused`` raises on
bf16 params).

A request's decode takes :func:`decode_grid_full_chunks`: one chunk is
launched alone, on its own tensors; of several fixed-batch chunks,
consecutive chunks share one launch, as many as the card runs at once in
clusters of 16 blocks (:func:`groups_at_once`, :func:`launch_runs`), each
chunk's rows on whole row groups of their own, so every row is decoded as
in a launch of its chunk alone.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from pctd_tpu_torch.config import PianoTreeSpec
from pctd_tpu_torch.ops.gru import gru_gates_pre
from pctd_tpu_torch.ops.kernels.ar_decoder import (FoldedWeights,
                                                   frame_projection,
                                                   slot_chain_plain,
                                                   summary_plain)


def decode_grid_full_plain(fw: FoldedWeights, spec: PianoTreeSpec,
                           h0: torch.Tensor, gi_z: torch.Tensor,
                           token0: torch.Tensor, sos_emb: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version of K4: the z-derived inputs (see
    :class:`~pctd_tpu_torch.models.pianotree_decoder.DecodeInputs`) ->
    grid (B, T, K-1, 6) int32 = [pitch | W dur bits] per slot. Float32
    only, as the kernel."""
    if fw.w_hh.dtype != torch.float32:
        raise TypeError(f"K4 decodes in float32 only (the JAX package's K4 "
                        f"has no bf16 mode), got {fw.w_hh.dtype} weights")
    h, token = h0, token0
    steps = []
    for _ in range(spec.num_step):
        h = gru_gates_pre(gi_z + token @ fw.wt_tok, h @ fw.wt_hh + fw.bt_hh,
                          h)
        hid, gi_frame = frame_projection(fw, h)
        pitch_idx, dur_bits, lengths = slot_chain_plain(fw, spec, hid,
                                                        gi_frame)
        token = summary_plain(fw, spec, pitch_idx, dur_bits, sos_emb,
                              lengths)
        steps.append(torch.cat([pitch_idx[..., None], dur_bits], -1))
    return torch.stack(steps, 1)


def decode_grid_full(fw: FoldedWeights, spec: PianoTreeSpec,
                     h0: torch.Tensor, gi_z: torch.Tensor,
                     token0: torch.Tensor, sos_emb: torch.Tensor,
                     cluster: int = 0) -> torch.Tensor:
    """K4 wrapper: launches ``full_group_kernel`` for CUDA tensors; a CPU
    ``h0`` takes :func:`decode_grid_full_plain`. ``cluster`` forces the
    blocks a cluster (0: ``build.decode_plan``'s). Counts its launches in
    ``decode_grid_full.launches``."""
    if h0.device.type == "cpu":
        return decode_grid_full_plain(fw, spec, h0, gi_z, token0, sos_emb)
    from pctd_tpu_torch.ops.kernels import build

    B = h0.shape[0]
    dims = build.decoder_dims(fw, spec)
    build.check_inputs(fw, h0.device, [
        ("h0", h0, (B, dims.TH)), ("gi_z", gi_z, (B, 3 * dims.TH)),
        ("token0", token0, (B, 2 * dims.EH)),
        ("sos_emb", sos_emb, (B, dims.E))], build.FULL_ENTRY)
    grid = torch.empty((B, spec.num_step, spec.max_simu_note - 1,
                        1 + spec.dur_width), dtype=torch.int32,
                       device=h0.device)
    build.launch(build.FULL_ENTRY[torch.float32], fw, dims, B,
                 [h0, gi_z, token0, sos_emb, grid], cluster=cluster)
    decode_grid_full.launches += 1
    return grid


decode_grid_full.launches = 0


def groups_at_once(fw: FoldedWeights, spec: PianoTreeSpec,
                   device: torch.device) -> Optional[int]:
    """The 16-row groups K4 decodes at once on ``device`` in clusters of
    16 blocks (``build.decode_info``'s occupancy query, the plan's
    ``at_once[16]``); None on the CPU, whose plain version has no groups."""
    if device.type == "cpu":
        return None
    from pctd_tpu_torch.ops.kernels import build

    return build.decode_info(fw, build.decoder_dims(fw, spec), True,
                             build.DECODE_CLUSTERS[0], device)[1]


def launch_runs(chunks: int, rows: int, cap: Optional[int]) -> List[int]:
    """The chunks of ``rows`` rows each K4 launch takes, in order, for
    ``chunks`` consecutive chunks: as many as fit ``cap`` 16-row groups, a
    chunk taking ⌈rows / 16⌉ groups of its own, and at least one (a chunk
    wider than ``cap`` alone is launched as it would be alone); all of them
    in one where ``cap`` is None."""
    from pctd_tpu_torch.ops.kernels import build

    per = chunks if cap is None else max(1, cap // -(-rows // build.DECODE_G))
    return [min(per, chunks - lo) for lo in range(0, chunks, per)]


def decode_grid_full_chunks(fw: FoldedWeights, spec: PianoTreeSpec,
                            chunks: Sequence[Tuple[torch.Tensor, ...]]
                            ) -> Tuple[List[torch.Tensor], int]:
    """K4 over the equal-sized chunks of one request, each given as its
    decode inputs (``h0``, ``gi_z``, ``token0``, ``sos_emb``, computed at
    the chunk's shape). One chunk is launched on its own tensors. Of more,
    consecutive chunks share a launch (:func:`launch_runs` with
    :func:`groups_at_once`), each padded with zero rows to whole 16-row
    groups on the card, so that a row takes the group position and cluster
    size it takes in its chunk's own launch (16 where the chunks fit the
    card at once; a chunk wider than that is launched alone), and its bits
    with them. Returns (each chunk's grid, the launches made)."""
    if len(chunks) == 1:
        return [decode_grid_full(fw, spec, *chunks[0])], 1
    rows = chunks[0][0].shape[0]
    cap = groups_at_once(fw, spec, chunks[0][0].device)
    if cap is None:
        width = rows
    else:
        from pctd_tpu_torch.ops.kernels import build

        width = -(-rows // build.DECODE_G) * build.DECODE_G
    pad = lambda t: (t if width == rows else torch.cat(
        [t, t.new_zeros((width - rows,) + t.shape[1:])]))
    grids, lo = [], 0
    runs = launch_runs(len(chunks), rows, cap)
    for n in runs:
        grid = decode_grid_full(fw, spec, *(
            torch.cat([pad(c[i]) for c in chunks[lo:lo + n]])
            for i in range(4)))
        grids += [grid[j * width:j * width + rows] for j in range(n)]
        lo += n
    return grids, len(runs)
