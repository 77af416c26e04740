"""K4: the WHOLE T-frame argmax decode in one kernel: time GRU, then each
frame's note/duration chain (K3's) and summary feedback, straight to the
grid.

Replaces the Pallas kernel
``pctd_tpu/ops/pallas/full_decoder.py::_full_kernel`` (launched by
``decode_grid_fused``). The CUDA source is ``csrc/decoder.cu``
(``full_kernel``), which shares K3's device functions for the slot chain and
the summary; :func:`decode_grid_full_plain` is its plain PyTorch version,
built on K3's plain pieces the same way. The JAX kernel's
``dur_width <= 7`` limit came from its TPU output tile and is gone.
"""
from __future__ import annotations

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
    grid (B, T, K-1, 6) int32 = [pitch | W dur bits] per slot."""
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
                     token0: torch.Tensor, sos_emb: torch.Tensor
                     ) -> torch.Tensor:
    """K4 wrapper: launches ``full_kernel`` for CUDA tensors; a CPU ``h0``
    takes :func:`decode_grid_full_plain`. Counts its launches in
    ``decode_grid_full.launches``."""
    if h0.device.type == "cpu":
        return decode_grid_full_plain(fw, spec, h0, gi_z, token0, sos_emb)
    from pctd_tpu_torch.ops.kernels import build

    B = h0.shape[0]
    dims = build.decoder_dims(fw, spec)
    build.check_inputs(fw, h0.device, [
        ("h0", h0, (B, dims.TH)), ("gi_z", gi_z, (B, 3 * dims.TH)),
        ("token0", token0, (B, 2 * dims.EH)),
        ("sos_emb", sos_emb, (B, dims.E))])
    grid = torch.empty((B, spec.num_step, spec.max_simu_note - 1,
                        1 + spec.dur_width), dtype=torch.int32,
                       device=h0.device)
    build.launch("pctd_full_decode", fw, dims, B,
                 [h0, gi_z, token0, sos_emb, grid])
    decode_grid_full.launches += 1
    return grid


decode_grid_full.launches = 0
