"""Serving sampler (``pctd_tpu/models/sampler.py``): the four latent-control
workflows over a fixed batch shape, with numpy results.

``fixed_batch=N`` pads every encode/decode batch up to N rows (zeros) and
slices the result back; larger requests run in N-row chunks. The decode
launches the chosen kernel: ``frame_decoder="full"`` (K4, the default) or
``"frame"`` (K3 per frame, time GRU in torch). On the card the Sampler
launches that kernel or raises: there is no fallback chain, and no CPU
fallback when no card is found (``device="cpu"`` must be asked for, and
then runs the kernels' plain versions).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.ops import DiagNormal
from pctd_tpu_torch.ops.kernels.ar_decoder import folded_frame_weights
from pctd_tpu_torch.utils.device import resolve_device
from pctd_tpu_torch.utils.weights import params_to


def _map(fn, out):
    """Apply ``fn`` to a tensor or to each field of a DiagNormal pair."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    return tuple(DiagNormal(*map(fn, d)) for d in out)


class Sampler:
    def __init__(self, params: dict, cfg: ModelConfig,
                 frame_decoder: str = "full",
                 fixed_batch: Optional[int] = None, device=None):
        if frame_decoder not in ("full", "frame"):
            raise ValueError(f"frame_decoder must be 'full' or 'frame', "
                             f"got {frame_decoder!r}")
        if fixed_batch is not None and fixed_batch < 1:
            raise ValueError(f"fixed_batch must be positive, got "
                             f"{fixed_batch}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.frame_decoder = frame_decoder
        self.fixed_batch = fixed_batch
        self.params = params_to(params, self.device)
        # the serving folds depend on the weights only: fold once
        self.fw = folded_frame_weights(self.params["dec"], cfg)

    def _tensor(self, a) -> torch.Tensor:
        """A request array (numpy or tensor) as float32 on the device."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return a.to(self.device, torch.float32)

    def _chunked(self, fn, *arrays):
        """Run ``fn`` over fixed_batch-row zero-padded chunks of the arrays
        (axis 0) and concatenate the un-padded results."""
        n = arrays[0].shape[0]
        if n == 0:
            raise ValueError("empty batch")
        fb = self.fixed_batch
        if fb is None:
            return fn(*arrays)
        outs = []
        for lo in range(0, n, fb):
            take = min(fb, n - lo)
            chunk = [a[lo:lo + take] if take == fb else torch.cat(
                [a[lo:lo + take], a.new_zeros((fb - take,) + a.shape[1:])])
                for a in arrays]
            outs.append(_map(lambda t: t[:take], fn(*chunk)))
        if len(outs) == 1:
            return outs[0]
        if isinstance(outs[0], torch.Tensor):
            return torch.cat(outs)
        return tuple(DiagNormal(*(torch.cat(ts) for ts in zip(*dists)))
                     for dists in zip(*outs))

    def encode(self, pr_mat, c):
        """(B, 32, 128) duration matrices and (B, 8, 36) chords ->
        (chord, texture) posteriors on the device."""
        return self._chunked(
            lambda pm, cc: dv.encode(self.params, self.cfg, pm, cc),
            self._tensor(pr_mat), self._tensor(c))

    def decode(self, z_chd, z_rhy) -> np.ndarray:
        """Latents -> estimated grids (B, 32, K-1, 6) int32, as numpy."""
        grid = self._chunked(
            lambda zc, zr: dv.decode_z(self.params, self.cfg, zc, zr,
                                       self.frame_decoder, self.fw),
            self._tensor(z_chd), self._tensor(z_rhy))
        return grid.cpu().numpy()

    def reconstruct(self, pr_mat, c, sample: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> np.ndarray:
        d_chd, d_rhy = self.encode(pr_mat, c)
        if sample:
            return self.decode(d_chd.rsample(generator),
                               d_rhy.rsample(generator))
        return self.decode(d_chd.mean, d_rhy.mean)

    # -- the four workflows --------------------------------------------------

    def swap(self, pr_mat1, pr_mat2, c1, c2, fix_rhy: bool, fix_chd: bool
             ) -> np.ndarray:
        """Compositional style transfer."""
        return self.reconstruct(pr_mat1 if fix_rhy else pr_mat2,
                                c1 if fix_chd else c2)

    def posterior_sample(self, generator: torch.Generator, pr_mat, c,
                         scale: Optional[float] = None,
                         sample_chd: bool = True, sample_txt: bool = True
                         ) -> np.ndarray:
        """Texture/chord variation around the posterior."""
        d_chd, d_rhy = self.encode(pr_mat, c)
        if scale is not None:
            d_chd = d_chd._replace(std=d_chd.std * scale)
            d_rhy = d_rhy._replace(std=d_rhy.std * scale)
        z_chd = d_chd.rsample(generator) if sample_chd else d_chd.mean
        z_rhy = d_rhy.rsample(generator) if sample_txt else d_rhy.mean
        return self.decode(z_chd, z_rhy)

    def prior_sample(self, generator: torch.Generator, pr_mat, c,
                     sample_chd: bool = False, sample_rhy: bool = False,
                     scale: float = 1.0) -> np.ndarray:
        """Prior replacement of the chord and/or texture latent."""
        d_chd, d_rhy = self.encode(pr_mat, c)
        z_chd = (DiagNormal(torch.zeros_like(d_chd.mean),
                            torch.full_like(d_chd.std, scale))
                 if sample_chd else d_chd).rsample(generator)
        z_rhy = (DiagNormal(torch.zeros_like(d_rhy.mean),
                            torch.full_like(d_rhy.std, scale))
                 if sample_rhy else d_rhy).rsample(generator)
        return self.decode(z_chd, z_rhy)

    def interp(self, pr_mat1, c1, pr_mat2, c2, interp_chd: bool = False,
               interp_rhy: bool = False, int_count: int = 10) -> np.ndarray:
        """Chord/texture SLERP interpolation -> (B, int_count, 32, K-1, 6)."""
        d_chd1, d_rhy1 = self.encode(pr_mat1, c1)
        d_chd2, d_rhy2 = self.encode(pr_mat2, c2)
        np_ = lambda t: t.cpu().numpy()
        B = d_chd1.mean.shape[0]
        zcs = dv.interp_latents(np_(d_chd1.mean), np_(d_chd2.mean),
                                interp_chd, int_count)
        zrs = dv.interp_latents(np_(d_rhy1.mean), np_(d_rhy2.mean),
                                interp_rhy, int_count)
        est = self.decode(zcs.reshape(B * int_count, -1),
                          zrs.reshape(B * int_count, -1))
        spec = self.cfg.pianotree
        return est.reshape(B, int_count, spec.num_step,
                           spec.max_simu_note - 1, 6)
