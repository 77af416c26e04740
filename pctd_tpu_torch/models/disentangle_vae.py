"""DisentangleVAE (``pctd_tpu/models/disentangle_vae.py``): chord + texture
encoders -> latents -> argmax PianoTree decode and the latent-control API
behind the four workflows; the teacher-forced forward (``run``) and the
training loss (ELBO + auxiliary chord loss, the 11 ``METRIC_NAMES``).

- ``swap``             decode with posterior means from mixed sources
- ``posterior_sample`` sample around the posterior, optional sigma scaling
- ``prior_sample``     replace chord and/or texture latent with N(0, scale^2)
- ``interp``           SLERP on normalized latents + log-linear norm ramp

Pure functions over a params tree (JAX names and layouts), with noise from
an explicit ``torch.Generator``. The loss takes its latent noise and teacher
coins as inputs (:class:`Noise`, drawn by :func:`draw_noise`), since the
JAX package's key splits cannot be reproduced in torch. The pianotree
texture encoder is not ported yet; only ``compute_dtype="float32"`` runs.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.models import chord_decoder as chd_dec
from pctd_tpu_torch.models import chord_encoder as chd_enc
from pctd_tpu_torch.models import pianotree_decoder as pt_dec
from pctd_tpu_torch.models import texture_encoder as txt_enc
from pctd_tpu_torch.ops import DiagNormal, kl_std_normal
from pctd_tpu_torch.ops.losses import cross_entropy_mean
from pctd_tpu_torch.utils.device import resolve_device
from pctd_tpu_torch.utils.weights import params_to


def _check_served(cfg: ModelConfig) -> None:
    if cfg.txt_encoder != "conv":
        raise NotImplementedError(
            f"texture encoder {cfg.txt_encoder!r}: the port serves 'conv'")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r}: the port serves float32")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters with the JAX package's distributions, drawn on the
    CPU from ``seed`` (so a seed names the same model on every device) and
    moved to ``device`` (default ``cuda``). Holds the whole model:
    ``chd_enc``, ``txt_enc``, ``dec`` and the training-only ``chd_dec``
    (drawn last, so a seed gives the served modules the same weights as
    before it was added)."""
    _check_served(cfg)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {"chd_enc": chd_enc.init(gen, cfg),
              "txt_enc": txt_enc.init_conv(gen, cfg),
              "dec": pt_dec.init(gen, cfg),
              "chd_dec": chd_dec.init(gen, cfg)}
    return params_to(params, device)


def encode(params: dict, cfg: ModelConfig, pr_mat: torch.Tensor,
           c: torch.Tensor) -> Tuple[DiagNormal, DiagNormal]:
    """Posterior distributions (chord, texture)."""
    _check_served(cfg)
    return (chd_enc.apply(params["chd_enc"], c),
            txt_enc.apply_conv(params["txt_enc"], pr_mat))


def encode_chord(params: dict, cfg: ModelConfig, c: torch.Tensor
                 ) -> DiagNormal:
    """Chord latent alone from an expanded (B, 8, 36) chord tensor."""
    _check_served(cfg)
    return chd_enc.apply(params["chd_enc"], c)


def decode_z(params: dict, cfg: ModelConfig, z_chd: torch.Tensor,
             z_rhy: torch.Tensor, frame_decoder: str = "full", fw=None
             ) -> torch.Tensor:
    """Argmax decode of latents -> estimated grid (B, 32, K-1, 6) int32;
    ``frame_decoder`` and ``fw`` as in
    :func:`~pctd_tpu_torch.models.pianotree_decoder.decode_grid`."""
    _check_served(cfg)
    z = torch.cat([z_chd, z_rhy], dim=-1)
    return pt_dec.decode_grid(params["dec"], cfg, z,
                              frame_decoder=frame_decoder, fw=fw)


def inference(params: dict, cfg: ModelConfig, pr_mat, c, sample: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Encode -> (posterior draw | mean) -> decode."""
    dist_chd, dist_rhy = encode(params, cfg, pr_mat, c)
    if sample:
        z_chd, z_rhy = (dist_chd.rsample(generator),
                        dist_rhy.rsample(generator))
    else:
        z_chd, z_rhy = dist_chd.mean, dist_rhy.mean
    return decode_z(params, cfg, z_chd, z_rhy)


def swap(params: dict, cfg: ModelConfig, pr_mat1, pr_mat2, c1, c2,
         fix_rhy: bool, fix_chd: bool) -> torch.Tensor:
    """Compositional style transfer: texture from source 1 if ``fix_rhy``
    else 2, chord from source 1 if ``fix_chd`` else 2."""
    return inference(params, cfg, pr_mat1 if fix_rhy else pr_mat2,
                     c1 if fix_chd else c2, sample=False)


def posterior_sample(params: dict, cfg: ModelConfig,
                     generator: torch.Generator, pr_mat, c,
                     scale: Optional[float] = None, sample_chd: bool = True,
                     sample_txt: bool = True) -> torch.Tensor:
    """Variation by sampling around the posterior (std scaled by
    ``scale``)."""
    dist_chd, dist_rhy = encode(params, cfg, pr_mat, c)
    if scale is not None:
        dist_chd = DiagNormal(dist_chd.mean, dist_chd.std * scale)
        dist_rhy = DiagNormal(dist_rhy.mean, dist_rhy.std * scale)
    z_chd = dist_chd.rsample(generator) if sample_chd else dist_chd.mean
    z_rhy = dist_rhy.rsample(generator) if sample_txt else dist_rhy.mean
    return decode_z(params, cfg, z_chd, z_rhy)


def prior_sample(params: dict, cfg: ModelConfig, generator: torch.Generator,
                 pr_mat, c, sample_chd: bool = False,
                 sample_rhy: bool = False, scale: float = 1.0
                 ) -> torch.Tensor:
    """Replace the chord and/or texture latent with N(0, scale^2) draws;
    the other is drawn from its posterior."""
    dist_chd, dist_rhy = encode(params, cfg, pr_mat, c)
    if sample_chd:
        dist_chd = DiagNormal(torch.zeros_like(dist_chd.mean),
                              torch.full_like(dist_chd.std, scale))
    if sample_rhy:
        dist_rhy = DiagNormal(torch.zeros_like(dist_rhy.mean),
                              torch.full_like(dist_rhy.std, scale))
    return decode_z(params, cfg, dist_chd.rsample(generator),
                    dist_rhy.rsample(generator))


METRIC_NAMES = ("loss", "recon_loss", "pl", "dl", "kl_loss", "kl_chd",
                "kl_rhy", "chord_loss", "root_loss", "chroma_loss",
                "bass_loss")


class Noise(NamedTuple):
    """The random inputs of one loss evaluation: standard-normal latent noise
    and the batch-global teacher coins."""
    eps_chd: torch.Tensor   # (B, chd_z_dim)
    eps_rhy: torch.Tensor   # (B, txt_z_dim)
    coins1: torch.Tensor    # (T,) bool: gt frame summary as next time token
    coins2: torch.Tensor    # (T, K) bool: gt note as next slot token
    coins3: torch.Tensor    # (chord steps,) bool: gt beat as next token


def draw_noise(gen: torch.Generator, cfg: ModelConfig, batch: int, tfr1,
               tfr2, tfr3) -> Noise:
    """A :class:`Noise` drawn from ``gen`` on its device: coins are
    ``U(0, 1) < tfr`` per time step, note slot and chord beat."""
    spec = cfg.pianotree
    dev = gen.device
    normal = lambda d: torch.randn((batch, d), generator=gen, device=dev)
    uni = lambda *s: torch.rand(s, generator=gen, device=dev)
    return Noise(normal(cfg.chd_z_dim), normal(cfg.txt_z_dim),
                 uni(spec.num_step) < tfr1,
                 uni(spec.num_step, spec.max_simu_note) < tfr2,
                 uni(cfg.chord.num_step) < tfr3)


def forward_parts(params: dict, cfg: ModelConfig, x, c, pr_mat,
                  noise: Noise):
    """Everything of the teacher-forced forward except the PianoTree decode:
    note embeddings, encoders, z and the chord-decoder logits. Returns
    (x_emb, lengths, dist_chd, dist_rhy, z, recon_chd)."""
    x_emb, lengths = pt_dec.emb_x(params["dec"], x, cfg.pianotree)
    dist_chd, dist_rhy = encode(params, cfg, pr_mat, c)
    z_chd = dist_chd.rsample_eps(noise.eps_chd)
    z = torch.cat([z_chd, dist_rhy.rsample_eps(noise.eps_rhy)], dim=-1)
    recon_chd = chd_dec.apply(params["chd_dec"], z_chd, c, noise.coins3,
                              cfg.chord.num_step)
    return x_emb, lengths, dist_chd, dist_rhy, z, recon_chd


def chord_loss(c: torch.Tensor, recon_root, recon_chroma, recon_bass):
    """Root / chroma / bass CE against the expanded chord c (B, 8, 36)."""
    root = c[:, :, 0:12].argmax(-1)
    chroma = c[:, :, 12:24].to(torch.int64)
    bass = c[:, :, 24:].argmax(-1)
    root_l = cross_entropy_mean(recon_root, root)
    chroma_l = cross_entropy_mean(recon_chroma, chroma)
    bass_l = cross_entropy_mean(recon_bass, bass)
    return root_l + chroma_l + bass_l, root_l, chroma_l, bass_l


def run(params: dict, cfg: ModelConfig, x, c, pr_mat, noise: Noise):
    """Teacher-forced forward pass (the JAX package's ``run``): x (B, 32,
    K, 6) int grid, c (B, 8, 36), pr_mat (B, 32, 128). Returns
    (:class:`~pctd_tpu_torch.models.pianotree_decoder.DecoderOutput`,
    dist_chd, dist_rhy, recon_root, recon_chroma, recon_bass); the decode
    runs frame by frame through the K1/K2 kernel pair in logits-out mode on
    the card."""
    x_emb, lengths, dist_chd, dist_rhy, z, recon_chd = forward_parts(
        params, cfg, x, c, pr_mat, noise)
    out = pt_dec.decode(params["dec"], cfg, z, x_emb, lengths, noise.coins1,
                        noise.coins2)
    return (out, dist_chd, dist_rhy, *recon_chd)


def loss(params: dict, cfg: ModelConfig, x, c, pr_mat, noise: Noise,
         beta=0.1, weights=(1.0, 0.5), weighted_dur: bool = False
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ELBO + auxiliary chord loss: (total, the 11 metrics by
    ``METRIC_NAMES``). x (B, 32, K, 6) int grid, c (B, 8, 36), pr_mat
    (B, 32, 128). The decode runs frame by frame through the K1/K2 kernel
    pair on the card: with ``cfg.fused_loss`` in loss mode, the CE fused in
    (:func:`~pctd_tpu_torch.models.pianotree_decoder.decode_recon`), else
    in logits-out mode through :func:`run`, scored by
    :func:`~pctd_tpu_torch.models.pianotree_decoder.recon_loss`."""
    if cfg.fused_loss:
        x_emb, lengths, dist_chd, dist_rhy, z, recon_chd = forward_parts(
            params, cfg, x, c, pr_mat, noise)
        recon, pl, dl = pt_dec.decode_recon(
            params["dec"], cfg, z, x_emb, lengths, noise.coins1,
            noise.coins2, x, weights, weighted_dur)
    else:
        out, dist_chd, dist_rhy, *recon_chd = run(params, cfg, x, c, pr_mat,
                                                  noise)
        recon, pl, dl = pt_dec.recon_loss(x, out, cfg.pianotree, weights,
                                          weighted_dur)
    kl_chd = kl_std_normal(dist_chd)
    kl_rhy = kl_std_normal(dist_rhy)
    kl = kl_chd + kl_rhy
    chord, root_l, chroma_l, bass_l = chord_loss(c, *recon_chd)
    total = recon + beta * kl + chord
    metrics = dict(zip(METRIC_NAMES, (total, recon, pl, dl, kl, kl_chd,
                                      kl_rhy, chord, root_l, chroma_l,
                                      bass_l)))
    return total, metrics


def interp_path(z1: np.ndarray, z2: np.ndarray, int_count: int = 10
                ) -> np.ndarray:
    """SLERP on normalized directions + log-linear norm interpolation,
    host-side numpy on small latents."""
    shape = z1.shape
    z1 = z1.reshape(-1)
    z2 = z2.reshape(-1)
    n1, n2 = np.linalg.norm(z1), np.linalg.norm(z2)
    u1, u2 = z1 / n1, z2 / n2
    omega = np.arccos(np.clip(np.dot(u1, u2), -1.0, 1.0))
    so = np.sin(omega)
    t = np.linspace(0.0, 1.0, int_count)
    if so < 1e-8:
        dirs = (1 - t)[:, None] * u1[None] + t[:, None] * u2[None]
    else:
        dirs = (np.sin((1 - t) * omega)[:, None] / so * u1[None] +
                np.sin(t * omega)[:, None] / so * u2[None])
    norms = np.exp(np.linspace(np.log(n1), np.log(n2), int_count))
    return (dirs * norms[:, None]).reshape((int_count,) + shape)


def interp_latents(z1: np.ndarray, z2: np.ndarray, on: bool,
                   int_count: int) -> np.ndarray:
    """(B, d) endpoints -> (B, int_count, d): per-row SLERP paths when
    ``on``, else z1 repeated."""
    if on:
        return np.stack([interp_path(a, b, int_count)
                         for a, b in zip(z1, z2)])
    return np.repeat(z1[:, None], int_count, axis=1)


def interp(params: dict, cfg: ModelConfig, pr_mat1, c1, pr_mat2, c2,
           interp_chd: bool = False, interp_rhy: bool = False,
           int_count: int = 10) -> np.ndarray:
    """Latent interpolation decode -> (B, int_count, 32, K-1, 6)."""
    d_chd1, d_rhy1 = encode(params, cfg, pr_mat1, c1)
    d_chd2, d_rhy2 = encode(params, cfg, pr_mat2, c2)
    np_ = lambda t: t.detach().cpu().numpy()
    B = pr_mat1.shape[0]
    z_chds = interp_latents(np_(d_chd1.mean), np_(d_chd2.mean), interp_chd,
                            int_count)
    z_rhys = interp_latents(np_(d_rhy1.mean), np_(d_rhy2.mean), interp_rhy,
                            int_count)
    dev = pr_mat1.device
    as_t = lambda a: torch.as_tensor(a.reshape(B * int_count, -1),
                                     dtype=torch.float32, device=dev)
    est = decode_z(params, cfg, as_t(z_chds), as_t(z_rhys))
    spec = cfg.pianotree
    return np_(est).reshape(B, int_count, spec.num_step,
                            spec.max_simu_note - 1, 6)


class DisentangleVAE:
    """cfg + params + the latent-control entry points."""

    def __init__(self, cfg: ModelConfig, params: dict):
        _check_served(cfg)
        self.cfg = cfg
        self.params = params

    @staticmethod
    def init_model(cfg: Optional[ModelConfig] = None, seed: int = 0,
                   device=None) -> "DisentangleVAE":
        cfg = cfg or ModelConfig()
        return DisentangleVAE(cfg, init_params(cfg, seed, device))

    def encode(self, pr_mat, c):
        return encode(self.params, self.cfg, pr_mat, c)

    def run(self, x, c, pr_mat, noise: Noise):
        return run(self.params, self.cfg, x, c, pr_mat, noise)

    def decode_z(self, z_chd, z_rhy, frame_decoder: str = "full"):
        return decode_z(self.params, self.cfg, z_chd, z_rhy, frame_decoder)

    def inference(self, pr_mat, c, sample: bool = False, generator=None):
        return inference(self.params, self.cfg, pr_mat, c, sample, generator)

    def swap(self, pr_mat1, pr_mat2, c1, c2, fix_rhy, fix_chd):
        return swap(self.params, self.cfg, pr_mat1, pr_mat2, c1, c2,
                    fix_rhy, fix_chd)

    def posterior_sample(self, generator, pr_mat, c, **kw):
        return posterior_sample(self.params, self.cfg, generator, pr_mat, c,
                                **kw)

    def prior_sample(self, generator, pr_mat, c, **kw):
        return prior_sample(self.params, self.cfg, generator, pr_mat, c, **kw)

    def interp(self, pr_mat1, c1, pr_mat2, c2, **kw):
        return interp(self.params, self.cfg, pr_mat1, c1, pr_mat2, c2, **kw)
