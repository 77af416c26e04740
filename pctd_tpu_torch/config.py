"""Model configuration: a copy of the JAX package's ``PianoTreeSpec``,
``ChordSpec``, ``ModelConfig``, ``TrainConfig`` and ``tiny_model_config``
(``pctd_tpu/config.py``), kept here because the port may not import
``pctd_tpu``. Field names and defaults are the JAX package's, so a config
can be rebuilt from the other package's ``dataclasses.asdict``.
``DataConfig`` (the corpus settings) is a copy of the JAX package's too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PianoTreeSpec:
    """Vocabulary / shape contract of the PianoTree grid: 32 time steps x
    <=16 simultaneous-note slots, pitch column with sos/eos/pad specials,
    5-bit binary duration with pad=2."""

    num_step: int = 32
    max_simu_note: int = 16
    max_pitch: int = 127
    min_pitch: int = 0
    pitch_sos: int = 128
    pitch_eos: int = 129
    pitch_pad: int = 130
    dur_pad: int = 2
    dur_width: int = 5

    @property
    def pitch_range(self) -> int:
        """Number of pitch classes excluding pad."""
        return self.max_pitch - self.min_pitch + 3

    @property
    def note_size(self) -> int:
        return self.pitch_range + self.dur_width


@dataclasses.dataclass(frozen=True)
class ChordSpec:
    """8 beat steps x 36-d expanded chord [root 1-hot | chroma | bass 1-hot]."""

    num_step: int = 8
    dim: int = 36


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """DisentangleVAE architecture. Every field of the JAX package's
    ``ModelConfig`` is kept (so configs round-trip between the packages);
    the port reads the widths, ``txt_encoder``, ``compute_dtype`` and
    ``fused_loss``. The port's loss always decodes frame by frame through
    the train-frame kernel pair (the JAX ``train_frame_kernel=True``
    configuration), whatever ``train_frame_kernel`` says: with
    ``fused_loss=True`` the pair runs in loss mode, the reconstruction CE
    fused in (``pianotree_decoder.decode_recon``); with ``fused_loss=False``
    in logits-out mode, through the teacher-forced ``pianotree_decoder.
    decode`` and ``disentangle_vae.run``, and ``recon_loss`` scores the
    logits. ``remat_frames`` and ``unroll_*`` are XLA switches with no
    counterpart here.

    ``compute_dtype`` is "float32" or "bfloat16". bf16 (the JAX package's
    mixed-precision policy, ``pctd_tpu_torch.utils.precision``) is taken by
    the training entry points (``disentangle_vae.loss`` and ``run``,
    ``train.trainer.Trainer``, with the train-frame kernels K1/K2 in their
    bf16 mode on the card), by ``disentangle_vae.encode`` and by the K3
    serving route (``frame_decoder="frame"``); the K4 route decodes in
    float32 only.

    ``txt_encoder`` is "conv" or "pianotree" (the PtvaeEncoder over the
    detrended grid, ``ptenc_*`` widths). The pianotree variant runs at
    ``pianotree.num_step`` 32 only (the detrend's layout); the conv variant
    also at the 32-bar stretch (``PianoTreeSpec(num_step=128)`` with
    ``ChordSpec(num_step=32)``, the corpus of ``DataConfig(num_bar=8)``)."""

    chd_z_dim: int = 256
    txt_z_dim: int = 256
    chd_enc_hidden: int = 1024
    txt_encoder: str = "conv"
    txt_conv_channels: int = 10
    txt_emb_size: int = 256
    txt_enc_hidden: int = 1024
    ptenc_max_pitch: int = 31
    ptenc_min_pitch: int = 0
    ptenc_note_emb: int = 128
    ptenc_notes_hidden: int = 256
    ptenc_time_hidden: int = 512
    chd_dec_hidden: int = 512
    chd_dec_z_in: int = 256
    note_emb_size: int = 128
    dec_emb_hidden: int = 128
    dec_time_hidden: int = 1024
    dec_notes_hidden: int = 512
    dec_z_in: int = 256
    dec_dur_hidden: int = 64
    pianotree: PianoTreeSpec = dataclasses.field(default_factory=PianoTreeSpec)
    chord: ChordSpec = dataclasses.field(default_factory=ChordSpec)
    compute_dtype: str = "float32"
    remat_frames: bool = False
    unroll_dur: int = 1
    unroll_notes: int = 1
    train_frame_kernel: bool = False
    fused_loss: bool = True

    @property
    def z_dim(self) -> int:
        return self.chd_z_dim + self.txt_z_dim

    @property
    def ptenc_pitch_range(self) -> int:
        return self.ptenc_max_pitch - self.ptenc_min_pitch + 3

    @property
    def ptenc_note_size(self) -> int:
        return self.ptenc_pitch_range + self.pianotree.dur_width


def check_config(cfg: ModelConfig, frame_decoder: Optional[str] = None
                 ) -> None:
    """Raise unless the port runs ``cfg``: a texture encoder of "conv" or
    "pianotree" (the latter at 32 steps) and a ``compute_dtype`` of float32
    or bfloat16. The decode entry points name their ``frame_decoder``:
    ``"full"`` (the K4 kernel) decodes in float32 only, ``"frame"`` (the K3
    kernel) in either dtype."""
    if cfg.txt_encoder not in ("conv", "pianotree"):
        raise ValueError(f"texture encoder {cfg.txt_encoder!r}: the port "
                         "runs 'conv' and 'pianotree'")
    if cfg.txt_encoder == "pianotree" and cfg.pianotree.num_step != 32:
        raise ValueError(
            f"texture encoder 'pianotree' at num_step="
            f"{cfg.pianotree.num_step}: its detrended grid is laid out as 8 "
            "beats x 4 steps = 32 steps (the JAX package's detrend, "
            "pctd_tpu/data/detrend.py:98,136), so the variant runs at "
            "num_step=32 only; the stretch runs with txt_encoder='conv'")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: the port "
                         "runs 'bfloat16' and 'float32'")
    if frame_decoder is None:
        return
    if frame_decoder not in ("full", "frame"):
        raise ValueError(f"frame_decoder must be 'full' or 'frame', "
                         f"got {frame_decoder!r}")
    if frame_decoder == "full" and cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"frame_decoder='full' decodes in float32 only, not "
            f"{cfg.compute_dtype!r}: the JAX package's K4 has no bf16 mode "
            "(decode_grid_fused carries the time hidden through its "
            "fori_loop in bf16 while _gru_pre returns f32, "
            "pctd_tpu/ops/pallas/full_decoder.py:113,125-127, so it raises "
            "in bf16); serve bf16 with frame_decoder='frame' (K3)")


def tiny_model_config(**overrides) -> ModelConfig:
    """Miniature dims for CPU tests: the canonical topology at ~1000x fewer
    FLOPs (the same values as the JAX package's ``tiny_model_config``)."""
    return dataclasses.replace(
        ModelConfig(), chd_z_dim=8, txt_z_dim=8, chd_enc_hidden=12,
        txt_emb_size=12, txt_enc_hidden=12, chd_dec_hidden=12,
        chd_dec_z_in=8, note_emb_size=12, dec_emb_hidden=8,
        dec_time_hidden=16, dec_notes_hidden=12, dec_z_in=8,
        dec_dur_hidden=8, **overrides)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the JAX package's ``TrainConfig``, same
    fields and defaults). ``accum_steps=0`` is automatic, as in the JAX
    package: just enough microbatches that each stays inside the step
    envelope measured on the card, scaled to the device's memory
    (``train.trainer.auto_accum_steps``)."""

    batch_size: int = 128
    n_epoch: int = 6
    lr: float = 1e-3
    lr_decay: float = 0.9999
    lr_min: float = 1e-5
    clip_norm: float = 1.0
    beta: float = 0.1
    weights: Tuple[float, float] = (1.0, 0.5)
    # (high, low) pairs for tfr1 / tfr2 / tfr3
    tf_rates: Tuple[Tuple[float, float], ...] = ((0.6, 0.0), (0.5, 0.0),
                                                 (0.5, 0.0))
    sched_horizon: float = 1.0
    seed: int = 3345
    weighted_dur: bool = False
    # True: validate at the schedules' final values instead of the current
    eval_fixed_schedule: bool = False
    accum_steps: int = 0
    result_root: str = "result"
    save_every_epoch: bool = True


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Corpus / tensorization settings (the JAX package's ``DataConfig``,
    same fields and defaults). ``ref_meter_filter=True`` keeps the songs of
    ``num_beats_per_measure == 2`` (the reference's literal filter) instead
    of ``== ts``."""

    data_path: str = "data/POP09-PIANOROLL-4-bin-quantization"
    index_path: str = "data/index.xlsx"
    seed: int = 3345
    portion: int = 8            # train:val = portion:1
    shift_low: int = -6
    shift_high: int = 5
    num_bar: int = 2
    ts: int = 4                 # beats per bar
    contain_chord: bool = True
    ref_meter_filter: bool = False
