"""Model configuration: a copy of the JAX package's ``PianoTreeSpec``,
``ChordSpec``, ``ModelConfig`` and ``tiny_model_config``
(``pctd_tpu/config.py``), kept here because the port may not import
``pctd_tpu``. Field names and defaults are the JAX package's, so a config
can be rebuilt from the other package's ``dataclasses.asdict``.
``TrainConfig`` and ``DataConfig`` come with the training slice.
"""
from __future__ import annotations

import dataclasses


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
    the port reads the widths, ``txt_encoder`` and ``compute_dtype``.
    The training-only switches (``remat_frames``, ``unroll_*``,
    ``train_frame_kernel``, ``fused_loss``) take effect with the training
    slice."""

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


def tiny_model_config(**overrides) -> ModelConfig:
    """Miniature dims for CPU tests: the canonical topology at ~1000x fewer
    FLOPs (the same values as the JAX package's ``tiny_model_config``)."""
    return dataclasses.replace(
        ModelConfig(), chd_z_dim=8, txt_z_dim=8, chd_enc_hidden=12,
        txt_emb_size=12, txt_enc_hidden=12, chd_dec_hidden=12,
        chd_dec_z_in=8, note_emb_size=12, dec_emb_hidden=8,
        dec_time_hidden=16, dec_notes_hidden=12, dec_z_in=8,
        dec_dur_hidden=8, **overrides)
