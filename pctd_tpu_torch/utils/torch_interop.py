"""Checkpoint interop with the PyTorch reference implementation (a copy of
``pctd_tpu/utils/torch_interop.py``, which imports the JAX package).

A user of the reference (ZZWaang/polyphonic-chord-texture-disentanglement)
has ``.pt`` checkpoints: ``torch.save(state_dict)`` of its
``DisentangleVAE`` (keys like ``chd_encoder.gru.weight_ih_l0``, with a
``module.`` prefix where DataParallel saved them). This module converts
them to the port's params tree and back:

- :func:`params_from_state_dict`: reference state dict -> params (the
  layout transposes: a torch Linear keeps (out, in), the port (in, out);
  torch Conv2d OIHW -> HWIO; a bidirectional GRU's ``l0``/``l0_reverse``
  -> the port's forward and backward :class:`GRUParams`), the leaves
  float32 tensors with the JAX names (:func:`utils.weights.params_from_jax`);
- :func:`state_dict_from_params`: the exact inverse, numpy values with the
  reference's names;
- :func:`load_reference_checkpoint` / :func:`save_reference_checkpoint`:
  the ``.pt`` files (``torch.load(..., weights_only=True)``).

Both texture-encoder variants are mapped: the canonical conv
``TextureEncoder`` and the PianoTree ``PtvaeEncoder``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig
from pctd_tpu_torch.ops.gru import GRUParams
from pctd_tpu_torch.utils.weights import params_from_jax


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _lin(sd, prefix):
    return {"w": _np(sd[f"{prefix}.weight"]).T, "b": _np(sd[f"{prefix}.bias"])}


def _gru(sd, prefix, reverse=False):
    sfx = "_reverse" if reverse else ""
    return {"w_ih": _np(sd[f"{prefix}.weight_ih_l0{sfx}"]).T,
            "w_hh": _np(sd[f"{prefix}.weight_hh_l0{sfx}"]).T,
            "b_ih": _np(sd[f"{prefix}.bias_ih_l0{sfx}"]),
            "b_hh": _np(sd[f"{prefix}.bias_hh_l0{sfx}"])}


def _conv(sd, prefix):
    return {"w": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0),
            "b": _np(sd[f"{prefix}.bias"])}


def strip_dataparallel(sd: Dict) -> Dict:
    """Remove the ``module.`` prefix a DataParallel save leaves behind."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):] if k.startswith("module.") else k: v
                for k, v in sd.items()}
    return sd


def detect_texture_variant(sd: Dict) -> str:
    """'conv' (the canonical TextureEncoder) or 'pianotree' (the reference
    train.py's PtvaeEncoder), from the rhy_encoder keys."""
    if "rhy_encoder.cnn.0.weight" in sd:
        return "conv"
    if "rhy_encoder.enc_notes_gru.weight_ih_l0" in sd:
        return "pianotree"
    raise ValueError("state_dict has no recognizable rhy_encoder keys")


def params_from_state_dict(sd: Dict, cfg: Optional[ModelConfig] = None,
                           device=None) -> dict:
    """Reference DisentangleVAE state dict -> the port's params tree on
    ``device`` (default ``cuda``). ``cfg`` is read only to cross-check the
    texture variant; the mapping goes by names."""
    sd = strip_dataparallel(sd)
    variant = detect_texture_variant(sd)
    if cfg is not None and cfg.txt_encoder != variant:
        raise ValueError(
            f"checkpoint is the {variant!r} texture variant but the config "
            f"says {cfg.txt_encoder!r}")

    chd_enc = {
        "gru_fwd": _gru(sd, "chd_encoder.gru"),
        "gru_bwd": _gru(sd, "chd_encoder.gru", reverse=True),
        "mu": _lin(sd, "chd_encoder.linear_mu"),
        "std": _lin(sd, "chd_encoder.linear_var"),
    }
    if variant == "conv":
        txt_enc = {
            "conv": _conv(sd, "rhy_encoder.cnn.0"),
            "fc1": _lin(sd, "rhy_encoder.fc1"),
            "fc2": _lin(sd, "rhy_encoder.fc2"),
            "gru_fwd": _gru(sd, "rhy_encoder.gru"),
            "gru_bwd": _gru(sd, "rhy_encoder.gru", reverse=True),
            "mu": _lin(sd, "rhy_encoder.linear_mu"),
            "std": _lin(sd, "rhy_encoder.linear_var"),
        }
    else:
        txt_enc = {
            "note_emb": _lin(sd, "rhy_encoder.note_embedding"),
            "notes_fwd": _gru(sd, "rhy_encoder.enc_notes_gru"),
            "notes_bwd": _gru(sd, "rhy_encoder.enc_notes_gru", reverse=True),
            "time_fwd": _gru(sd, "rhy_encoder.enc_time_gru"),
            "time_bwd": _gru(sd, "rhy_encoder.enc_time_gru", reverse=True),
            "mu": _lin(sd, "rhy_encoder.linear_mu"),
            "std": _lin(sd, "rhy_encoder.linear_std"),
        }
    dec = {
        "note_emb": _lin(sd, "decoder.note_embedding"),
        "z2hid": _lin(sd, "decoder.z2dec_hid_linear"),
        "z2in": _lin(sd, "decoder.z2dec_in_linear"),
        "emb_fwd": _gru(sd, "decoder.dec_notes_emb_gru"),
        "emb_bwd": _gru(sd, "decoder.dec_notes_emb_gru", reverse=True),
        "time_gru": _gru(sd, "decoder.dec_time_gru"),
        "time2notes": _lin(sd, "decoder.dec_time_to_notes_hid"),
        "notes_gru": _gru(sd, "decoder.dec_notes_gru"),
        "pitch_out": _lin(sd, "decoder.pitch_out_linear"),
        "dur_gru": _gru(sd, "decoder.dec_dur_gru"),
        "dur_hid": _lin(sd, "decoder.dur_hid_linear"),
        "dur_out": _lin(sd, "decoder.dur_out_linear"),
        "init_input": _np(sd["decoder.dec_init_input"]),
        "dur_sos": _np(sd["decoder.dur_sos_token"]),
    }
    chd_dec = {
        "z2hid": _lin(sd, "chd_decoder.z2dec_hid"),
        "z2in": _lin(sd, "chd_decoder.z2dec_in"),
        "gru": _gru(sd, "chd_decoder.gru"),
        "root": _lin(sd, "chd_decoder.root_out"),
        "chroma": _lin(sd, "chd_decoder.chroma_out"),
        "bass": _lin(sd, "chd_decoder.bass_out"),
        "init_input": _np(sd["chd_decoder.init_input"]),
    }
    return params_from_jax({"chd_enc": chd_enc, "txt_enc": txt_enc,
                            "dec": dec, "chd_dec": chd_dec}, device)


# -- inverse ------------------------------------------------------------------

def _lin_out(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["w"]).T
    out[f"{prefix}.bias"] = _np(p["b"])


def _gru_out(out, prefix, fwd: GRUParams, bwd: Optional[GRUParams] = None):
    pairs = [("", fwd)] + ([("_reverse", bwd)] if bwd is not None else [])
    for sfx, g in pairs:
        out[f"{prefix}.weight_ih_l0{sfx}"] = _np(g.w_ih).T
        out[f"{prefix}.weight_hh_l0{sfx}"] = _np(g.w_hh).T
        out[f"{prefix}.bias_ih_l0{sfx}"] = _np(g.b_ih)
        out[f"{prefix}.bias_hh_l0{sfx}"] = _np(g.b_hh)


def _conv_out(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["w"]).transpose(3, 2, 0, 1)
    out[f"{prefix}.bias"] = _np(p["b"])


def state_dict_from_params(params: dict) -> Dict[str, np.ndarray]:
    """The port's params tree -> the reference's state dict (numpy
    values)."""
    out: Dict[str, np.ndarray] = {}
    ce = params["chd_enc"]
    _gru_out(out, "chd_encoder.gru", ce["gru_fwd"], ce["gru_bwd"])
    _lin_out(out, "chd_encoder.linear_mu", ce["mu"])
    _lin_out(out, "chd_encoder.linear_var", ce["std"])

    te = params["txt_enc"]
    if "conv" in te:
        _conv_out(out, "rhy_encoder.cnn.0", te["conv"])
        _lin_out(out, "rhy_encoder.fc1", te["fc1"])
        _lin_out(out, "rhy_encoder.fc2", te["fc2"])
        _gru_out(out, "rhy_encoder.gru", te["gru_fwd"], te["gru_bwd"])
        _lin_out(out, "rhy_encoder.linear_mu", te["mu"])
        _lin_out(out, "rhy_encoder.linear_var", te["std"])
    else:
        _lin_out(out, "rhy_encoder.note_embedding", te["note_emb"])
        _gru_out(out, "rhy_encoder.enc_notes_gru", te["notes_fwd"],
                 te["notes_bwd"])
        _gru_out(out, "rhy_encoder.enc_time_gru", te["time_fwd"],
                 te["time_bwd"])
        _lin_out(out, "rhy_encoder.linear_mu", te["mu"])
        _lin_out(out, "rhy_encoder.linear_std", te["std"])

    d = params["dec"]
    _lin_out(out, "decoder.note_embedding", d["note_emb"])
    _lin_out(out, "decoder.z2dec_hid_linear", d["z2hid"])
    _lin_out(out, "decoder.z2dec_in_linear", d["z2in"])
    _gru_out(out, "decoder.dec_notes_emb_gru", d["emb_fwd"], d["emb_bwd"])
    _gru_out(out, "decoder.dec_time_gru", d["time_gru"])
    _lin_out(out, "decoder.dec_time_to_notes_hid", d["time2notes"])
    _gru_out(out, "decoder.dec_notes_gru", d["notes_gru"])
    _lin_out(out, "decoder.pitch_out_linear", d["pitch_out"])
    _gru_out(out, "decoder.dec_dur_gru", d["dur_gru"])
    _lin_out(out, "decoder.dur_hid_linear", d["dur_hid"])
    _lin_out(out, "decoder.dur_out_linear", d["dur_out"])
    out["decoder.dec_init_input"] = _np(d["init_input"])
    out["decoder.dur_sos_token"] = _np(d["dur_sos"])

    cd = params["chd_dec"]
    _lin_out(out, "chd_decoder.z2dec_hid", cd["z2hid"])
    _lin_out(out, "chd_decoder.z2dec_in", cd["z2in"])
    _gru_out(out, "chd_decoder.gru", cd["gru"])
    _lin_out(out, "chd_decoder.root_out", cd["root"])
    _lin_out(out, "chd_decoder.chroma_out", cd["chroma"])
    _lin_out(out, "chd_decoder.bass_out", cd["bass"])
    out["chd_decoder.init_input"] = _np(cd["init_input"])
    return out


def load_reference_checkpoint(path: str, cfg: Optional[ModelConfig] = None,
                              device=None) -> dict:
    """A reference ``.pt`` checkpoint -> params on ``device`` (default
    ``cuda``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_state_dict(sd, cfg, device)


def save_reference_checkpoint(path: str, params: dict) -> None:
    """Write params as a state dict the reference loads (``torch.save``)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v).copy())
          for k, v in state_dict_from_params(params).items()}
    torch.save(sd, path)
