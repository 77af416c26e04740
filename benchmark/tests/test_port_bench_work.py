"""The work counts of the yardstick, pinned to the shapes, and equal at
canonical widths to those ``chip_smoke.py`` computed from the program's
own weight tensors (only the f32 peak differs: 165 TFLOP/s here, 3xTF32,
against the 67 TFLOP/s of the CUDA cores there)."""
import json
from pathlib import Path

import pytest
import torch

from benchmark import work
from benchmark.reference.model import widths_of

ROOT = Path(__file__).resolve().parents[2]


def _widths(name="pctd-conv-2bar"):
    return widths_of(json.loads(
        (ROOT / "benchmark" / "configs" / f"{name}.json").read_text()))


def test_counts_scale_with_rows_and_pin_to_shapes():
    w = _widths()
    f1, b1 = work.k4_work(w, 1)
    f16, b16 = work.k4_work(w, 16)
    assert f16 == 16 * f1
    io = (w.time_h * 4 + 2 * w.emb_h + w.note_emb
          + w.T * (w.K - 1) * (1 + w.W)) * 4
    assert b16 - b1 == 15 * io
    # one frame of the folded decode at canonical widths, by hand
    macs = (1024 * 4 * 512 + 16 * 512 * 1536 + 15 * (512 * 388 + 5 * 64 * 194)
            + 16 * 2 * 256 * 384)
    assert work.frame_flops_per_row(w) == 2 * macs
    (k1f, _), (k2f, _) = work.k12_work(w, 8)
    assert k1f == 8 * work.k12_work(w, 1)[0][0]
    assert k2f - k1f == 8 * 2 * 15 * 5 * 3 * 64
    red = work.k2b_reductions(w, 4)
    assert len(red) == 16
    assert red[0] == work.Reduction(4, 1024, 512, True)
    assert work.bound_s(165e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_cover_their_parts():
    w = _widths()
    serve = work.serve_segment_flops(w)
    assert serve > work.k4_work(w, 1)[0] + work.encoder_flops(w)
    train = work.train_segment_flops(w)
    assert train / 3 > work.encoder_flops(w) + w.T * work.k12_work(w, 1)[0][0]
    pt = _widths("pctd-pianotree-2bar")
    assert work.encoder_flops(pt) > work.encoder_flops(w)


def test_counts_equal_chip_smoke_at_canonical_widths():
    import chip_smoke as cs
    from pctd_tpu_torch.config import ModelConfig
    from pctd_tpu_torch.models import disentangle_vae as dv
    from pctd_tpu_torch.ops.kernels import ar_decoder
    from pctd_tpu_torch.ops.kernels import train_frame as tf
    cfg = ModelConfig()
    w = _widths()
    with torch.no_grad():
        p = dv.init_params(cfg, seed=0, device="cpu")
        fw = ar_decoder.folded_frame_weights(p["dec"], cfg)
        cw = tf.core_weights(p["dec"], cfg)
    spec = cfg.pianotree
    for B in (16, 128, 512):
        assert work.k4_work(w, B) == cs.full_work(fw, spec, B)
        mine, theirs = work.k12_work(w, B), cs.train_frame_work(cw, spec, B)
        assert mine == theirs
        d = tf.dims_of(cw, spec)
        st = tf.new_stash(d, B, "cpu")
        ct = tf.new_cotangents(d, B, "cpu")
        grads = tf.CoreWeights(*(torch.empty_like(t) for t in cw))
        tasks = tf.wgrad_tasks(d, B, torch.empty(B, d.TH), st, ct, grads)
        assert work.k2b_work(w, B) == cs.wgrad_work(tasks)
        flops, nbytes = cs.full_work(fw, spec, B)
        ms, what = cs.bound_ms(flops, nbytes)
        assert what == "operations"
        assert work.bound_s(flops, nbytes) * 1e3 == pytest.approx(
            ms * cs.PEAK_F32_FLOPS / work.PEAK_F32_FLOPS)
