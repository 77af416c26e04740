"""K2b's work plan and arithmetic on the CPU.

K2b (``wgrad_kernel`` and ``wgrad_reduce_kernel`` in
``pctd_tpu_torch/ops/kernels/csrc/train_frame.cu``) runs only on a CUDA card.
What it computes is fixed here: the plan that cuts its 16 reductions into
work items (:func:`train_frame.wgrad_plan`) covers every (i, o, n) once with
items of about one length, and an emulation of the kernel's arithmetic (the
planned N-slices, the fixed-order slice sum, 3xTF32 or 2xTF32 products with
TF32 rounding done by bit masking) lands within the f64 gate that a
single-pass TF32 product misses. The kernel itself is held against its plain
version on the card (``tests/test_torch_port_gpu.py``, ``chip_smoke.py``).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctd_tpu_torch.config import ModelConfig, tiny_model_config
from pctd_tpu_torch.ops.kernels import build
from pctd_tpu_torch.ops.kernels import train_frame as tf

CU = Path(tf.__file__).resolve().parent / "csrc" / "train_frame.cu"
F64_TOL = 1e-5   # K2b vs f64: max|err| <= F64_TOL x (1 + max|f64|)


def _dims(cfg) -> tf.Dims:
    spec = cfg.pianotree
    return tf.Dims(TH=cfg.dec_time_hidden, NH=cfg.dec_notes_hidden,
                   DH=cfg.dec_dur_hidden, E=cfg.note_emb_size,
                   EH=cfg.dec_emb_hidden, P=spec.pitch_range,
                   W=spec.dur_width, K=spec.max_simu_note,
                   eos=spec.pitch_eos, pitch_pad=spec.pitch_pad,
                   dur_pad=spec.dur_pad)


def _weight_shapes(d: tf.Dims):
    NH3, DH3, EH3 = 3 * d.NH, 3 * d.DH, 3 * d.EH
    return tf.CoreWeights(
        (d.TH, d.NH), (d.NH,), (d.TH, NH3), (d.E, NH3), (NH3,), (d.NH, NH3),
        (NH3,), (d.NH, d.P), (d.P,), (d.NH + d.P, d.DH), (d.DH,),
        (d.W, DH3), (DH3,), (d.DH, DH3), (DH3,), (d.DH, 2), (2,),
        (d.P + d.W, d.E), (d.E,), (d.W,), (2, d.E, EH3), (2, d.EH, EH3),
        (2, EH3), (2, EH3))


def _tasks(d: tf.Dims, B: int, dev="meta", dtype=torch.float32, fill=None):
    """The 16 K2b tasks of one frame at B rows, on ``dev``; ``fill(shape,
    dtype)`` makes the stash, cotangents and frame_h (empty otherwise)."""
    make = fill or (lambda shape, dt: torch.empty(shape, dtype=dt,
                                                  device=dev))
    st = tf.Stash(*(make(t.shape, t.dtype)
                    for t in tf.new_stash(d, B, "meta", dtype)))
    ct = tf.Cotangents(*(make(t.shape, t.dtype)
                         for t in tf.new_cotangents(d, B, "meta")))
    grads = tf.CoreWeights(*(torch.empty(s, dtype=dtype, device=dev)
                             for s in _weight_shapes(d)))
    return tf.wgrad_tasks(d, B, make((B, d.TH), dtype), st, ct, grads)


WIDTHS = {"tiny": tiny_model_config(), "canonical": ModelConfig()}


def _kernel_items(plan, shapes):
    """The work items ``wgrad_kernel`` runs for ``plan``, one a block, as
    (task, i0, o0, n0, n1): tasks in plan order, each ``tiles x slices``
    blocks, slice-major, tiles row-major, and slice j of a task's C chunks
    covering chunks [j C // s, (j + 1) C // s), as the kernel's prologue
    and ``train_wgrad`` work them out from the task table."""
    items = []
    for k in plan.order:
        N, I, O, bias = shapes[k]
        s, chunks = plan.slices[k], -(-N // tf.WG_CHUNK)
        tiles_o = -(-O // tf.WG_TILE)
        tiles = -(-(I + bias) // tf.WG_TILE) * tiles_o
        for local in range(tiles * s):
            j, tile = divmod(local, tiles)
            c0, c1 = j * chunks // s, (j + 1) * chunks // s
            items.append((k, tile // tiles_o * tf.WG_TILE,
                          tile % tiles_o * tf.WG_TILE, c0 * tf.WG_CHUNK,
                          min(c1 * tf.WG_CHUNK, N)))
    return items


@pytest.mark.parametrize("B", [1, 3, 128, 512])
@pytest.mark.parametrize("width", ["tiny", "canonical"])
def test_wgrad_plan_covers_every_sample_once_in_balanced_items(width, B):
    """Every (i, o, n) of every task lies in exactly one of the items the
    kernel runs for the plan; no item takes more than twice the mean
    item's chunks (the unit of a block's work: WG_CHUNK samples); the
    workspace stays under its cap and its cut tasks' ranges do not
    overlap."""
    shapes = tf.wgrad_shapes(_tasks(_dims(WIDTHS[width]), B))
    plan = tf.wgrad_plan(shapes)
    assert sorted(plan.order) == list(range(len(shapes)))
    items = _kernel_items(plan, shapes)
    seen = {}
    for k, i0, o0, n0, n1 in items:
        assert 0 <= n0 < n1 <= shapes[k][0]
        seen.setdefault((k, i0, o0), []).append((n0, n1))
    for k, (N, I, O, bias) in enumerate(shapes):
        tiles = {(i0, o0) for i0 in range(0, I + bias, tf.WG_TILE)
                 for o0 in range(0, O, tf.WG_TILE)}
        assert {(i0, o0) for kk, i0, o0 in seen if kk == k} == tiles
        for tile in tiles:
            spans = sorted(seen[(k,) + tile])
            assert len(spans) == plan.slices[k]
            assert spans[0][0] == 0 and spans[-1][1] == N
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    chunks = [-(-(n1 - n0) // tf.WG_CHUNK) for *_, n0, n1 in items]
    assert max(chunks) == plan.length
    assert max(chunks) <= 2 * np.mean(chunks)
    assert 4 * plan.ws_elems <= tf.WG_WS_CAP
    spans = sorted((plan.ws_off[k], plan.ws_off[k] + s * (I + bias) * O)
                   for k, (s, (_, I, O, bias)) in
                   enumerate(zip(plan.slices, shapes)) if s > 1)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert (spans[-1][1] if spans else 0) == plan.ws_elems
    if width == "canonical" and B >= 128:
        # the duration GRU's 75 B samples over 11 tiles are cut the most
        assert max(plan.slices) == plan.slices[tf.WGRAD_NAMES.index("w_dhh")]
        assert plan.slices[0] == plan.slices[1] == 1


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties away from zero), as cvt.rna.tf32
    does: add half of the 13 dropped mantissa bits, then mask them off."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _emulate(tk: tf.WgradTask, spans, passes: str) -> torch.Tensor:
    """K2b's arithmetic for one task as (I + bias, O) f32: over the
    N-slices ``spans`` (n0, n1) of its items (whole WG_CHUNK chunks), a
    chunk's products summed over its k = 8 sample steps in order, each
    step's accumulated in f32 as the kernel issues its m16n8k8 products
    ("3x" lo.hi + hi.lo + hi.hi with both operands split, "2x" X.lo + X.hi:
    a bf16 X is exact in TF32, "1x" one TF32 product), each chunk's sum
    added to the slice's; then the slices summed in slice order."""
    x, dy = tf.task_rows(tk)
    x = x.float() if x is not None else dy.new_zeros(tk.N, 0)
    if tk.gb.numel():
        x = torch.cat([x, x.new_ones(tk.N, 1)], 1)
    total = None
    for n0, n1 in spans:
        acc = torch.zeros(x.shape[1], tk.O)
        for c in range(n0, n1, tf.WG_CHUNK):
            part = torch.zeros_like(acc)
            for k in range(c, min(c + tf.WG_CHUNK, n1), 8):
                a, b = x[k:min(k + 8, n1)], dy[k:min(k + 8, n1)]
                ah, bh = _tf32(a), _tf32(b)
                al, bl = _tf32(a - ah), _tf32(b - bh)
                if passes == "3x":
                    terms = (al.t() @ bh, ah.t() @ bl, ah.t() @ bh)
                elif passes == "2x":
                    terms = (a.t() @ bl, a.t() @ bh)
                else:
                    terms = (ah.t() @ bh,)
                for term in terms:
                    part = part + term
            acc = acc + part
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["w_hh", "w_dhh"])
def test_wgrad_arithmetic_is_f32_accurate(name, dtype):
    """At canonical width, B=8, on numpy inputs: the emulated kernel
    arithmetic (3xTF32 for f32 X, 2xTF32 for bf16 X, over the planned
    slices), wgrad_plain and the JAX package's f32 dot_general all land
    within F64_TOL x (1 + max|f64|) of an f64 reference; a single-pass TF32
    product does not (the control: the gate tells them apart). w_dhh reads
    strided stash rows (n_in = W)."""
    d, B = _dims(ModelConfig()), 8
    rng = np.random.RandomState(7)
    tasks = _tasks(d, B, dev="cpu", dtype=dtype, fill=lambda shape, dt: (
        torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt)))
    k = tf.WGRAD_NAMES.index(name)
    tk = tasks[k]
    shapes = tf.wgrad_shapes(tasks)
    plan = tf.wgrad_plan(shapes)
    spans = sorted({(n0, n1) for kk, _, _, n0, n1 in
                    _kernel_items(plan, shapes) if kk == k})
    assert len(spans) == plan.slices[k] > 1
    x, dy = tf.task_rows(tk)
    ref = torch.cat([x.double().t() @ dy.double(),
                     dy.double().sum(0, keepdim=True)])
    bound = F64_TOL * (1.0 + ref.abs().max().item())
    err = lambda got: (got.double() - ref).abs().max().item()

    kernel = _emulate(tk, spans, "3x" if dtype == torch.float32
                      else "2x")
    tf.wgrad_plain([tk])
    plain = torch.cat([tk.gW.float(), tk.gb.float()[None]])
    jax_w = jax.lax.dot_general(
        jnp.asarray(x.float().numpy()), jnp.asarray(dy.numpy()),
        (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    single = _emulate(tk, spans, "1x")
    assert err(kernel) <= bound, (err(kernel), bound)
    assert (err(torch.cat([torch.from_numpy(np.array(jax_w)),
                           dy.sum(0, keepdim=True)])) <= bound)
    if dtype == torch.float32:   # bf16 gradients are rounded to bf16
        assert err(plain) <= bound, (err(plain), bound)
    assert err(single) > bound, (err(single), bound)


def test_wgrad_refuses_cpu_tensors():
    """K2b's wrapper launches the kernel or raises: CPU tasks are refused
    (the CPU path is autograd of the plain frame, not this wrapper)."""
    tasks = _tasks(_dims(tiny_model_config()), 3, dev="cpu",
                   fill=lambda shape, dt: torch.zeros(shape, dtype=dt))
    with pytest.raises(ValueError, match="CUDA"):
        tf.wgrad(tasks)


def test_wgrad_struct_and_tile_match_the_cuda_source():
    """The ctypes WgradTaskC mirrors WgradTaskT field for field, and the
    planner's tile and chunk are the kernel's."""
    src = CU.read_text()
    body = re.search(r"struct WgradTaskT \{(.*?)\};", src, re.S).group(1)
    fields, type_ = [], r"^(const )?(long long|[\w:]+)\s*\*?"
    for decl in body.split(";"):
        decl = re.sub(r"//.*", "", decl).strip()
        if decl:
            fields += [f.strip(" *")
                       for f in re.sub(type_, "", decl).split(",")]
    assert fields == [f for f, _ in build.WgradTaskC._fields_]
    for name in ("WG_TILE", "WG_CHUNK"):
        value = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
        assert int(value) == getattr(tf, name), name
