"""Build and bind the CUDA kernels (decode: K3, K4; training: K1, K2; and
the probes ``csrc/mma_peak.cu``, the tensor-core issue rate that bounds K2b,
and ``csrc/l2_stream.cu``, the bulk-copy rate from L2 that feeds K1).

At first use on the card, ``nvcc`` compiles every ``csrc/*.cu`` to an object,
one compiler process per source, all started together, and links them into
a shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so the build takes seconds). The library goes to
``build/pctd_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so an unchanged tree reuses it; the compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, NamedTuple, Sequence, Tuple

import torch

from pctd_tpu_torch.config import PianoTreeSpec
from pctd_tpu_torch.ops.kernels import train_frame as tf
from pctd_tpu_torch.ops.kernels.ar_decoder import F32_FIELDS, FoldedWeights

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pctd_tpu_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")


class Dims(NamedTuple):
    """Integer fields of ``DecoderWeightsT`` in ``csrc/decoder.cu``, in
    order."""
    TH: int
    NH: int
    DH: int
    E: int
    EH: int
    P: int
    W: int
    K: int
    T: int
    eos: int


class DecoderWeightsC(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in FoldedWeights._fields]
                + [(d, ctypes.c_int) for d in Dims._fields])


def _pointers(name: str, fields) -> type:
    return type(name, (ctypes.Structure,),
                {"_fields_": [(f, ctypes.c_void_p) for f in fields]})


class TrainWeightsC(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in tf.CoreWeights._fields]
                + [(d, ctypes.c_int) for d in tf.Dims._fields])


TrainStashC = _pointers("TrainStashC", tf.Stash._fields)


class K1PanelsC(ctypes.Structure):
    """``K1PanelsT`` of ``csrc/train_frame.cu``: the panel buffer and its
    :class:`train_frame.PanelLayout` offsets."""
    _fields_ = ([("base", ctypes.c_void_p)]
                + [(f, ctypes.c_int) for f in tf.PanelLayout._fields[:-1]])
TrainCotangentsC = _pointers("TrainCotangentsC", tf.Cotangents._fields)


class WgradTaskC(ctypes.Structure):
    """``WgradTaskT`` of ``csrc/train_frame.cu``: a ``WgradTask``, its
    workspace and slice count from the plan, and the bookkeeping the C side
    fills in."""
    _fields_ = ([(f, ctypes.c_void_p) for f in ("X", "DY", "gW", "gb",
                                                "ws")]
                + [(f, ctypes.c_int) for f in ("N", "I", "O", "n_in")]
                + [(f, ctypes.c_longlong) for f in ("x_o", "x_i", "y_o",
                                                    "y_i")]
                + [(f, ctypes.c_int) for f in ("slices", "tiles_o", "tiles",
                                               "item0", "elem0")])


def decoder_dims(fw: FoldedWeights, spec: PianoTreeSpec) -> Dims:
    return Dims(TH=fw.w_frame.shape[0], NH=fw.w_hh.shape[0],
                DH=fw.w_dcomb.shape[0], E=fw.w_emb.shape[1],
                EH=fw.we_hh.shape[1], P=fw.w_pitch_gi.shape[0],
                W=fw.w_dur_gi.shape[0], K=spec.max_simu_note,
                T=spec.num_step, eos=spec.pitch_eos)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the decode kernels are built "
                           "with the CUDA toolkit on the machine with the "
                           "card")
    return nvcc


def build() -> Tuple[Path, str]:
    """Compile the kernels if this source tree has not been built yet.
    Returns (library path, the compiler's ``-Xptxas -v`` report)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib = BUILD_DIR / f"libpctd_kernels_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{lib.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        reports = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{out}")
            reports.append(out)
        tmp = BUILD_DIR / f"{tag}.tmp"
        proc = subprocess.run(
            [_nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text("".join(reports))
        os.replace(tmp, lib)  # atomic: concurrent builds agree
    return lib, log.read_text() if log.exists() else ""


_LIB: List[ctypes.CDLL] = []


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use in the process."""
    if not _LIB:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        weights = ctypes.POINTER(DecoderWeightsC)
        out = ctypes.POINTER(ctypes.c_int)
        for name in FRAME_ENTRY.values():     # one C signature per dtype
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [weights, i32, i32, i32] + [ptr] * 7, i32
        lib.pctd_full_decode.argtypes = [weights, i32, i32, i32] + [ptr] * 6
        lib.pctd_full_decode.restype = i32
        lib.pctd_decode_info.argtypes = [weights, i32, i32, out]
        lib.pctd_decode_info_bf16.argtypes = [weights, i32, out]
        for fn in (lib.pctd_decode_info, lib.pctd_decode_info_bf16):
            fn.restype = i32
        lib.pctd_error_string.argtypes = [i32]
        lib.pctd_error_string.restype = ctypes.c_char_p
        tw = ctypes.POINTER(TrainWeightsC)
        stash = ctypes.POINTER(TrainStashC)
        cot = ctypes.POINTER(TrainCotangentsC)
        pn = ctypes.POINTER(K1PanelsC)
        for sfx in TRAIN_SUFFIX.values():     # the same C signature per dtype
            for name, argtypes in (
                    ("pctd_train_fwd", [tw, pn, i32, i32, i32, i32]
                     + [ptr] * 9 + [stash, ptr]),
                    ("pctd_train_fwd_logits", [tw, pn, i32, i32, i32, i32]
                     + [ptr] * 8 + [stash, ptr]),
                    ("pctd_train_fwd_info", [tw, i32, out]),
                    ("pctd_train_bwd", [tw, i32, i32, i32] + [ptr] * 9
                     + [stash, cot, ptr]),
                    ("pctd_train_bwd_logits", [tw, i32, i32, i32]
                     + [ptr] * 8 + [stash, cot, ptr]),
                    ("pctd_train_wgrad", [ctypes.POINTER(WgradTaskC), i32,
                                          ptr])):
                fn = getattr(lib, name + sfx)
                fn.argtypes, fn.restype = argtypes, i32
        lib.pctd_train_bwd_smem_bytes.argtypes = [tw, i32, i32, i32, out,
                                                  out]
        lib.pctd_train_bwd_smem_bytes.restype = i32
        lib.pctd_mma_peak.argtypes = [i32, i32, i32, i32, ptr, ptr]
        lib.pctd_mma_peak.restype = i32
        lib.pctd_l2_stream.argtypes = [ptr, i32, ctypes.c_longlong, i32,
                                       i32, i32, i32, ptr, ptr]
        lib.pctd_l2_stream.restype = i32
        _LIB.append(lib)
    return _LIB[0]


#: the C entry points' suffix for each storage dtype of the train-frame
#: kernels (``PCTD_TRAIN_ENTRIES`` in ``csrc/train_frame.cu``; the bf16 ones
#: compiled in ``csrc/train_frame_bf16.cu``)
TRAIN_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def train_entry(name: str, dtype: torch.dtype) -> str:
    """The C entry point of train-frame kernel ``name`` for ``dtype``."""
    if dtype not in TRAIN_SUFFIX:
        raise TypeError(f"train-frame kernels take float32 or bfloat16, "
                        f"got {dtype}")
    return name + TRAIN_SUFFIX[dtype]


#: the C entry point of K3 for each storage dtype (the bf16 one compiled in
#: ``csrc/decoder_bf16.cu``), and of K4, which decodes in float32 only (the
#: JAX package's K4 has no bf16 mode): the row-group kernels
FRAME_ENTRY = {torch.float32: "pctd_frame_decode",
               torch.bfloat16: "pctd_frame_decode_bf16"}
FULL_ENTRY = {torch.float32: "pctd_full_decode"}


def check_inputs(fw: FoldedWeights, device: torch.device,
                 named: Sequence[Tuple[str, torch.Tensor, tuple]],
                 entries: dict = FRAME_ENTRY) -> torch.dtype:
    """Raise unless the weights hold one storage dtype that ``entries``
    (dtype -> C entry point; K3's by default) takes, with the ``F32_FIELDS`` constants in
    float32, and every weight and input is a contiguous tensor on
    ``device``, each input of the storage dtype and its expected shape.
    Returns the storage dtype."""
    dtype = fw.w_hh.dtype
    if dtype not in entries:
        raise TypeError(f"this decode kernel takes "
                        f"{sorted(map(str, entries))} weights, got {dtype}")
    items = [(f"weight {n}", t, None,
              torch.float32 if n in F32_FIELDS else dtype)
             for n, t in zip(fw._fields, fw)]
    items += [(n, t, shape, dtype) for n, t, shape in named]
    for name, t, _, want in items:
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
    if device.type != "cuda":
        raise ValueError(f"decode kernels take CUDA tensors, got {device}")
    for name, t, shape, _ in items:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if named[0][1].shape[0] == 0:
        raise ValueError("empty batch")
    return dtype


#: rows of a decode group: one cluster of the row-group K3/K4 decodes them,
#: so that each weight read from L2 serves this many rows
DECODE_G = 16
#: the cluster sizes the plan takes, largest first (16 blocks is a
#: non-portable cluster size, which Hopper allows)
DECODE_CLUSTERS = (16, 8)
#: the phases of a row-group launch (bits of ``launch``'s ``phases``): the
#: frame projection, the note chain (note steps with the slot product, the
#: argmax and the token feedback), the duration chains, the summary, and
#: K4's time GRU; a phase launched alone reads zeros where the phases
#: before it would have written, for timing; and, for timing only, the slot
#: chain's cluster barriers alone (three a slot)
DECODE_PHASES = {"proj": 1, "note": 2, "dur": 4, "summary": 8, "time": 16,
                 "barriers": 32}
PHASES_ALL = 31


class DecodePlan(NamedTuple):
    """How a row-group decode covers a batch: ``groups`` groups of ``G``
    rows (the last one padded), one cluster of ``C`` blocks each, in
    ``waves`` rounds of the clusters the card holds at once."""
    G: int
    C: int
    groups: int
    waves: int


def decode_plan(batch: int, sms: int, clusters_at_once=None) -> DecodePlan:
    """The plan of a row-group K3/K4 launch for ``batch`` rows:
    ``clusters_at_once`` maps each size of :data:`DECODE_CLUSTERS` to the
    clusters of that size the card holds at once (the kernels' occupancy
    query on the card; by default ``sms // C``, one block an SM). Takes 16
    blocks a cluster where every group fits at once (a block then owns half
    the columns it would at 8), else 8, the size that fits more groups at
    once; a size that fits no cluster at all is never taken."""
    if batch < 1:
        raise ValueError(f"empty batch: {batch}")
    at_once = dict(clusters_at_once or {c: sms // c for c in DECODE_CLUSTERS})
    sizes = [c for c in DECODE_CLUSTERS if at_once.get(c, 0) > 0]
    if not sizes:
        raise RuntimeError(f"no cluster size of {DECODE_CLUSTERS} fits this "
                           f"card (clusters at once: {at_once})")
    groups = -(-batch // DECODE_G)
    C = sizes[0] if groups <= at_once[sizes[0]] else sizes[-1]
    return DecodePlan(G=DECODE_G, C=C, groups=groups,
                      waves=-(-groups // at_once[C]))


#: K1's time a wave in ms, f32 loss mode at B=128 on an NVIDIA H100 80GB
#: HBM3 at 700 W (``chip_smoke.py`` phase "K1 by phase" and
#: ``tools/k1_by_rows.py``; PERF.md §6): the row groups at 8 blocks a
#: cluster (one wave of 8 clusters) and at 16 (two waves, halved), the
#: per-row kernel at 1, 2 and 4 rows a block (one wave, a block an SM)
K1_WAVE_MS = {("group", 8): 1.011, ("group", 16): 0.784, ("rows", 1): 1.504,
              ("rows", 2): 1.589, ("rows", 4): 2.131}
#: the phases of a K1 launch (bits of ``launch_train_fwd``'s ``phases``):
#: the frame projection, the note chain (the ring's products, the note-GRU
#: steps, the pitch argmax and the next token; three cluster barriers a
#: slot), the owned rows' duration chains, the summary, and, for timing
#: only, the chain's cluster barriers alone; a phase alone reads zeros
#: where the phases before it would have written
K1_PHASES = {"proj": 1, "note": 2, "dur": 4, "summary": 8, "barriers": 32}
K1_ALL = 15


class K1Plan(NamedTuple):
    """How K1 covers a batch: row groups, ``units`` groups of
    :data:`DECODE_G` rows in clusters of ``C`` blocks (``R`` = 0), or the
    per-row kernel, ``units`` blocks of ``R`` rows (``C`` = 0); in
    ``waves`` rounds of what the card holds at once; ``ms`` the estimate
    from the measured wave times."""
    C: int
    R: int
    units: int
    waves: int
    ms: float


def k1_plan(batch: int, sms: int, clusters_at_once=None,
            wave_ms=None) -> K1Plan:
    """The plan of a K1 launch for ``batch`` rows: the row groups at the
    cluster size, or the per-row kernel at the rows a block, with the least
    waves x measured wave time (``wave_ms``, :data:`K1_WAVE_MS` by
    default). ``clusters_at_once`` maps each cluster size to the clusters
    the card holds at once (K1's occupancy query on the card; by default
    ``sms // C``), a size that fits none is never taken; the per-row kernel
    runs a block an SM. Ties go to the row groups, then to the larger
    cluster."""
    if batch < 1:
        raise ValueError(f"empty batch: {batch}")
    at_once = dict(clusters_at_once or {c: sms // c for c in DECODE_CLUSTERS})
    wave_ms = wave_ms or K1_WAVE_MS
    cdiv = lambda a, b: -(-a // b)
    groups = cdiv(batch, DECODE_G)
    cands = []
    for c in DECODE_CLUSTERS:
        if at_once.get(c, 0) > 0:
            w = cdiv(groups, at_once[c])
            cands.append((w * wave_ms[("group", c)], 0, -c,
                          K1Plan(c, 0, groups, w, w * wave_ms[("group", c)])))
    for r in (1, 2, 4):
        blocks = cdiv(batch, r)
        w = cdiv(blocks, sms)
        cands.append((w * wave_ms[("rows", r)], 1, r,
                      K1Plan(0, r, blocks, w, w * wave_ms[("rows", r)])))
    return min(cands, key=lambda x: x[:3])[3]


_INFO: dict = {}


def _weights_c(fw: FoldedWeights, dims: Dims) -> DecoderWeightsC:
    """The C weights struct; raises unless every width is a multiple of 4
    and every weight starts 16 bytes aligned (the kernels' vector loads)."""
    for d in ("TH", "NH", "DH", "E", "EH"):
        if getattr(dims, d) % 4:
            raise ValueError(f"decode kernels need {d} % 4 == 0, got "
                             f"{getattr(dims, d)}")
    for n, t in zip(fw._fields, fw):
        if t.data_ptr() % 16:
            raise ValueError(f"weight {n} is not 16-byte aligned")
    return DecoderWeightsC(*(t.data_ptr() for t in fw), *dims)


def decode_info(fw: FoldedWeights, dims: Dims, full: bool, cluster: int,
                device: torch.device) -> Tuple[int, int]:
    """(shared memory bytes a block, clusters the card holds at once) of
    the row-group K3 (K4 with ``full``) in the weights' dtype at
    ``cluster`` blocks a cluster; cached by dtype and shapes."""
    bf16 = fw.w_hh.dtype == torch.bfloat16
    key = (full, bf16, cluster, dims, device)
    if key not in _INFO:
        lib = library()
        out = (ctypes.c_int * 2)()
        st = _weights_c(fw, dims)
        with torch.cuda.device(device):
            rc = (lib.pctd_decode_info_bf16(ctypes.byref(st), cluster, out)
                  if bf16 else lib.pctd_decode_info(ctypes.byref(st),
                                                    int(full), cluster, out))
        if rc != 0:
            raise RuntimeError(f"decode_info: "
                               f"{lib.pctd_error_string(rc).decode()}")
        _INFO[key] = (out[0], out[1])
    return _INFO[key]


def plan_on_card(fw: FoldedWeights, dims: Dims, batch: int, full: bool,
                 device: torch.device) -> DecodePlan:
    """:func:`decode_plan` with the card's SM count and occupancy."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return decode_plan(batch, sms, {
        c: decode_info(fw, dims, full, c, device)[1]
        for c in DECODE_CLUSTERS})


def launch(name: str, fw: FoldedWeights, dims: Dims, batch: int,
           tensors: Sequence[torch.Tensor], phases: int = PHASES_ALL,
           cluster: int = 0) -> None:
    """Launch the row-group kernel ``name`` (:data:`FRAME_ENTRY`,
    :data:`FULL_ENTRY`) on the current stream of the tensors' device, in
    clusters of ``cluster`` blocks (0: :func:`plan_on_card`'s), the phases
    of ``phases`` (:data:`DECODE_PHASES`; all by default); raises if the
    launch is refused."""
    lib = library()
    device = tensors[0].device
    st = _weights_c(fw, dims)
    if not cluster:
        cluster = plan_on_card(fw, dims, batch, name in FULL_ENTRY.values(),
                               device).C
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(ctypes.byref(st), batch, phases, cluster,
                                *(t.data_ptr() for t in tensors), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.pctd_error_string(rc).decode()}")


def _ptr(t) -> int:
    """Device address of a tensor (0 for an empty one)."""
    return t.data_ptr() if t.numel() else 0


def _call(name: str, device: torch.device, *args) -> None:
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.pctd_error_string(rc).decode()}")


def train_weights(cw, d) -> TrainWeightsC:
    return TrainWeightsC(*(_ptr(t) for t in cw), *d)


def k1_info(cw, d, C: int, device: torch.device) -> Tuple[int, int]:
    """(shared memory bytes a block, clusters the card holds at once; 0
    where K1 does not take these widths at C) of the row-group K1 in the
    weights' dtype at ``C`` blocks a cluster; cached by dtype and shapes."""
    key = ("K1", cw.w_hh.dtype, C, d, device)
    if key not in _INFO:
        lib = library()
        out = (ctypes.c_int * 2)()
        name = train_entry("pctd_train_fwd_info", cw.w_hh.dtype)
        with torch.cuda.device(device):
            rc = getattr(lib, name)(ctypes.byref(train_weights(cw, d)), C,
                                    out)
        if rc != 0:
            raise RuntimeError(f"{name}: "
                               f"{lib.pctd_error_string(rc).decode()}")
        _INFO[key] = (out[0], out[1])
    return _INFO[key]


def k1_plan_on_card(cw, d, batch: int, device: torch.device) -> K1Plan:
    """:func:`k1_plan` with the card's SM count and K1's occupancy."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return k1_plan(batch, sms, {c: k1_info(cw, d, c, device)[1]
                                for c in DECODE_CLUSTERS})


def launch_train_fwd(cw, d, batch: int, tensors: Sequence[torch.Tensor],
                     stash, logits: bool = False, phases: int = K1_ALL,
                     cluster: int = 0, rows: int = 0) -> None:
    """Launch K1 in loss mode (``pctd_train_fwd``) or, with ``logits``, in
    logits-out mode (``pctd_train_fwd_logits``), in the weights' dtype
    (``_bf16`` entry points for bfloat16): the row groups in clusters of
    ``cluster`` blocks on the panels of ``train_frame.panels``, the phases
    of ``phases`` (:data:`K1_PHASES`; all by default), or the per-row
    kernel with ``rows`` rows a block; with neither given, what
    :func:`k1_plan_on_card` picks. ``stash`` None skips the stash."""
    device = tensors[0].device
    for n in ("w_t2n", "w_ih_frame", "w_hh"):   # the projection's vector loads
        if getattr(cw, n).data_ptr() % 16:
            raise ValueError(f"weight {n} is not 16-byte aligned")
    if not cluster and not rows:
        plan = k1_plan_on_card(cw, d, batch, device)
        cluster, rows = plan.C, plan.R
    pn = K1PanelsC()
    if not rows:
        buf = tf.panels(cw, d, cluster)
        lay = tf.panel_layout(d, cluster, cw.w_hh.dtype)
        pn = K1PanelsC(buf.data_ptr(), lay.pstride, lay.o_tok, lay.o_h,
                       lay.o_sih, lay.o_shh, lay.o_wdc, lay.o_west)
    st = None if stash is None else ctypes.byref(
        TrainStashC(*(_ptr(t) for t in stash)))
    name = train_entry("pctd_train_fwd_logits" if logits else
                       "pctd_train_fwd", cw.w_hh.dtype)
    _call(name, device, ctypes.byref(train_weights(cw, d)), ctypes.byref(pn),
          batch, phases, cluster, rows, *(_ptr(t) for t in tensors), st)


#: K2a's phases, the bits of ``launch_train_bwd``'s ``phases``: the slot
#: rows (2b, the slot-row kernel), the note chain (2c) and the summary chain
#: (2a), side by side in the chain kernel, the projections (2d)
K2A_PHASES = {"slots": 1, "note": 2, "proj": 4, "summary": 8}


def launch_train_bwd(cw, d, batch: int, tensors: Sequence[torch.Tensor],
                     stash, cot, logits: bool = False, phases: int = 15,
                     cluster: int = 0) -> None:
    """Launch K2a in loss mode (``pctd_train_bwd``) or, with ``logits``, in
    logits-out mode (``pctd_train_bwd_logits``), in the weights' dtype:
    the phases of ``phases`` (:data:`K2A_PHASES`; all by default, in
    order), the note chain in clusters of ``cluster`` blocks (0: the
    kernel's choice). The last tensor is the f32 scratch dh_inj
    (K-1, B, NH)."""
    device = tensors[0].device
    name = train_entry("pctd_train_bwd_logits" if logits else
                       "pctd_train_bwd", cw.w_hh.dtype)
    _call(name, device, ctypes.byref(train_weights(cw, d)),
          batch, phases, cluster, *(_ptr(t) for t in tensors),
          ctypes.byref(TrainStashC(*(_ptr(t) for t in stash))),
          ctypes.byref(TrainCotangentsC(*(_ptr(t) for t in cot))))


def launch_wgrad(tasks, slices, ws, ws_off) -> None:
    """Launch K2b (``pctd_train_wgrad``; ``_bf16`` for bfloat16) over
    ``WgradTask`` reductions in this order, as checked by
    ``train_frame.wgrad``: task k cut into ``slices[k]`` N-slices, its f32
    partials at element ``ws_off[k]`` of ``ws`` when it has more than
    one."""
    ws_ptr = ws.data_ptr() if ws is not None else 0
    arr = (WgradTaskC * len(tasks))(*(
        WgradTaskC(_ptr(t.X), _ptr(t.DY), _ptr(t.gW), _ptr(t.gb),
                   ws_ptr + 4 * off if s > 1 else 0, t.N, t.I, t.O, t.n_in,
                   t.x_o, t.x_i, t.y_o, t.y_i, s, 0, 0, 0, 0)
        for t, s, off in zip(tasks, slices, ws_off)))
    _call(train_entry("pctd_train_wgrad", tasks[0].gb.dtype),
          tasks[0].DY.device, arr, len(tasks))


def launch_mma_peak(bf16: bool, blocks: int, threads: int, iters: int,
                    out: torch.Tensor) -> None:
    """Launch ``csrc/mma_peak.cu``'s issue-rate probe: ``iters`` rounds of
    8 register-only mma.sync a warp, TF32 m16n8k8 (2,048 flops each) or
    with ``bf16`` bf16 m16n8k16 (4,096); ``out`` (f32, blocks x threads
    elements) keeps the results live."""
    _call("pctd_mma_peak", out.device, int(bf16), blocks, threads, iters,
          _ptr(out))


def launch_l2_stream(src: torch.Tensor, blocks: int, nbytes: int,
                     panels: int, stage: int, stages: int, reps: int,
                     out: torch.Tensor) -> None:
    """Launch ``csrc/l2_stream.cu``'s probe: ``blocks`` blocks each stream
    panel ``b % panels`` of ``src`` (``nbytes`` each) ``reps`` times
    through ``stages`` shared-memory stages of ``stage`` bytes by bulk
    async copies; ``out`` (f32, blocks x 256 elements) keeps the reads
    live."""
    _call("pctd_l2_stream", src.device, _ptr(src), blocks, nbytes, panels,
          stage, stages, reps, _ptr(out))
