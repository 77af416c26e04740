"""Build and bind the CUDA kernels (decode: K3, K4; training: K1, K2).

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
from pctd_tpu_torch.ops.kernels.ar_decoder import FoldedWeights

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pctd_tpu_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")


class Dims(NamedTuple):
    """Integer fields of ``DecoderWeights`` in ``csrc/decoder.cu``, in
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
TrainCotangentsC = _pointers("TrainCotangentsC", tf.Cotangents._fields)


class WgradTaskC(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("X", "DY", "gW", "gb")]
                + [(f, ctypes.c_int) for f in ("N", "I", "O", "n_in")]
                + [(f, ctypes.c_longlong) for f in ("x_o", "x_i", "y_o",
                                                    "y_i")]
                + [(f, ctypes.c_int) for f in ("tiles_o", "tile0")])


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
        lib.pctd_frame_decode.argtypes = [weights, i32, i32] + [ptr] * 7
        lib.pctd_frame_decode.restype = i32
        lib.pctd_full_decode.argtypes = [weights, i32, i32] + [ptr] * 6
        lib.pctd_full_decode.restype = i32
        lib.pctd_smem_bytes.argtypes = [weights, i32]
        lib.pctd_smem_bytes.restype = i32
        lib.pctd_error_string.argtypes = [i32]
        lib.pctd_error_string.restype = ctypes.c_char_p
        tw = ctypes.POINTER(TrainWeightsC)
        lib.pctd_train_fwd.argtypes = ([tw, i32, i32] + [ptr] * 9
                                       + [ctypes.POINTER(TrainStashC), ptr])
        lib.pctd_train_fwd.restype = i32
        lib.pctd_train_fwd_logits.argtypes = (
            [tw, i32, i32] + [ptr] * 8 + [ctypes.POINTER(TrainStashC), ptr])
        lib.pctd_train_fwd_logits.restype = i32
        lib.pctd_train_bwd.argtypes = (
            [tw, i32, i32] + [ptr] * 8
            + [ctypes.POINTER(TrainStashC),
               ctypes.POINTER(TrainCotangentsC), ptr])
        lib.pctd_train_bwd.restype = i32
        lib.pctd_train_bwd_logits.argtypes = (
            [tw, i32, i32] + [ptr] * 7
            + [ctypes.POINTER(TrainStashC),
               ctypes.POINTER(TrainCotangentsC), ptr])
        lib.pctd_train_bwd_logits.restype = i32
        lib.pctd_train_wgrad.argtypes = [ctypes.POINTER(WgradTaskC), i32, ptr]
        lib.pctd_train_wgrad.restype = i32
        lib.pctd_train_smem_bytes.argtypes = [tw, i32, i32]
        lib.pctd_train_smem_bytes.restype = i32
        _LIB.append(lib)
    return _LIB[0]


def check_inputs(fw: FoldedWeights, device: torch.device,
                 named: Sequence[Tuple[str, torch.Tensor, tuple]]) -> None:
    """Raise unless every weight and input is a contiguous float32 tensor
    on ``device`` and each input has its expected shape."""
    if device.type != "cuda":
        raise ValueError(f"decode kernels take CUDA tensors, got {device}")
    items = [(f"weight {n}", t, None) for n, t in zip(fw._fields, fw)]
    for name, t, shape in items + list(named):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if named[0][1].shape[0] == 0:
        raise ValueError("empty batch")


#: a block's decode time with R rows, relative to one row: K4 at canonical
#: width, B=128, on an H100 SXM at 700 W (chip_smoke.py's rows-per-block
#: timing: 53.5, 55.8 and 79.2 ms).
BLOCK_COST = {1: 1.0, 2: 1.04, 4: 1.48}


def rows_per_block(batch: int, sms: int) -> int:
    """Batch rows a block decodes (1, 2 or 4). One block runs per SM (its
    registers fill the SM), so the decode takes waves of ``sms`` blocks;
    more rows a block means fewer waves but a slower block. Picks the R
    with the least (waves x block cost)."""
    cdiv = lambda a, b: -(-a // b)
    return min(BLOCK_COST,
               key=lambda r: cdiv(cdiv(batch, r), sms) * BLOCK_COST[r])


def launch(name: str, fw: FoldedWeights, dims: Dims, batch: int,
           tensors: Sequence[torch.Tensor], rows: int = 0) -> None:
    """Launch ``name`` on the current stream of the tensors' device; raises
    if the launch is refused. ``rows`` overrides :func:`rows_per_block`."""
    for d in ("TH", "NH", "DH", "E", "EH"):
        if getattr(dims, d) % 4:
            raise ValueError(f"decode kernels need {d} % 4 == 0, got "
                             f"{getattr(dims, d)}")
    lib = library()
    device = tensors[0].device
    if not rows:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        rows = rows_per_block(batch, sms)
    st = DecoderWeightsC(*(t.data_ptr() for t in fw), *dims)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(ctypes.byref(st), batch, rows,
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


def _train_rows(batch: int, device: torch.device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return rows_per_block(batch, sms)


def train_weights(cw, d) -> TrainWeightsC:
    return TrainWeightsC(*(_ptr(t) for t in cw), *d)


def launch_train_fwd(cw, d, batch: int, tensors: Sequence[torch.Tensor],
                     stash, rows: int = 0, logits: bool = False) -> None:
    """Launch K1 in loss mode (``pctd_train_fwd``) or, with ``logits``, in
    logits-out mode (``pctd_train_fwd_logits``); ``stash`` None skips the
    stash."""
    device = tensors[0].device
    st = None if stash is None else ctypes.byref(
        TrainStashC(*(_ptr(t) for t in stash)))
    name = "pctd_train_fwd_logits" if logits else "pctd_train_fwd"
    _call(name, device, ctypes.byref(train_weights(cw, d)),
          batch, rows or _train_rows(batch, device),
          *(_ptr(t) for t in tensors), st)


def launch_train_bwd(cw, d, batch: int, tensors: Sequence[torch.Tensor],
                     stash, cot, rows: int = 0, logits: bool = False) -> None:
    """Launch K2a in loss mode (``pctd_train_bwd``) or, with ``logits``, in
    logits-out mode (``pctd_train_bwd_logits``)."""
    device = tensors[0].device
    name = "pctd_train_bwd_logits" if logits else "pctd_train_bwd"
    _call(name, device, ctypes.byref(train_weights(cw, d)),
          batch, rows or _train_rows(batch, device),
          *(_ptr(t) for t in tensors),
          ctypes.byref(TrainStashC(*(_ptr(t) for t in stash))),
          ctypes.byref(TrainCotangentsC(*(_ptr(t) for t in cot))))


def launch_wgrad(tasks) -> None:
    """Launch K2b (``pctd_train_wgrad``) over ``WgradTask`` reductions."""
    arr = (WgradTaskC * len(tasks))(*(
        WgradTaskC(_ptr(t.X), _ptr(t.DY), _ptr(t.gW), _ptr(t.gb), t.N, t.I,
                   t.O, t.n_in, t.x_o, t.x_i, t.y_o, t.y_i, 0, 0)
        for t in tasks))
    _call("pctd_train_wgrad", tasks[0].DY.device, arr, len(tasks))
