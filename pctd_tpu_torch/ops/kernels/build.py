"""Build and bind the decode kernels.

At first use on the card, one ``nvcc`` run compiles every ``csrc/*.cu`` into
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
from pctd_tpu_torch.ops.kernels.ar_decoder import FoldedWeights

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pctd_tpu_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
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
    lib = BUILD_DIR / f"libpctd_decoder_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
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
