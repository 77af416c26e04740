"""Serving sampler (``pctd_tpu/models/sampler.py``): the four latent-control
workflows over a fixed batch shape, with numpy results.

``fixed_batch=N`` pads every encode/decode batch up to N rows (zeros) and
slices the result back; larger requests run in N-row chunks. The decode
launches the chosen kernel: ``frame_decoder="full"`` (K4, the default) or
``"frame"`` (K3 per frame, time GRU in torch). On the K4 route the chunks
of one decode share K4 launches, as many a launch as the card runs at once
(``full_decoder.decode_grid_full_chunks``; each chunk's K4 inputs are
still computed at the chunk's shape, so its rows decode to the bits of a
launch of their own); on the K3 route each chunk is decoded alone.
``decoded_chunks`` and ``decode_launches`` count, per Sampler, the chunks
decoded (an unchunked decode is one) and the decode launches made for
them (K4 launches; one a chunk on the K3 route), each once a device.

On the card a fixed-batch encode replays a CUDA graph a chunk
(:class:`EncodeGraph`): one chunk's ``disentangle_vae.encode`` at the
chunk's shape, captured at the first encode of its input shapes, one graph
a device and shape into one private memory pool. A replay launches the
kernels that the op-by-op encode launches, so the posteriors keep their
bits. ``load_params`` drops the graphs, and the next encode captures again.
The CPU and an unchunked Sampler (``fixed_batch=None``, whose shapes vary)
encode op by op. ``encoded_chunks`` and ``encode_replays`` count the chunks
encoded (an unchunked encode is one) and the graph replays made for them
(0 op by op), each once a device.

On the card the Sampler launches that kernel or raises: there is no
fallback chain, and no CPU fallback when no card is found
(``device="cpu"`` must be asked for, and then runs the kernels' plain
versions).

``compute_dtype="bfloat16"`` serves through ``frame_decoder="frame"``, the
route of the JAX package's bf16 serving (its K4 has no bf16 mode; "full"
raises when the Sampler is built). The Sampler casts the params once
(Gaussian heads excluded) and folds the bf16 decoder; requests stay f32 in
and int32 grids out. Building a bf16 Sampler sets
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` to
False for the process, as a bf16 ``Trainer`` does: JAX sums a bf16
product's partial sums in f32.

``load_params`` puts new weights of the same names, shapes and dtypes into
a built Sampler and folds them again (the serving daemon's ``reload``).

A Sampler of the pianotree texture encoder encodes with the detrended grid
(``encode(pr_mat, c, dt_x)``, chunked with the other inputs) and decodes as
any other; the four workflows keep the JAX Sampler's signatures, which take
no ``dt_x``, and raise for it: the ``disentangle_vae`` functions of the same
names take ``dt_x``.

``mesh`` (a :class:`~pctd_tpu_torch.parallel.mesh.Mesh` of local devices,
``make_mesh()``) serves data-parallel, as the JAX Sampler's mesh does: the
workflows have no cross-row dependency, so each encode and decode chunk's
rows split evenly over the mesh's devices, each of which holds its own
copy of the (folded) weights; every device's launches are issued before
any result is read, and the results come back to the first device in row
order. There are no collectives. ``fixed_batch`` must then be a multiple
of the device count (without it, every request's rows).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from pctd_tpu_torch.config import ModelConfig, check_config
from pctd_tpu_torch.models import disentangle_vae as dv
from pctd_tpu_torch.ops import DiagNormal
from pctd_tpu_torch.ops.kernels import full_decoder
from pctd_tpu_torch.ops.kernels.ar_decoder import folded_frame_weights
from pctd_tpu_torch.utils import precision, trace
from pctd_tpu_torch.utils.device import names_device, resolve_device
from pctd_tpu_torch.utils.weights import named_leaves, params_to


def _signature(params) -> dict:
    """{leaf name: (shape, dtype)} of a params tree."""
    return {n: (tuple(t.shape), t.dtype)
            for n, t in named_leaves(params).items()}


def _map(fn, out):
    """Apply ``fn`` to a tensor or to each field of a DiagNormal pair."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    return tuple(DiagNormal(*map(fn, d)) for d in out)


def _concat(outs):
    """Row-wise concatenation of results (tensors or DiagNormal pairs)."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return tuple(DiagNormal(*(torch.cat(ts) for ts in zip(*dists)))
                 for dists in zip(*outs))


def _on(device: torch.device):
    """The context in which launches go to ``device``'s current stream."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _replays(device: torch.device) -> bool:
    """Whether a fixed-batch encode on ``device`` replays a CUDA graph."""
    return device.type == "cuda"


def fill_rows(static: torch.Tensor, rows: torch.Tensor) -> None:
    """Write ``rows`` over the first rows of ``static`` and zeros over the
    rest: in place, the zero-padded chunk that ``Sampler._chunks`` makes."""
    k = rows.shape[0]
    static[:k].copy_(rows)
    if k < static.shape[0]:
        static[k:].zero_()


class EncodeGraph:
    """``encode(*inputs)`` captured as a CUDA graph on ``device`` over
    static inputs of ``shapes``: run once on a side stream of the device
    first (the libraries' lazy set-up, the stream's cuBLAS workspace),
    then captured on that stream into ``pool``. ``replay()`` reruns it over
    what the inputs hold now and overwrites ``outputs``."""

    def __init__(self, encode, shapes, device: torch.device, pool=None):
        self.inputs = [torch.zeros(s, device=device) for s in shapes]
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.no_grad():
            with torch.cuda.stream(side):
                encode(*self.inputs)
            main.wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph, pool=self.pool, stream=side):
                self.outputs = encode(*self.inputs)

    def replay(self) -> None:
        self._graph.replay()


class Sampler:
    def __init__(self, params: dict, cfg: ModelConfig,
                 frame_decoder: str = "full",
                 fixed_batch: Optional[int] = None, device=None,
                 mesh=None):
        check_config(cfg, frame_decoder)
        if fixed_batch is not None and fixed_batch < 1:
            raise ValueError(f"fixed_batch must be positive, got "
                             f"{fixed_batch}")
        if mesh is not None:
            if mesh.group is not None:
                raise ValueError("serving has no collectives: give a mesh "
                                 "of local devices without a process group")
            if fixed_batch is not None and fixed_batch % len(mesh.devices):
                raise ValueError(f"fixed_batch {fixed_batch} not divisible "
                                 f"by the mesh's {len(mesh.devices)} "
                                 "devices")
            if not names_device(device, mesh.devices[0]):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh.devices[0]}")
            self.devices = tuple(mesh.devices)
        else:
            self.devices = (resolve_device(device),)
        self.device = self.devices[0]
        self.mesh = mesh
        self.cfg = cfg
        self.frame_decoder = frame_decoder
        self.fixed_batch = fixed_batch
        self.decoded_chunks = 0
        self.decode_launches = 0
        self.encoded_chunks = 0
        self.encode_replays = 0
        self._leaves = _signature(params)
        self._set_params(params)
        if precision.compute_dtype(cfg) != torch.float32:
            torch.backends.cuda.matmul \
                .allow_bf16_reduced_precision_reduction = False

    def _set_params(self, params: dict) -> None:
        """A (params, folds) replica on each device; ``self.params`` and
        ``self.fw`` are the first device's. Drops the encode graphs, which
        read the replicas they were captured on."""
        self._graphs = {}
        self._pool = None
        self._replicas = [self._prepare(params, d) for d in self.devices]
        self.params, self.fw = self._replicas[0]

    def _prepare(self, params: dict, device: torch.device):
        """(params on ``device``, cast once to the compute dtype, and the
        serving folds of their decoder, which depend on the weights only)."""
        params = params_to(params, device)
        dtype = precision.compute_dtype(self.cfg)
        if dtype != torch.float32:
            # the casts inside encode and decode_z are then no-ops
            params = precision.cast_params(params, dtype)
        with _on(device):
            return params, folded_frame_weights(params["dec"], self.cfg)

    def load_params(self, params: dict) -> None:
        """Serve ``params`` from now on, moved, cast and folded as at
        construction (assigning ``self.params`` alone would leave the old
        folds in ``self.fw``). Each leaf must have the name, shape and
        dtype of the leaf it replaces; else this raises ValueError and the
        Sampler keeps serving its weights."""
        new = _signature(params)
        if new != self._leaves:
            diff = sorted(set(new.items()) ^ set(self._leaves.items()),
                          key=str)
            raise ValueError(f"params do not match the served weights "
                             f"(name, shape, dtype): {diff[:4]}")
        self._set_params(params)

    def _tensor(self, a) -> torch.Tensor:
        """A request array (numpy or tensor) as float32 on the device."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return a.to(self.device, torch.float32)

    def _split(self, fn, arrays):
        """``fn(params, folds, *rows)`` of each device's even share of the
        arrays' rows, launched on every device before any result is read;
        the results on the first device, in row order."""
        if len(self.devices) == 1:
            return fn(*self._replicas[0], *arrays)
        n = arrays[0].shape[0] // len(self.devices)
        outs = []
        for i, (device, replica) in enumerate(zip(self.devices,
                                                  self._replicas)):
            with _on(device):
                outs.append(fn(*replica, *(a[i * n:(i + 1) * n].to(device)
                                           for a in arrays)))
        return _concat([_map(lambda t: t.to(self.device), o) for o in outs])

    def _chunks(self, arrays):
        """(real rows, chunk) of each fixed_batch-row chunk of the arrays
        (axis 0), the last one zero-padded."""
        n, fb = arrays[0].shape[0], self.fixed_batch
        for lo in range(0, n, fb):
            take = min(fb, n - lo)
            yield take, [a[lo:lo + take] if take == fb else torch.cat(
                [a[lo:lo + take], a.new_zeros((fb - take,) + a.shape[1:])])
                for a in arrays]

    def _chunked(self, fn, *arrays):
        """Run ``fn(params, folds, *rows)`` over fixed_batch-row zero-padded
        chunks of the arrays (axis 0), each chunk split over the devices,
        and concatenate the un-padded results."""
        n = arrays[0].shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if self.fixed_batch is None:
            if n % len(self.devices):
                raise ValueError(f"batch {n} not divisible by the mesh's "
                                 f"{len(self.devices)} devices")
            return self._split(fn, arrays)
        return _concat([_map(lambda t: t[:take], self._split(fn, chunk))
                        for take, chunk in self._chunks(arrays)])

    def _decode_shared(self, z_chd, z_rhy) -> torch.Tensor:
        """The K4 decode of more than one fixed-batch chunk: on each device
        the K4 inputs of its share of every chunk, each at the share's
        shape as ``decode_z`` computes them, then K4 over those chunks in
        shared launches; the grids in row order on the first device."""
        chunks = list(self._chunks([z_chd, z_rhy]))
        share = self.fixed_batch // len(self.devices)
        grids = []
        for i, (device, (params, fw)) in enumerate(zip(self.devices,
                                                       self._replicas)):
            with _on(device):
                inputs = [dv.decode_z_inputs(params, self.cfg, *(
                    a[i * share:(i + 1) * share].to(device) for a in chunk))
                    for _, chunk in chunks]
                got, launches = full_decoder.decode_grid_full_chunks(
                    fw, self.cfg.pianotree, inputs)
            grids.append(got)
            self.decode_launches += launches
        self.decoded_chunks += len(chunks) * len(self.devices)
        return torch.cat([torch.cat([g[j].to(self.device) for g in grids])
                          [:take] for j, (take, _) in enumerate(chunks)])

    def _graph(self, i: int, arrays) -> EncodeGraph:
        """Device ``i``'s encode graph of its share of a chunk of the
        arrays' row shapes, captured at its first use."""
        key = (i,) + tuple(tuple(a.shape[1:]) for a in arrays)
        if key not in self._graphs:
            params, _ = self._replicas[i]
            share = self.fixed_batch // len(self.devices)
            with _on(self.devices[i]):
                graph = EncodeGraph(
                    lambda *rows: dv.encode(params, self.cfg, *rows),
                    [(share,) + k for k in key[1:]], self.devices[i],
                    self._pool)
            self._graphs[key], self._pool = graph, graph.pool
        return self._graphs[key]

    def _encode_replayed(self, arrays):
        """``encode`` a fixed_batch-row chunk at a time, each device's
        share of a chunk a graph replay: the chunk's real rows written into
        the graph's inputs over zero padding, every device's replay launched
        before any result is read, and the posteriors of the real rows
        taken as new tensors before the graph runs again."""
        n, fb = arrays[0].shape[0], self.fixed_batch
        if n == 0:
            raise ValueError("empty batch")
        share = fb // len(self.devices)
        outs = []
        for lo in range(0, n, fb):
            take = min(fb, n - lo)
            parts = []
            for i, device in enumerate(self.devices):
                graph = self._graph(i, arrays)
                a, b = lo + i * share, lo + min(take, (i + 1) * share)
                with _on(device):
                    for static, array in zip(graph.inputs, arrays):
                        fill_rows(static, array[a:b])
                    graph.replay()
                    parts.append(_map(torch.clone, graph.outputs))
            self.encoded_chunks += len(self.devices)
            self.encode_replays += len(self.devices)
            outs.append(_map(lambda t: t[:take], _concat(
                [_map(lambda t: t.to(self.device), p) for p in parts])))
        return _concat(outs)

    def encode(self, pr_mat, c, dt_x=None):
        """(B, T, 128) duration matrices, (B, T/4, 36) chords and, for the
        pianotree texture encoder, the (B, 32, 16, 39) detrended grids ->
        (chord, texture) posteriors on the device."""
        with trace.span("sampler.encode"):
            arrays = [self._tensor(pr_mat), self._tensor(c)]
            if dt_x is not None:
                arrays.append(self._tensor(dt_x))
            fb = self.fixed_batch
            if fb is not None and _replays(self.device):
                return self._encode_replayed(arrays)
            out = self._chunked(
                lambda params, fw, pm, cc, *dd: dv.encode(
                    params, self.cfg, pm, cc, *dd), *arrays)
            chunks = 1 if fb is None else -(-arrays[0].shape[0] // fb)
            self.encoded_chunks += chunks * len(self.devices)
            return out

    def _encode_request(self, workflow: str, pr_mat, c):
        """``encode`` for a workflow, which takes no detrended grid."""
        if self.cfg.txt_encoder != "conv":
            raise ValueError(
                f"Sampler.{workflow} takes no detrended grid, which the "
                f"{self.cfg.txt_encoder!r} texture encoder reads: call "
                f"disentangle_vae.{workflow}(..., dt_x...) or "
                "Sampler.encode(pr_mat, c, dt_x) and Sampler.decode")
        return self.encode(pr_mat, c)

    def decode(self, z_chd, z_rhy) -> np.ndarray:
        """Latents -> estimated grids (B, T, K-1, 6) int32, as numpy."""
        with trace.span("sampler.decode"):
            zs = self._tensor(z_chd), self._tensor(z_rhy)
            fb, n = self.fixed_batch, zs[0].shape[0]
            if self.frame_decoder == "full" and fb is not None and n > fb:
                return self._decode_shared(*zs).cpu().numpy()
            grid = self._chunked(
                lambda params, fw, zc, zr: dv.decode_z(
                    params, self.cfg, zc, zr, self.frame_decoder, fw), *zs)
            chunks = 1 if fb is None else -(-n // fb)
            self.decoded_chunks += chunks * len(self.devices)
            self.decode_launches += chunks * len(self.devices)
            return grid.cpu().numpy()

    def reconstruct(self, pr_mat, c, sample: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> np.ndarray:
        with trace.span("sampler.reconstruct"):
            d_chd, d_rhy = self._encode_request("inference", pr_mat, c)
            if sample:
                return self.decode(d_chd.rsample(generator),
                                   d_rhy.rsample(generator))
            return self.decode(d_chd.mean, d_rhy.mean)

    # -- the four workflows --------------------------------------------------

    def swap(self, pr_mat1, pr_mat2, c1, c2, fix_rhy: bool, fix_chd: bool
             ) -> np.ndarray:
        """Compositional style transfer."""
        with trace.span("sampler.swap"):
            d_chd, d_rhy = self._encode_request(
                "swap", pr_mat1 if fix_rhy else pr_mat2,
                c1 if fix_chd else c2)
            return self.decode(d_chd.mean, d_rhy.mean)

    def posterior_sample(self, generator: torch.Generator, pr_mat, c,
                         scale: Optional[float] = None,
                         sample_chd: bool = True, sample_txt: bool = True
                         ) -> np.ndarray:
        """Texture/chord variation around the posterior."""
        with trace.span("sampler.posterior_sample"):
            d_chd, d_rhy = self._encode_request("posterior_sample", pr_mat,
                                                c)
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
        with trace.span("sampler.prior_sample"):
            d_chd, d_rhy = self._encode_request("prior_sample", pr_mat, c)
            z_chd = (DiagNormal(torch.zeros_like(d_chd.mean),
                                torch.full_like(d_chd.std, scale))
                     if sample_chd else d_chd).rsample(generator)
            z_rhy = (DiagNormal(torch.zeros_like(d_rhy.mean),
                                torch.full_like(d_rhy.std, scale))
                     if sample_rhy else d_rhy).rsample(generator)
            return self.decode(z_chd, z_rhy)

    def interp(self, pr_mat1, c1, pr_mat2, c2, interp_chd: bool = False,
               interp_rhy: bool = False, int_count: int = 10) -> np.ndarray:
        """Chord/texture SLERP interpolation -> (B, int_count, T, K-1, 6)."""
        with trace.span("sampler.interp"):
            d_chd1, d_rhy1 = self._encode_request("interp", pr_mat1, c1)
            d_chd2, d_rhy2 = self._encode_request("interp", pr_mat2, c2)
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
