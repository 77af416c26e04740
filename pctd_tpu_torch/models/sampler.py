"""Serving sampler (``pctd_tpu/models/sampler.py``): the four latent-control
workflows over a fixed batch shape, with numpy results.

A request's rows reach the kernels by one route (``Sampler._plan``):
``fixed_batch=N`` cuts them into N-row chunks, the last one padded with
zero rows, and the results are sliced back to the real rows; without it
the request is one chunk of all its rows. The decode hands every chunk to
``disentangle_vae.decode_z_chunks`` at once, which launches the chosen
kernel: ``frame_decoder="full"`` (K4, the default) or ``"frame"`` (K3 per
frame, time GRU in torch). On the K4 route the chunks of one decode share
K4 launches, as many a launch as the card runs at once (each chunk's K4
inputs are still computed at the chunk's shape, so its rows decode to the
bits of a launch of their own); on the K3 route each chunk is decoded
alone. ``decoded_chunks`` and ``decode_launches`` count, per Sampler, the
chunks decoded (an unchunked decode is one) and the decode launches made
for them (K4 launches; one a chunk on the K3 route), each once a device.

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
copy of the (folded) weights; a device's share of a chunk is its real
rows, then zero rows; every device's launches are issued before any
result is read, and the results come back to the first device in row
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


def _padded(rows: torch.Tensor, width: int) -> torch.Tensor:
    """``rows`` then zero rows up to ``width`` rows: a share as the kernels
    take it."""
    if rows.shape[0] == width:
        return rows
    return torch.cat([rows, rows.new_zeros((width - rows.shape[0],)
                                           + rows.shape[1:])])


def fill_rows(static: torch.Tensor, rows: torch.Tensor) -> None:
    """Write ``rows`` over the first rows of ``static`` and zeros over the
    rest: in place, what :func:`_padded` makes."""
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

    def _plan(self, n: int):
        """How a request of ``n`` rows reaches the kernels: (``share``,
        [(``take``, ``slices``) for each chunk]). A chunk is
        ``fixed_batch`` rows (one chunk of all ``n`` rows without it) of
        which ``take`` are real; ``slices[i]`` are the request's rows in
        device ``i``'s share of it, which the kernels take as ``share``
        rows: those rows, then zero rows (:func:`_padded`, or
        :func:`fill_rows` in place)."""
        if n == 0:
            raise ValueError("empty batch")
        width = self.fixed_batch
        if width is None:
            if n % len(self.devices):
                raise ValueError(f"batch {n} not divisible by the mesh's "
                                 f"{len(self.devices)} devices")
            width = n
        share = width // len(self.devices)
        chunks = []
        for lo in range(0, n, width):
            end = min(lo + width, n)
            chunks.append((end - lo, [
                slice(min(lo + i * share, end), min(lo + (i + 1) * share, end))
                for i in range(len(self.devices))]))
        return share, chunks

    def _replay(self, i: int, rows, share: int):
        """Device ``i``'s encode of its real ``rows`` of a chunk in one
        replay of its graph of the rows' shapes, captured at its first use:
        the rows written into the graph's inputs over zero padding, and the
        posteriors taken as new tensors before the graph runs again."""
        key = (i,) + tuple(tuple(x.shape[1:]) for x in rows)
        if key not in self._graphs:
            params, _ = self._replicas[i]
            graph = EncodeGraph(
                lambda *rows: dv.encode(params, self.cfg, *rows),
                [(share,) + k for k in key[1:]], self.devices[i], self._pool)
            self._graphs[key], self._pool = graph, graph.pool
        graph = self._graphs[key]
        for static, x in zip(graph.inputs, rows):
            fill_rows(static, x)
        graph.replay()
        return _map(torch.clone, graph.outputs)

    def encode(self, pr_mat, c, dt_x=None):
        """(B, T, 128) duration matrices, (B, T/4, 36) chords and, for the
        pianotree texture encoder, the (B, 32, 16, 39) detrended grids ->
        (chord, texture) posteriors on the device. Each device's share of
        a chunk is one graph replay on the card with a fixed batch, else
        ``disentangle_vae.encode`` op by op on the zero-padded share; every
        device's share of a chunk is launched before any result is read."""
        with trace.span("sampler.encode"):
            arrays = [self._tensor(pr_mat), self._tensor(c)]
            if dt_x is not None:
                arrays.append(self._tensor(dt_x))
            share, chunks = self._plan(arrays[0].shape[0])
            outs = []
            for take, slices in chunks:
                parts = []
                for i, (device, part) in enumerate(zip(self.devices, slices)):
                    rows = [a[part] for a in arrays]
                    replay = self.fixed_batch is not None and _replays(device)
                    with _on(device):
                        parts.append(self._replay(i, rows, share) if replay
                                     else dv.encode(
                                         self._replicas[i][0], self.cfg,
                                         *(_padded(x, share).to(device)
                                           for x in rows)))
                    self.encoded_chunks += 1
                    self.encode_replays += replay
                outs.append(_map(lambda t: t[:take], _concat(
                    [_map(lambda t: t.to(self.device), p) for p in parts])))
            return _concat(outs)

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
        """Latents -> estimated grids (B, T, K-1, 6) int32, as numpy: each
        device's zero-padded shares of every chunk in one
        ``disentangle_vae.decode_z_chunks``, which picks the launches."""
        with trace.span("sampler.decode"):
            zs = self._tensor(z_chd), self._tensor(z_rhy)
            share, chunks = self._plan(zs[0].shape[0])
            grids = []
            for i, (device, (params, fw)) in enumerate(zip(self.devices,
                                                           self._replicas)):
                with _on(device):
                    got, launches = dv.decode_z_chunks(params, self.cfg, [
                        [_padded(z[slices[i]], share).to(device) for z in zs]
                        for _, slices in chunks], self.frame_decoder, fw)
                grids.append(got)
                self.decoded_chunks += len(chunks)
                self.decode_launches += launches
            return _concat([
                _concat([g[j].to(self.device) for g in grids])[:take]
                for j, (take, _) in enumerate(chunks)]).cpu().numpy()

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
