"""Data and tensor parallelism on ``torch.distributed``.

Port of ``objectdetection_tpu.parallel``. JAX lays global arrays out on a
device mesh and XLA writes every collective into one program; here one
process drives one device, and the collectives are written out:

- :func:`initialize_multihost` starts the process group: NCCL on the card,
  gloo on the CPU. Two processes can share one card only over gloo, which
  stages CUDA tensors through the host (``backend="gloo"``).
- :func:`make_mesh` and :func:`make_dp_tp_mesh` build a ``DeviceMesh`` over
  the whole world with a ``data`` axis (and a ``model`` axis). One process
  drives one device, so ``make_mesh(n)`` takes only the world's size.
- :func:`batch_sharding` and :func:`replicated` are the DTensor placements
  ``(Shard(0),)`` and ``(Replicate(),)``. :func:`shard_batch` keeps this
  rank's contiguous rows of a host batch, on its device;
  :func:`gather_batch` puts every rank's rows back together.
- :func:`make_parallel_infer_fn` runs ``forward_inference`` on this rank's
  rows and all-gathers the fixed-shape detections, so that every rank holds
  the global batch's, as JAX's global output array.
- :func:`make_parallel_train_step` equals ``detector.train_step`` on the
  whole batch. The target noise is drawn for the global batch and this
  rank's rows kept. Each loss is this rank's numerator over the global
  batch's count (the denominators all-reduced, without gradient), so the
  gradients are summed, not averaged, over ``data``, in flat buckets. The
  metrics are the losses summed over ``data``.
- :func:`shard_state_tp` splits a float leaf over ``model`` on its
  out-feature dim (flax's last dim, ``convert.out_feature_dim``) where
  that dim is at least ``min_dim`` and divisible by the axis size
  (:func:`tp_split_dims`); momenta follow. :func:`make_tp_train_step`, given
  that map, rebuilds each split weight in the
  forward (all-gather along that dim; the backward keeps this rank's slice
  of the gradient, since every rank of a ``model`` group computes the same
  downstream), sums the squares of split gradients over ``model`` for the
  clipping and per-head norms, and updates the slices. Storage and update
  are split; the head products are not.

A collective needs the same shapes on every rank: the detections are
padded to a fixed size, and a batch must divide by the ``data`` axis.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from objectdetection_torch import detector, optim
from objectdetection_torch.config import DetectorConfig
from objectdetection_torch.convert import out_feature_dim, require_on, resolve_device

DATA, MODEL = "data", "model"
# gradients and broadcast state travel in flat buffers of one dtype and at
# most this many bytes (a larger tensor goes alone)
BUCKET_BYTES = 1 << 26


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> None:
    """Start the default process group for this process.

    With ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id``, rendezvous over TCP there; without them, read the
    variables a ``torchrun`` launch sets (``env://``); without those either,
    make a world of one on a free local port. On the card this process
    takes ``device`` if it names an index, else ``cuda:$LOCAL_RANK``; the
    backend defaults to NCCL there and to gloo on the CPU.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, world_size=1, rank=0)


def _world(device) -> int:
    if not dist.is_initialized():
        initialize_multihost(device=device)
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = (DATA,),
              device="cuda") -> DeviceMesh:
    """A mesh over every process of the world on its first axis (the others
    of size 1), starting a world of one if no process group exists.
    ``n_devices`` may only restate the world's size: each process drives
    one device, so a mesh over fewer devices would leave processes out."""
    world = _world(device)
    if n_devices not in (None, world):
        raise ValueError(f"make_mesh({n_devices}): the mesh spans the world's {world} "
                         "processes, one device each")
    shape = (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=tuple(axis_names))


def make_dp_tp_mesh(dp: int, tp: int, device="cuda") -> DeviceMesh:
    """2-D mesh: the batch over ``data``, large head weights over ``model``.
    Rank ``d * tp + t`` sits at (d, t), as JAX's ``reshape(dp, tp)``."""
    world = _world(device)
    if dp * tp != world:
        raise ValueError(f"a {dp}×{tp} mesh needs {dp * tp} processes, the world has {world}")
    return init_device_mesh(resolve_device(device).type, (dp, tp), mesh_dim_names=(DATA, MODEL))


def batch_sharding(mesh: DeviceMesh):
    """Placements of a batch: rows split over ``data``, whole on every other axis."""
    return tuple(Shard(0) if name == DATA else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    """Placements of a tensor every rank holds whole."""
    return (Replicate(),) * mesh.ndim


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_size(mesh: DeviceMesh) -> int:
    """The number of ranks on the ``data`` axis."""
    return _size(mesh, DATA)


def data_rank(mesh: DeviceMesh) -> int:
    """This rank's coordinate on the ``data`` axis: its rows of a batch."""
    return mesh.get_local_rank(DATA)


def is_lead() -> bool:
    """Whether this process is rank 0 of the world, the one that prints."""
    return dist.get_rank() == 0


def _local(x: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's piece of the whole tensor ``x``: for each mesh axis that
    shards dim ``d``, the contiguous chunk at this rank's coordinate."""
    for axis, p in enumerate(placements):
        if isinstance(p, Shard):
            n, d = mesh.size(axis), p.dim
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of size {x.shape[d]} does not split over "
                                 f"{mesh.mesh_dim_names[axis]} of size {n}")
            size = x.shape[d] // n
            x = x.narrow(d, mesh.get_local_rank(axis) * size, size)
    return x


def _map(fn, batch):
    """``fn`` over a tensor, or over the fields of a tuple (``None`` kept)."""
    if isinstance(batch, tuple):
        fields = [None if x is None else fn(x) for x in batch]
        return type(batch)(*fields) if hasattr(batch, "_fields") else tuple(fields)
    return fn(batch)


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows ``[r·B/dp, (r+1)·B/dp)`` of a host batch (an array,
    or a tuple of them such as ``TrainBatch``), on its device."""
    dev, place = _device(mesh), batch_sharding(mesh)
    return _map(lambda x: _local(torch.as_tensor(x), mesh, place).to(dev), batch)


def _all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim`` in rank
    order. Sent as bytes, which every backend carries whatever the dtype."""
    raw = x.contiguous().view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, raw, group=group)
    return torch.cat([p.view(x.dtype) for p in parts], dim)


def gather_batch(batch, mesh: DeviceMesh):
    """Every ``data`` rank's rows in rank order: the inverse of
    :func:`shard_batch` (an array or tuple of them, on this rank's device)."""
    dev, group = _device(mesh), mesh.get_group(DATA)
    return _map(lambda x: _all_gather(torch.as_tensor(x, device=dev), group), batch)


def make_parallel_infer_fn(config: DetectorConfig, mesh: DeviceMesh, with_masks: bool = True):
    """Data-parallel inference: ``infer_fn(params, images, windows)`` on this
    rank's rows (from :func:`shard_batch`) returns the ``Detections`` of the
    whole batch. ``params`` live on this rank's device."""
    infer = detector.make_infer_fn(config, with_masks, device=_device(mesh))

    def infer_fn(params, images, windows):
        det = infer(params, images, windows)
        with torch.inference_mode():
            return gather_batch(det, mesh)

    return infer_fn


def _collective(tensors: List[torch.Tensor], op) -> List[torch.Tensor]:
    """New tensors: ``op`` (an in-place collective) applied to ``tensors``
    through flat buffers of one dtype and at most BUCKET_BYTES each. Every
    rank must pass the same shapes and dtypes in the same order."""
    out = list(tensors)
    bucket: List[int] = []
    size = 0

    def flush():
        flat = torch.cat([tensors[i].reshape(-1) for i in bucket])
        op(flat)
        for i, piece in zip(bucket, flat.split([tensors[i].numel() for i in bucket])):
            out[i] = piece.view_as(tensors[i])

    for i in sorted(range(len(tensors)), key=lambda i: str(tensors[i].dtype)):
        nbytes = tensors[i].numel() * tensors[i].element_size()
        if bucket and (tensors[bucket[0]].dtype != tensors[i].dtype
                       or size + nbytes > BUCKET_BYTES):
            flush()
            bucket, size = [], 0
        bucket.append(i)
        size += nbytes
    if bucket:
        flush()
    return out


def all_reduce(named: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The sum of ``named`` over ``group``, bucketed."""
    return dict(zip(named, _collective(list(named.values()),
                                       lambda flat: dist.all_reduce(flat, group=group))))


def replicate_state(state: detector.TrainState, mesh: DeviceMesh) -> detector.TrainState:
    """Every leaf of ``state`` (params, batch_stats, momenta) as rank 0 holds
    it, on every rank: ranks start equal whatever their seeds."""
    dev = _device(mesh)

    def broadcast(leaves):
        leaves = {k: v.to(dev) for k, v in leaves.items()}
        return dict(zip(leaves, _collective(list(leaves.values()),
                                            lambda flat: dist.broadcast(flat, 0))))

    return detector.TrainState(broadcast(state.params), broadcast(state.batch_stats),
                               optim.OptState(broadcast(state.opt_state.trace),
                                              state.opt_state.count), state.step)


class _GatherOut(torch.autograd.Function):
    """A weight split over the ``model`` group, whole: all-gather along
    ``dim``. The backward keeps this rank's slice of the gradient: every rank
    of the group computes the same downstream, so a sum over the group
    (``torch.distributed.nn``'s all-gather) would give tp× the gradient."""

    @staticmethod
    def forward(ctx, local, dim, group):
        ctx.dim, ctx.n, ctx.rank = dim, dist.get_world_size(group), dist.get_rank(group)
        return _all_gather(local, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None


def tp_split_dims(params: Dict[str, torch.Tensor], tp: int,
                  min_dim: int = 512) -> Dict[str, int]:
    """JAX's ``shard_state_tp`` rule in the port's layout: each float leaf of
    two or more dims whose out-feature dim is at least ``min_dim`` and
    divisible by ``tp``, with that dim."""
    dims = {}
    for name, t in params.items():
        d = out_feature_dim(name)
        if t.is_floating_point() and t.dim() >= 2 and t.shape[d] >= min_dim \
                and t.shape[d] % tp == 0:
            dims[name] = d
    return dims


def shard_state_tp(state: detector.TrainState, mesh: DeviceMesh,
                   min_dim: int = 512) -> detector.TrainState:
    """This rank's train state with the leaves of :func:`tp_split_dims` (and
    their momenta) cut to its slice over ``model``; the rest whole."""
    dev = _device(mesh)
    dims = tp_split_dims(state.params, _size(mesh, MODEL), min_dim)

    def placement(name):
        if name not in dims:
            return replicated(mesh)
        return tuple(Shard(dims[name]) if a == MODEL else Replicate()
                     for a in mesh.mesh_dim_names)

    def place(leaves):  # each slice in storage of its own
        return {k: _local(t, mesh, placement(k)).to(dev).clone(
            memory_format=torch.contiguous_format) for k, t in leaves.items()}

    return detector.TrainState(place(state.params), place(state.batch_stats),
                               optim.OptState(place(state.opt_state.trace),
                                              state.opt_state.count), state.step)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def make_parallel_train_step(config: DetectorConfig, mesh: DeviceMesh, with_masks: bool = False,
                             train_layers: str = "all", split: Optional[Dict[str, int]] = None):
    """Data-parallel training: ``step(state, shard, generator=None,
    noise=None) -> (state, metrics)`` on this rank's rows (from
    :func:`shard_batch`) and a replicated state (:func:`replicate_state`)
    equals ``detector.train_step`` on the whole batch. ``generator`` is
    seeded alike on every rank; ``noise``, if given, is the whole batch's.
    ``split`` names the leaves the state holds a slice of over ``model``
    (from :func:`shard_state_tp`), each with its dim: :func:`tp_split_dims`
    of the whole params."""
    detector.check_supported(config, training=True)
    dev = _device(mesh)
    data = mesh.get_group(DATA)
    split = dict(split or {})
    if split and MODEL not in mesh.mesh_dim_names:
        raise ValueError(f"{next(iter(split))} is split, but the mesh has no model axis")
    model = mesh.get_group(MODEL) if split else None
    place = batch_sharding(mesh)

    def step(state: detector.TrainState, shard: detector.TrainBatch, generator=None,
             noise: Optional[detector.TrainNoise] = None):
        require_on(dev, state.params, "the train state")
        shard = detector.TrainBatch(*(None if x is None else torch.as_tensor(x, device=dev)
                                      for x in shard))
        if noise is None:
            rows = shard.images.shape[0] * data_size(mesh)
            noise = detector.draw_noise(config, shard, generator, rows)
        noise = detector.TrainNoise(*(tuple(_local(t.to(dev), mesh, place) for t in pair)
                                      for pair in noise))

        def squares(tensors):
            return torch.stack([n.square() for n in torch._foreach_norm(tensors)]).sum() \
                if tensors else torch.zeros((), device=dev)

        def norm(grads):
            local = squares([g for k, g in grads.items() if k not in split])
            return (local + _sum(squares([g for k, g in grads.items() if k in split]),
                                 model)).sqrt()

        sync = detector.Sync(
            weights=lambda leaves: {k: _GatherOut.apply(v, split[k], model) if k in split else v
                                    for k, v in leaves.items()},
            count=lambda c: _sum(c, data),
            grads=lambda grads: all_reduce(grads, data),
            norm=norm if split else optim.named_norm)
        state, metrics = detector.train_step(state, shard, None, config, with_masks,
                                             train_layers, noise, sync)
        losses = [k for k in metrics if not k.startswith("grad_norm/")]
        metrics.update(all_reduce({k: metrics[k] for k in losses}, data))
        return state, metrics

    return step


def make_tp_train_step(config: DetectorConfig, mesh: DeviceMesh, split: Dict[str, int],
                       with_masks: bool = False, train_layers: str = "all"):
    """dp×tp training: ``run(state_tp, batch, generator=None, noise=None)``
    on the whole host batch, sharded over ``data`` here, and a state from
    :func:`shard_state_tp`; ``split`` is the map it split by
    (:func:`tp_split_dims` of the whole params)."""
    step = make_parallel_train_step(config, mesh, with_masks, train_layers, split)

    def run(state_tp, batch, generator=None, noise=None):
        return step(state_tp, shard_batch(batch, mesh), generator, noise)

    return run
