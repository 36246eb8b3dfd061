"""Data parallelism over torch.distributed: one process a rank, each rank
stepping its own contiguous shard of the envs.

Counterpart of `pulse_tpu/parallel/mesh.py`, the reference's Horovod mode:
each rank steps its envs, and the gradients are all-reduced around one
optimizer step that is the same on every rank. JAX shards the env axis
over a device mesh and lets `shard_map` insert the collectives; here each
rank is a process, and the update paths call the collectives below.

  * `make_mesh` wraps an initialised process group: rank, world size,
    backend and device. `use_mesh(env, mesh)` sets `env.mesh`,
    which routes every agent's update to its data-parallel variant (the
    PPO, AMP and distillation `_update_dp`; `update_rnn` gathers the
    rollout and computes the global update), and re-seeds the env's
    generator from (seed, rank) so that the shards do not replay the same
    resets. The agents' rank-local draws (action and latent noise, AMP's
    replay and dropout masks) come from `rollout_generator`; their
    replicated draws keep the agent's own generator, seeded alike on every
    rank.
  * `replicate` and `shard_train_state` broadcast rank 0's replicated
    state (parameters, optimizer moments, normalizers, demo and replay
    buffers); `shard_env_axis` keeps a rank's contiguous slice of the env
    axis.
  * collectives: a mean or sum all-reduce of a list of tensors in one
    buffer, the global moments of row batches (`pmoments`, E[x²] − m²), an
    autograd-aware global mean (`global_mean`) and an ordered all-gather
    (`all_gather_rows`).

The backend and the device are the caller's: NCCL on the card; gloo on the
CPU, or for ranks that share one card (NCCL refuses two ranks on one
device). Nothing falls back from one to the other. Under gloo the
collectives run on host copies of the tensors. The gather is a sum
all-reduce of a zero-filled buffer in which each rank fills its own slot,
taken over the tensors' bits as integers: exact, and the same code on both
backends.
"""

from __future__ import annotations

import dataclasses
import datetime
import time

import torch
import torch.distributed as dist

RANK_SEED_STRIDE = 1_000_003   # rank r's streams start from seed + (r + 1) * stride
PROCESS_GROUP_TIMEOUT = datetime.timedelta(seconds=600)   # a collective that waits longer raises
_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass
class Mesh:
    rank: int
    size: int
    device: torch.device       # where the rank's envs, networks and rollouts live
    backend: str               # "nccl" or "gloo"
    # with `timed`, every collective is bracketed by device synchronizes and
    # its host seconds are summed here
    timed: bool = False
    collective_s: float = 0.0
    collective_calls: int = 0


def init_process_group(backend: str, rank: int, world_size: int, store_path, device=None) -> None:
    """Initialise the default process group through a file store at
    `store_path`, the same path on every rank (a fresh file: a used one
    holds the last group's keys). NCCL needs the rank's CUDA device."""
    kw = {}
    if backend == "nccl":
        dev = torch.device(device) if device is not None else None
        if dev is None or dev.type != "cuda":
            raise ValueError("an NCCL process group needs the rank's CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}: nccl or gloo")
    store = dist.FileStore(str(store_path), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=PROCESS_GROUP_TIMEOUT, **kw)


def make_mesh(device) -> Mesh:
    """The mesh of the initialised default process group, its tensors on
    `device`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (init_process_group)")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend())
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL mesh keeps its tensors on a CUDA device")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(), device=dev, backend=backend)


def rank_seed(seed: int, mesh: Mesh) -> int:
    """The seed of a rank-local stream of `seed` (never `seed` itself, so a
    rank's stream is not the replicated one's)."""
    return int(seed) + RANK_SEED_STRIDE * (mesh.rank + 1)


def use_mesh(env, mesh: Mesh | None) -> None:
    """Route the updates of every agent on `env` through `mesh` (None:
    back to the single-process updates), and re-seed the env's generator
    from (its seed, the rank)."""
    env.mesh = mesh
    if mesh is not None and hasattr(env, "generator"):
        env.generator.manual_seed(rank_seed(env.seed, mesh))


def rollout_generator(agent) -> torch.Generator:
    """The generator of an agent's rank-local draws: its own `generator`
    without a mesh; under `agent.env.mesh` one seeded from (agent.seed,
    rank), made at the first call."""
    mesh = getattr(agent.env, "mesh", None)
    if mesh is None:
        return agent.generator
    held = getattr(agent, "_rank_generator", None)
    if held is None or held[0] is not mesh:
        held = (mesh, torch.Generator(device=agent.device).manual_seed(rank_seed(agent.seed, mesh)))
        agent._rank_generator = held
    return held[1]


# --------------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------------- #

def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _collective(mesh: Mesh, fn, t: torch.Tensor) -> None:
    """fn(buffer) in place on t, on a host copy under gloo; timed with
    `mesh.timed`."""
    if mesh.timed:
        _sync(mesh)
        t0 = time.perf_counter()
    if mesh.backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        fn(host)
        t.copy_(host)
    else:
        fn(t)
    if mesh.timed:
        _sync(mesh)
        mesh.collective_s += time.perf_counter() - t0
        mesh.collective_calls += 1


def _all_reduce_flat_(tensors: list, mesh: Mesh, divisor: int | None) -> None:
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _collective(mesh, lambda b: dist.all_reduce(b, op=dist.ReduceOp.SUM), flat)
    if divisor is not None:
        flat.div_(divisor)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def grads_of(params: list) -> list:
    """Each parameter's gradient, zeros where backward left none, so that
    every rank reduces the same tensors."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def all_reduce_mean_(tensors: list, mesh: Mesh) -> None:
    """Each tensor replaced, in place, by its mean over the ranks (the sum
    over the ranks divided by their count, as `pmean`): one all-reduce of
    one buffer. The tensors share a dtype and a device."""
    _all_reduce_flat_(tensors, mesh, mesh.size)


def all_reduce_sum_(tensors: list, mesh: Mesh) -> None:
    """Each tensor replaced, in place, by its sum over the ranks (`psum`)."""
    _all_reduce_flat_(tensors, mesh, None)


def pmoments(x: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The global (mean, var) over the rows of every rank's [n, d] batch
    (the same n on every rank): the mean of the ranks' row means and
    E[x²] − m², clamped at 0."""
    buf = torch.stack([x.mean(dim=0), (x * x).mean(dim=0)])
    all_reduce_mean_([buf], mesh)
    m, e2 = buf[0], buf[1]
    return m, torch.clamp(e2 - m * m, min=0.0)


class _GlobalMean(torch.autograd.Function):
    """Forward: the mean over the ranks of each rank's local values.
    Backward: the incoming gradient over the rank count, with no collective
    (pmean's VJP); the gradients a loss of global means leaves are then
    summed over the ranks (`all_reduce_sum_`)."""

    @staticmethod
    def forward(ctx, mesh, *local):
        ctx.scale = 1.0 / mesh.size
        buf = torch.stack([v.detach() for v in local])
        all_reduce_mean_([buf], mesh)
        return tuple(v.clone() for v in buf.unbind())

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(g * ctx.scale for g in grads))


def global_mean(values: list, mesh: Mesh) -> tuple:
    """The mean of each tensor over all its elements on all the ranks (the
    same size on each), in one all-reduce; differentiable, with each rank's
    gradient carrying the 1 / size of pmean's VJP."""
    return _GlobalMean.apply(mesh, *[v.mean() for v in values])


def all_gather_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's x (the same shape on each) concatenated along `dim` in
    rank order, on every rank, bit for bit."""
    x = x.contiguous()
    bits = x.view(_INT_OF_SIZE[x.element_size()]) if (x.is_floating_point() or x.dtype == torch.bool) else x
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * mesh.size
    buf = torch.zeros(shape, dtype=bits.dtype, device=x.device)
    buf.narrow(dim, mesh.rank * n, n).copy_(bits)
    _collective(mesh, lambda b: dist.all_reduce(b, op=dist.ReduceOp.SUM), buf)
    return buf.view(x.dtype) if bits is not x else buf


def gather_env_axis(tree, mesh: Mesh, dim: int = 0):
    """`all_gather_rows` along `dim` of every tensor of a tensor, tuple,
    dict or dataclass (None and non-tensors kept)."""
    if isinstance(tree, torch.Tensor):
        return all_gather_rows(tree, mesh, dim)
    if isinstance(tree, tuple):
        return tuple(gather_env_axis(t, mesh, dim) for t in tree)
    if isinstance(tree, dict):
        return {k: gather_env_axis(v, mesh, dim) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: gather_env_axis(getattr(tree, f.name), mesh, dim)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def broadcast_(tensors: list, mesh: Mesh, src: int = 0) -> None:
    """Rank src's values into every rank's tensors, in place, one broadcast
    a dtype."""
    by_dtype: dict = {}
    seen = set()
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in group])
        _collective(mesh, lambda b: dist.broadcast(b, src=src), flat)
        with torch.no_grad():
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))


# --------------------------------------------------------------------------- #
# placing train states
# --------------------------------------------------------------------------- #

def collect_replicated(obj, skip: tuple = ()) -> tuple[list, list]:
    """(the tensors, the (holder, field) of every bool / int / float field)
    of a replicated state, recursively, fields named in `skip` left out:
    what `replicate` broadcasts."""
    tensors, scalars = [], []
    _collect(obj, tensors, scalars, skip)
    return tensors, scalars


def _collect(obj, tensors: list, scalars: list, skip: tuple) -> None:
    if obj is None:
        return
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
    elif isinstance(obj, torch.nn.Module):
        tensors.extend(obj.parameters())
        tensors.extend(obj.buffers())
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group["params"]:
                st = obj.state.get(p, {})
                tensors.extend(st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            if f.name in skip:
                continue
            v = getattr(obj, f.name)
            if isinstance(v, (bool, int, float)):
                scalars.append((obj, f.name))
            else:
                _collect(v, tensors, scalars, skip)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _collect(v, tensors, scalars, skip)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _collect(obj[k], tensors, scalars, skip)


def replicate(mesh: Mesh, obj, skip: tuple = ()):
    """Rank 0's values of every tensor and number in `obj` (a train state,
    a module, an optimizer, a normalizer, a buffer, or containers of these;
    fields named in `skip` left alone) on every rank, in place. Returns obj."""
    tensors, scalars = collect_replicated(obj, skip)
    broadcast_(tensors, mesh)
    if scalars:
        vals = torch.tensor([float(getattr(h, n)) for h, n in scalars], dtype=torch.float64, device=mesh.device)
        broadcast_([vals], mesh)
        for (h, n), v in zip(scalars, vals.tolist()):
            setattr(h, n, type(getattr(h, n))(v))
    return obj


def shard_env_axis(mesh: Mesh, tree):
    """This rank's contiguous slice of the leading (env) axis of every
    tensor of `tree` with one (copies; 0-d tensors and non-tensors kept).
    Raises ValueError unless the mesh size divides the axis."""
    if isinstance(tree, torch.Tensor):
        if tree.ndim == 0:
            return tree
        n = tree.shape[0]
        if n % mesh.size:
            raise ValueError(f"the env axis ({n}) must be divisible by the mesh size ({mesh.size})")
        k = n // mesh.size
        return tree[mesh.rank * k:(mesh.rank + 1) * k].clone()
    if isinstance(tree, tuple):
        return tuple(shard_env_axis(mesh, t) for t in tree)
    if isinstance(tree, dict):
        return {k: shard_env_axis(mesh, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: shard_env_axis(mesh, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


_RANK_LOCAL = ("env_state", "hidden")   # a train state's per-env fields


def shard_train_state(mesh: Mesh, ts):
    """A PPO, AMP, distillation or joint train state placed on the mesh, in
    place: the env state (and a recurrent carry) sliced to this rank's
    envs, everything else replicated from rank 0. Returns ts."""
    if hasattr(ts, "amp") and hasattr(ts, "distill"):     # JointTrainState
        shard_train_state(mesh, ts.amp)
        shard_train_state(mesh, ts.distill)
        return ts
    if hasattr(ts, "ppo"):                                 # AMPTrainState
        shard_train_state(mesh, ts.ppo)
        replicate(mesh, ts.amp)
        return ts
    replicate(mesh, ts, skip=_RANK_LOCAL)
    for name in _RANK_LOCAL:
        if getattr(ts, name, None) is not None:
            setattr(ts, name, shard_env_axis(mesh, getattr(ts, name)))
    return ts
