"""Multi-device training: data parallel (dp) x graph parallel (gp).

Counterpart of geobignn_tpu/parallel/api.py.  The JAX step is one
`shard_map` program over a (dp, gp) device mesh; here one process holds a
(dp, gp) grid of torch devices (`make_mesh`) and drives it:

  * dp: replica r takes its slice of the stacked batch and runs the model
    on mesh[r] with a copy of the parameters there; autograd sums every
    replica's gradient into the one parameter set, which is divided by the
    global batch, as the JAX step's psum and division;
  * gp: each conv's edge list is cut into one contiguous slice per device of
    the replica's row, each device aggregates its slice and the partial
    aggregates and degrees are summed (ops/feastconv.feast_conv's
    `shard_devices`, the JAX psum); the node features and everything
    between the convs, replicated on every gp device in JAX, are computed
    once on the row's first device.  Under dp or gp every conv is the COO
    conv (the sharded model drops bands and tables, as JAX's
    `DualGNN(gp_axis=...)` does).

Several grid entries may name one device: the CPU tests run every replica
on the CPU, one card runs them all on cuda:0.

dcn (the JAX package's cross-host data-parallel axis) is a leading axis of
replicas over the (dp, gp) grid, laid out (dcn, dp, gp) as JAX lays out its
devices: the batch is split over dcn * dp replicas, dcn-major.  In one
process `make_mesh(..., dcn=k)` holds the whole (dcn, dp, gp) grid.  Across
processes (`distributed_init`, one process per dcn entry) each process
holds its own (dp, gp) grid and runs its replicas, and the summed
gradients and metrics are added over the process group in one all-reduce
per step — JAX's one pmean across DCN.

The step is one CUDA graph per batch shape (capture.py), as the JAX step is
one `jit`, where the whole grid lives on one card in one process
(capture.one_card): one card holding every replica, and dcn in one
process.  A grid over several cards, and dcn over several processes (whose
all-reduce would have to be captured from NCCL), run eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from geobignn_tpu_torch import capture
from geobignn_tpu_torch.data import augment as aug
from geobignn_tpu_torch.models import losses
from geobignn_tpu_torch.structs import DualSample, _Struct
from geobignn_tpu_torch.utils import resolve_device


def _group_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def distributed_init(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> None:
    """Join the process group of a multi-process dcn run: one process per
    dcn entry, `coordinator` the group's rendezvous (an init_method URL,
    "tcp://host:port" or "file:///path"), `process_id` this process's
    rank.  gloo on the CPU, NCCL on cards (`device`, CUDA unless "cpu").
    A no-op for one process, or when the group is up already."""
    if not num_processes or num_processes <= 1 or _group_size() > 1:
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=coordinator, world_size=num_processes,
                            rank=process_id)


def make_mesh(dp: int, gp: int, devices=None, dcn: int = 1) -> list:
    """The device grid, row-major over `devices`: (dp, gp) for dcn == 1;
    for dcn > 1 in one process (dcn, dp, gp), the JAX layout; in a process
    group of dcn processes (distributed_init), this process's own (dp, gp)
    grid.  devices=None takes the visible cards (in a group whose host sees
    them all, this process's block of them) and raises with fewer; an
    explicit list may name one device several times."""
    procs = _group_size()
    if procs > 1 and procs != dcn:
        raise ValueError(f"dcn={dcn} in a process group of {procs} processes")
    local = dcn // procs  # the dcn entries this process holds
    need = local * dp * gp
    if devices is None:
        n = torch.cuda.device_count()
        first = dist.get_rank() * need if procs > 1 and n >= procs * need else 0
        devices = [torch.device("cuda", i) for i in range(first, n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    rows = [devices[r * gp : (r + 1) * gp] for r in range(local * dp)]
    if dcn == 1 or procs > 1:
        return rows
    return [rows[k * dp : (k + 1) * dp] for k in range(dcn)]


def replica_rows(mesh: list) -> list[list[torch.device]]:
    """The grid's replicas, each its row of gp devices, dcn-major."""
    return [row for grid in mesh for row in grid] if isinstance(mesh[0][0], list) else mesh


def _map_leaves(fn, values: list):
    """fn over the corresponding arrays of several structs of one shape."""
    first = values[0]
    if isinstance(first, _Struct):
        return dataclasses.replace(first, **{
            f.name: _map_leaves(fn, [getattr(v, f.name) for v in values])
            for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        return tuple(_map_leaves(fn, list(vs)) for vs in zip(*values))
    if isinstance(first, (np.ndarray, np.generic)) or torch.is_tensor(first):
        return fn(values)
    return first  # static ints and None


def stack_samples(samples: list[DualSample]) -> DualSample:
    """Same-SizePlan samples stacked into one batched sample (leading axis B)."""
    return _map_leaves(lambda xs: np.stack([np.asarray(x) for x in xs]), samples)


def sample_at(batched: DualSample, i) -> DualSample:
    """Sample i (or the slice i) of a stacked batch, of arrays or of tensors
    (views)."""
    return _map_leaves(lambda xs: xs[0][i], [batched])


def batch_size_of(batched: DualSample) -> int:
    return int(batched.v.x.shape[0])


def dual_loss_and_metrics(model, params, sample: DualSample, cfg: dict,
                          gp_devices: list | None = None) -> tuple:
    """(loss, metrics dict) of one sample.  `params`: name -> tensor to run
    the model with (torch.func.functional_call; None for its own);
    `gp_devices`, the edge-sharded convs' devices (graph parallel)."""
    kwargs = {} if gp_devices is None else {"gp_devices": gp_devices}
    if params is None:
        vert_p, norm_p = model(sample, **kwargs)
    else:
        vert_p, norm_p = functional_call(model, params, (sample,), kwargs)
    mask_v = sample.v.levels[0].node_mask
    mask_f = sample.f.levels[0].node_mask
    lv = losses.loss_v(vert_p, sample.v.y, mask_v, cfg.get("loss_v", "L1"))
    ln = losses.loss_n(norm_p, sample.f.y, mask_f, cfg.get("loss_n", "L1"))
    loss = losses.dual_loss(lv, ln, cfg.get("loss_v_scale", 1.0), cfg.get("loss_n_scale", 1.0))
    metrics = dict(loss=loss, loss_v=lv, loss_f=ln,
                   error_v=losses.error_v(vert_p, sample.v.y, mask_v),
                   error_f=losses.error_n(norm_p, sample.f.y, mask_f))
    return loss, metrics


def _rotation_seed(seed: int, rank: int, i: int) -> int:
    """The seed of sample i of replica `rank` (the JAX fold_in chain)."""
    return int(np.random.SeedSequence([seed, rank, i]).generate_state(1)[0])


def make_sharded_train_step(model, optimizer, mesh: list, loss_cfg: dict | None = None,
                            augment: bool = False, gp_shard: bool = True):
    """The step over the grid: step(batch, seed) -> metrics.

    `batch` is a stacked batch (stack_samples) of B samples, B divisible by
    the replica count R (dcn * dp); replica r (dcn-major over the grid's
    rows) runs samples [r*B/R, (r+1)*B/R) on its row.  The gradients of all
    B samples are summed into the model's parameters and divided by B, then
    `optimizer` takes one step.  In a process group each process runs its
    own replicas (the group's rank-th block of the batch) and the sums are
    added over the group in one all-reduce.  The metrics are the means over
    the batch, as tensors on the parameters' device.  With `augment` each
    sample gets its own rotation, drawn before the step from a
    torch.Generator seeded by (seed, replica, index).  gp_shard=False keeps
    each replica's edges whole (dynamic pooling, which is dp-only).

    Each replica's block of the batch is copied to its row's first device;
    then, where the grid is on one card in one process and the optimizer is
    capturable (Adam on the card), the step is one replay of the CUDA graph
    of the batch's shapes (`step.program`): every replica's forward and
    backward into .grad, the missing gradients filled, the division by the
    batch, the optimizer and the metrics; the first step of a shape runs
    eagerly, as the warm-up, and captures it.  Its metrics are the graph's
    own tensors, which the next step overwrites."""
    from geobignn_tpu_torch.pool.dynamic import fill_missing_grads

    cfg = loss_cfg or {}
    rows = replica_rows(mesh)
    procs = _group_size()
    first = dist.get_rank() * len(rows) if procs > 1 else 0
    n_rep = len(rows) * procs

    def body(blocks: list, rots) -> dict:
        b_local = batch_size_of(blocks[0])
        b = b_local * n_rep
        named = dict(model.named_parameters())
        home = next(iter(named.values())).device
        optimizer.zero_grad(set_to_none=True)
        sums: dict = {}
        for r, (row, block) in enumerate(zip(rows, blocks)):
            dev = row[0]
            local = {k: v.to(dev) for k, v in named.items()}
            for i in range(b_local):
                sample = sample_at(block, i)
                if rots is not None:
                    sample = aug.rotate_sample(sample, rots[r * b_local + i])
                loss, m = dual_loss_and_metrics(model, local, sample, cfg,
                                                row if gp_shard else None)
                loss.backward()
                for k, v in m.items():
                    sums[k] = sums.get(k, 0) + v.detach().to(home)
        fill_missing_grads(model)
        keys = sorted(sums)
        if procs > 1:  # one all-reduce of every gradient and metric sum
            grads = [prm.grad for prm in named.values()]
            flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack([sums[k] for k in keys])])
            dist.all_reduce(flat)
            for g, part in zip(grads, flat.split([g.numel() for g in grads] + [len(keys)])):
                g.copy_(part.view_as(g))
            sums = dict(zip(keys, flat[-len(keys):]))
        for prm in named.values():
            prm.grad.div_(float(b))
        optimizer.step()
        return {k: sums[k] / b for k in keys}

    # the gradients a capture leaves point into the graph's memory; outside
    # it the parameters hold none (each step writes them anew)
    program = capture.Program(body, settle=lambda: optimizer.zero_grad(set_to_none=True))
    devices = [d for row in rows for d in row]

    def step(batch: DualSample, seed: int = 0) -> dict:
        b = batch_size_of(batch)
        if b % n_rep:
            raise ValueError(f"batch {b} is not divisible by the {n_rep} replicas")
        b_local = b // n_rep
        blocks = [sample_at(batch, slice((first + r) * b_local, (first + r + 1) * b_local))
                  .to(row[0]) for r, row in enumerate(rows)]
        rots = None
        if augment:
            rots = [aug.random_rotation_matrix(torch.Generator(device=row[0]).manual_seed(
                _rotation_seed(seed, first + r, i)))
                for r, row in enumerate(rows) for i in range(b_local)]
        if capture.one_card(devices) and capture.capturable(optimizer):
            return program(blocks, rots)
        return body(blocks, rots)

    step.program = program
    return step
