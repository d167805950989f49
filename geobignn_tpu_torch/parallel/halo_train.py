"""Halo-sharded training: gradients and the optimizer over the
node-partitioned dual model (parallel/halo_model.py).

Counterpart of geobignn_tpu/parallel/halo_train.py.  One mesh too large for
one device is node-partitioned over P parts; every conv exchanges only its
boundary rows.  The JAX step is one `shard_map` program per device whose
gradients come out of the transpose psummed; here one process drives the P
parts (parallel/partition.py), each part computes with a copy of the
parameters on its device, and autograd sums every part's gradient into the
one parameter set, which one optimizer step then updates.  Each part's work
is queued on its own device.  Where every part lives on one card, the step
and the forward are each one CUDA graph per sample's shapes (capture.py),
the JAX `jit`; parts on several cards run eagerly (capture.one_card).

Host half: `build_halo_train_sample` takes a raw mesh pair to a sample
whose `arrays` are P per-part tensor dicts (`HaloTrainSample.to` moves each
to its part's device) beside the host structure (`structure`, the
HaloDual, bit-equal to JAX's) and the static exchange schedule (`static`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from geobignn_tpu_torch import capture
from geobignn_tpu_torch.data.augment import random_rotation_matrix
from geobignn_tpu_torch.models import losses
from geobignn_tpu_torch.parallel import halo_model as hm
from geobignn_tpu_torch.parallel import partition as hp


@dataclasses.dataclass
class HaloTrainSample:
    """Host-built halo-sharded sample.  `arrays` is a list of P dicts,
    {d, xv, xf, mv, mf[, yv, yf, dd]}: part p's slice of every array, as
    tensors on its device; `structure` the HaloDual kept for unsharding."""

    arrays: list
    structure: hm.HaloDual
    n_v: int
    n_f: int
    meta: dict
    static: dict | None = None  # dual_static(hd): per-level exchange rounds

    def to(self, devices: list) -> "HaloTrainSample":
        """The sample with part p's arrays on devices[p]."""
        if len(devices) != len(self.arrays):
            raise ValueError(f"{len(self.arrays)} parts, {len(devices)} devices")

        def moved(tree, dev):
            if isinstance(tree, dict):
                return {k: moved(v, dev) for k, v in tree.items()}
            return tree.to(dev)

        return dataclasses.replace(
            self, arrays=[moved(a, dev) for a, dev in zip(self.arrays, devices)])

    @property
    def devices(self) -> list:
        return [a["xv"].device for a in self.arrays]


def build_halo_train_sample(
    mesh_noisy, mesh_orig, build_cfg, n_parts: int, seed: int = 0,
    granularity: int = 8, banded: bool = False, devices: list | None = None,
) -> HaloTrainSample:
    """Raw mesh pair -> halo-sharded sample: the node partition,
    owner-constrained pooling hierarchies, the halo structures and the
    sharded features, targets and masks, on `devices` (default the CPU).
    `banded=True` RCM-orders each part's slots and routes the level-1 convs
    through the banded aggregate."""
    from geobignn_tpu_torch.data.builder import build_raw
    from geobignn_tpu_torch.data.dataset import branch_messages
    from geobignn_tpu_torch.pool.hierarchy import build_hierarchy

    bv, bf, meta = build_raw(mesh_noisy, mesh_orig, build_cfg)
    n_v, n_f = bv.n_nodes, bf.n_nodes
    owner_v = hp.partition_nodes(bv.edge_index, n_v, n_parts, seed=seed)
    owner_f = owner_v[meta["fv_indices"][:, 0]].astype(np.int32)
    bv.specs = build_hierarchy(bv.edge_index, bv.edge_weight, bv.x, n_v, owner=owner_v,
                               weight_type=build_cfg.weight_type)
    bf.specs = build_hierarchy(bf.edge_index, bf.edge_weight, bf.x, n_f, owner=owner_f,
                               weight_type=build_cfg.weight_type)
    hd = hm.build_halo_dual(
        bv.edge_index, bv.edge_weight, n_v, bv.specs, owner_v,
        bf.edge_index, bf.edge_weight, meta["fv_indices"], bf.specs,
        granularity=granularity, banded=banded,
    )
    meta["messages"] = branch_messages(bv) + branch_messages(bf)
    sh_v, sh_f = hd.v.levels[0], hd.f.levels[0]
    stacked = dict(
        d=hm.dual_device_arrays(hd),
        xv=hp.shard_features(bv.x, sh_v),
        xf=hp.shard_features(bf.x, sh_f),
        mv=sh_v.node_mask,
        mf=sh_f.node_mask,
    )
    if bv.depth_direction is not None:  # Kinect force_depth ray per vertex
        stacked["dd"] = hp.shard_features(bv.depth_direction, sh_v)
    if bv.y is not None:  # inference builds have no targets
        stacked["yv"] = hp.shard_features(bv.y, sh_v)
        stacked["yf"] = hp.shard_features(bf.y, sh_f)
    devices = devices or [torch.device("cpu")] * n_parts
    arrays = [hm.part_tensors(stacked, p, dev) for p, dev in enumerate(devices)]
    return HaloTrainSample(arrays=arrays, structure=hd, n_v=n_v, n_f=n_f, meta=meta,
                           static=hm.dual_static(hd))


# --------------------------------------------------------------------------
# device half
# --------------------------------------------------------------------------

def _rotate_blocks(x, rot):
    """Rotate every 3-wide block of a (..., 3k) feature array."""
    return torch.cat([x[..., i : i + 3] @ rot for i in range(0, x.shape[-1], 3)], dim=-1)


def _gathered(parts: list, device):
    """The parts' rows concatenated on one device (the all_gather)."""
    return torch.cat([t.to(device) for t in parts], dim=0)


def _cd_halo(vert_ps: list, yvs: list, mvs: list):
    """Chamfer loss over the WHOLE partitioned point set: the parts'
    positions gathered on the first part's device and one masked chamfer
    there.  The JAX function returns psum(cd / P) of P identical replicas;
    value and gradient are this one chamfer's."""
    dev = vert_ps[0].device
    m_all = _gathered(mvs, dev)
    return losses.chamfer_distance(_gathered(vert_ps, dev), _gathered(yvs, dev), m_all, m_all)


def _sided_halo(vert_ps: list, yvs: list, norm_ps: list, yfs: list, mfs: list,
                arrays: list, sd: dict):
    """Sided normal loss over halo parts: each LOCAL predicted face is
    matched (by centroid) to the nearest GLOBAL ground-truth face; targets
    are gathered, predictions stay local, partial sums are summed.  The
    centroids come from the model's corner exchange, without gradient (the
    argmin match passes none in the reference either)."""
    ds = [a["d"] for a in arrays]
    sends, fvs = [d["send_fv"] for d in ds], [d["fv"] for d in ds]
    ext_p = hp.halo_exchange([v.detach() for v in vert_ps], sends, sd["fv_rounds"])
    ext_y = hp.halo_exchange(yvs, sends, sd["fv_rounds"])
    fc_gt = [e[fv].mean(dim=1) for e, fv in zip(ext_y, fvs)]
    s = 0
    for ep, fv, norm_p, mf in zip(ext_p, fvs, norm_ps, mfs):
        dev = norm_p.device
        n_all, m_all = _gathered(yfs, dev), _gathered(mfs, dev)
        idx = losses.nearest_index(ep[fv].mean(dim=1), _gathered(fc_gt, dev), m_all)
        per = (norm_p - n_all[idx]).abs().sum(dim=1)
        s = s + torch.stack([(per * mf).sum(), mf.sum()]).to(vert_ps[0].device)
    return s[0] / s[1]


def _halo_loss(params: dict, arrays: list, sd: dict, pool_type: str, cfg: dict,
               rot=None, compute_dtype=None):
    """The loss with globally summed denominators: the single-device masked
    dual loss of the unpartitioned graph.  loss_v: L1 | L2 | CD (chamfer);
    loss_n: L1 | L2 | sided.  `rot` (3, 3), shared by every part, rotates
    features and targets.  Returns (loss, the metrics' global sums stacked),
    on the first part's device."""
    xv, xf, yv, yf = ([a[k] for a in arrays] for k in ("xv", "xf", "yv", "yf"))
    dd = [a["dd"] for a in arrays] if "dd" in arrays[0] else None
    if rot is not None:  # one rotation, copied to each part's device
        rots = [rot.to(x.device) for x in xv]
        xv = [_rotate_blocks(x, r) for x, r in zip(xv, rots)]
        xf = [_rotate_blocks(x, r) for x, r in zip(xf, rots)]
        yv = [y @ r for y, r in zip(yv, rots)]
        yf = [y @ r for y, r in zip(yf, rots)]
        if dd is not None:
            dd = [t @ r for t, r in zip(dd, rots)]
    vert_p, norm_p = hm.halo_dual_gnn(params, xv, xf, [a["d"] for a in arrays], sd,
                                      pool_type, dd, compute_dtype)
    mv, mf = [a["mv"] for a in arrays], [a["mf"] for a in arrays]
    home = vert_p[0].device

    kv, kn = cfg.get("loss_v", "L1"), cfg.get("loss_n", "L1")
    base = 0
    for vp, np_, y_v, y_f, m_v, m_f in zip(vert_p, norm_p, yv, yf, mv, mf):
        dv, dn = vp - y_v, np_ - y_f
        sv = dv.abs().sum(1) if kv == "L1" else (dv ** 2).sum(1)
        sn = dn.abs().sum(1) if kn == "L1" else (dn ** 2).sum(1)
        # metrics only, without gradient: sqrt' at 0 and arccos' at +-1 on
        # trash slots would put 0 * inf into the gradient
        with torch.no_grad():
            ev = torch.sqrt((dv ** 2).sum(dim=1))
            en_val = torch.clamp(1.0 - (dn ** 2).sum(dim=1) / 2.0, -1.0, 1.0)
            en = torch.arccos(en_val) * (180.0 / np.pi)
        base = base + torch.stack([
            (sv * m_v).sum(), (sn * m_f).sum(), (ev * m_v).sum(), (en * m_f).sum(),
            m_v.sum(), m_f.sum()]).to(home)
    loss_v = _cd_halo(vert_p, yv, mv) if kv == "CD" else base[0] / base[4]
    loss_n = (_sided_halo(vert_p, yv, norm_p, yf, mf, arrays, sd) if kn == "sided"
              else base[1] / base[5])
    loss = loss_v * cfg.get("loss_v_scale", 1.0) + loss_n * cfg.get("loss_n_scale", 1.0)
    # the metric sums carry the loss components actually optimized,
    # node-weighted, whatever the loss family
    sums = torch.stack([loss_v.detach() * base[4], loss_n.detach() * base[5],
                        base[2], base[3], base[4], base[5]]).detach()
    return loss, sums


def _static_required(static_d, what: str) -> dict:
    """An empty schedule would skip every exchange in silence: refuse it."""
    if static_d is None:
        raise ValueError(f"{what} needs static_d (= sample.static / halo_model.dual_static)")
    return static_d


def _part_devices(arrays: list) -> list:
    return [a["xv"].device for a in arrays]


def make_halo_train_step(model, optimizer, static_d: dict | None = None,
                         loss_cfg: dict | None = None, pool_type: str = "max",
                         augment: bool = False, n_steps: int = 1, compute_dtype=None):
    """The training step over halo parts: step(arrays, seed) -> metrics.

    `model` holds the parameters (a DualGNN; its module tree is the JAX
    parameter tree) and `optimizer` updates them.  `arrays` are the
    sample's per-part dicts on their devices.  `n_steps > 1` chains that
    many optimizer steps on the same sample, as the JAX scan does; with
    `augment` each chained step takes a rotation, shared by the parts,
    drawn before the step from a torch.Generator seeded with `seed` on the
    first part's device.  The metrics are the last step's, as tensors
    there.

    Where every part is on one card and the optimizer is capturable (Adam
    on the card), a step is one replay of the CUDA graph of the sample's
    shapes (`step.program`): forward, backward into .grad, the optimizer
    and the metrics, with the rotations copied in; the first step of a
    shape runs eagerly, as the warm-up, and captures it.  Its metrics are
    the graph's own tensors, which the next step overwrites."""
    from geobignn_tpu_torch.params import tree_of

    cfg = loss_cfg or {}
    sd = _static_required(static_d, "make_halo_train_step")

    def body(arrays: list, rots) -> dict:
        for i in range(n_steps):
            optimizer.zero_grad(set_to_none=True)
            loss, s = _halo_loss(tree_of(model), arrays, sd, pool_type, cfg,
                                 None if rots is None else rots[i], compute_dtype)
            loss.backward()
            optimizer.step()
        metrics = dict(loss_v=s[0] / s[4], loss_f=s[1] / s[5], error_v=s[2] / s[4],
                       error_f=s[3] / s[5], n_v=s[4], n_f=s[5])
        metrics["loss"] = (metrics["loss_v"] * cfg.get("loss_v_scale", 1.0)
                           + metrics["loss_f"] * cfg.get("loss_n_scale", 1.0))
        return metrics

    # the gradients a capture leaves point into the graph's memory; outside
    # it the parameters hold none (each step writes them anew)
    program = capture.Program(body, settle=lambda: optimizer.zero_grad(set_to_none=True))

    def step(arrays: list, seed: int = 0) -> dict:
        rots = None
        if augment:  # one (3, 3) rotation per chained step, the scan's chain
            gen = torch.Generator(device=arrays[0]["xv"].device).manual_seed(seed)
            rots = torch.stack([random_rotation_matrix(gen, cfg.get("z_only", False))
                                for _ in range(n_steps)])
        if capture.one_card(_part_devices(arrays)) and capture.capturable(optimizer):
            return program(arrays, rots)
        return body(arrays, rots)

    step.program = program
    return step


def make_halo_forward(model, static_d: dict | None = None, pool_type: str = "max",
                      compute_dtype=None):
    """The forward over halo parts without autograd: fwd(arrays) -> (each
    part's vert_p, each part's norm_p).  Unshard with `unshard_predictions`.
    Where every part is on one card, one replay of the CUDA graph of the
    sample's shapes (`fwd.program`; the first call of a shape runs eagerly
    and captures it), whose outputs the next call overwrites."""
    from geobignn_tpu_torch.params import tree_of

    sd = _static_required(static_d, "make_halo_forward")

    def body(arrays: list):
        return hm.halo_dual_gnn(
            tree_of(model), [a["xv"] for a in arrays], [a["xf"] for a in arrays],
            [a["d"] for a in arrays], sd, pool_type,
            [a["dd"] for a in arrays] if "dd" in arrays[0] else None, compute_dtype)

    program = capture.Program(body)

    @torch.no_grad()
    def fwd(arrays: list):
        if capture.one_card(_part_devices(arrays)):
            return program(arrays)
        return body(arrays)

    fwd.program = program
    return fwd


def unshard_predictions(sample: HaloTrainSample, vert_loc: list, norm_loc: list):
    """Per-part predictions -> global (n_v, 3) positions, (n_f, 3) normals."""
    hd = sample.structure

    def host(parts):
        return np.stack([t.detach().cpu().numpy() for t in parts])

    return (hp.unshard_features(host(vert_loc), hd.v.levels[0], sample.n_v),
            hp.unshard_features(host(norm_loc), hd.f.levels[0], sample.n_f))
