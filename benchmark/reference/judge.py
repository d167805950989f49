"""The comparisons that decide `correct`, and the numbers they print.

Each number is compared with its limit from `limits/<cell>.json`; a run
is correct when every number is at or under its limit.  The numbers:

  host_mismatch  host-built arrays of the judged samples (RCM orders,
                 faces, inputs, targets, edge lists, edge weights, cluster
                 maps) that differ from the plain host build; exact, limit 0.
  passes_off     epochs or eval passes of the run that did not take every
                 sample exactly once (an epoch: each under a rotation seed
                 of its own); exact, limit 0.
  first_loss_gap training: the relative gap of the first step's loss.
  loss_gap       training: the largest relative gap of a step's loss over
                 the first three steps.
  grad_gap       training: the first step's gradient as Adam got it, the
                 worst leaf's gap of norms over the larger of that leaf's
                 reference norm and the median leaf's.
  change_gap     training: the change of the parameters over the three
                 steps, measured as grad_gap, over the leaves whose first
                 reference gradient is at least a thousandth of the median
                 leaf's (the others move by round-off under Adam).
  eval_gap       eval: the largest relative gap of the four node-weighted
                 means (L1 losses, position and angle errors) over every
                 pass of the window.
  pos_gap        the first forward (training: step 1's, which run_epoch
                 dispatches; eval: the first sample's), node by node: the 90th percentile of the
                 position gap over the RMS of the reference's offsets.
  normal_gap     the same forward: the 90th percentile of the unit
                 normals' gap.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF_FLOOR = 1e-3  # of the median leaf's first reference gradient


def reference_structures(hs) -> dict:
    """The arrays of a host.Sample under the names the harness gives the
    program's."""
    out = {"fv": hs.fv}
    if hs.perm_v is not None:
        out["perm_v"], out["perm_f"] = hs.perm_v, hs.perm_f
    for b, br in (("v", hs.v), ("f", hs.f)):
        out[f"{b}.x"], out[f"{b}.y"] = br.x, br.y
        out[f"{b}.edge_index"], out[f"{b}.edge_weight"] = br.edge_index, br.edge_weight
        for i, lv in enumerate(br.levels):
            for k, c in enumerate(lv.step_clusters):
                out[f"{b}.s{i}.cluster{k}"] = c
            out[f"{b}.s{i}.unpool"] = lv.unpool
            out[f"{b}.s{i}.edge_index"] = lv.edge_index
            out[f"{b}.s{i}.edge_weight"] = lv.edge_weight
    return out


def host_mismatch(program: dict, reference: dict) -> tuple[int, list]:
    """(arrays that differ or are missing, their names)."""
    bad = []
    for k in sorted(set(program) | set(reference)):
        a, b = program.get(k), reference.get(k)
        if a is None or b is None or np.shape(a) != np.shape(b) or not np.array_equal(
                np.asarray(a), np.asarray(b)):
            bad.append(k)
    return len(bad), bad


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in d.items()}


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> list:
    """|‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖) of each leaf."""
    leaves = list(ref) if leaves is None else list(leaves)
    med = float(np.median([ref[k] for k in ref]))
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def worst_leaf_gap(prog: dict, ref: dict, leaves=None) -> float:
    gaps = leaf_gaps(prog, ref, leaves)
    return max(gaps) if gaps else float("nan")


def train_numbers(prog_losses, prog_grad_norms: dict, prog_change_norms: dict,
                  ref_losses, ref_first_grads: dict, weights0: dict, ref_params: dict) -> dict:
    """loss_gap, grad_gap and change_gap of the program's first three steps
    against the reference's (norms by leaf; the reference's as tensors)."""
    g_ref = norms(ref_first_grads)
    d_ref = norms({k: ref_params[k] - weights0[k].float().to(ref_params[k].device)
                    for k in ref_params})
    med_g = float(np.median(list(g_ref.values())))
    moved = [k for k in g_ref if g_ref[k] >= LEAF_FLOOR * med_g]
    steps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses)]
    gg = leaf_gaps(prog_grad_norms, g_ref)
    cg = leaf_gaps(prog_change_norms, {k: d_ref[k] for k in g_ref}, moved)
    return dict(first_loss_gap=steps[0], loss_gap=max(steps),
                grad_gap=max(gg), grad_gap_median=float(np.median(gg)),
                change_gap=max(cg) if cg else float("nan"),
                change_gap_median=float(np.median(cg)) if cg else float("nan"),
                leaves_left_out=len(g_ref) - len(moved))


def forward_numbers(prog, ref) -> dict:
    """pos_gap and normal_gap of one forward: the 90th percentile over the
    real vertices of the program's distance from the reference's positions,
    over the RMS of the reference's vertex offsets; the 90th percentile over
    the real faces of the distance between the unit normals.  `prog` and
    `ref`: (positions, normals, offsets or None), the program's padded."""
    pv, pn = prog[0], prog[1]
    rv, rn, roff = ref
    pv = pv[: rv.shape[0]].to(rv.device)
    pn = pn[: rn.shape[0]].to(rn.device)
    dv = torch.linalg.vector_norm(pv - rv, dim=1)
    dn = torch.linalg.vector_norm(pn - rn, dim=1)
    scale = torch.sqrt((roff ** 2).sum(dim=1).mean()).clamp(min=1e-30)
    return dict(pos_gap=float(torch.quantile(dv, 0.9) / scale),
                normal_gap=float(torch.quantile(dn, 0.9)))


def eval_numbers(answers: list, ref: dict) -> dict:
    """eval_gap over every pass's answer (a dict of the four means)."""
    per = {k: max(abs(a[k] - r) / max(abs(r), 1e-30) for a in answers)
           for k, r in ref.items()}
    out = {f"eval_gap.{k}": v for k, v in per.items()}
    return dict(out, eval_gap=max(per.values()), passes_judged=len(answers))


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number at or under its limit, {name: [number, limit]})."""
    shown = {k: [numbers[k], limits[k]] for k in limits}
    ok = all(np.isfinite(v) and v <= lim for v, lim in shown.values())
    return ok, shown
