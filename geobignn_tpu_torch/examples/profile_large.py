"""The whole-mesh training step broken into its components.

Counterpart of the JAX repo's examples/profile_large.py: on the whole
add_noise(icosphere(subdiv), 0.2, seed=0) mesh (327,680 faces at the
default subdiv 7; `--batch` copies in one union sample) it times the whole
step (graphed, Trainer.fused_step, and eager), the forward and loss, then
each part of the step alone, forward and backward: each branch's conv
stack at each level (the model's convs of the level, each on its own
input of ones, with respect to the parameters and the input), the pooling gathers (two
rounds, twice) and the unpooling gathers, the fc heads' first layer
(32 -> 1024 and its LeakyReLU, in the heads' dtype), the cross-domain
rebuild (corner gather, centroids, normals) and the loss; and the sum of
the parts against the whole step.  On the card each part is captured as
one CUDA graph after a warm-up and its replays are timed (CUDA events, the
median of `--steps`), as the graphed step runs; PyTorch drops no
computation whose result is unused, so no carry is needed to keep a part
alive (the JAX probe's `a + 1e-30 * b`).  On the CPU the host clock times
the same parts eagerly.

Run:  python -m geobignn_tpu_torch.examples.profile_large [--subdiv 7 --batch 1]
      (on the CPU at a small size: --device cpu --subdiv 2)
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from geobignn_tpu_torch.examples import _probe, _sample

BRANCH_WIDTH = {"v": 6, "f": 12}  # a branch input's channels


class Parts:
    """The step's model, trainer and sample on one device, and a timer that
    prints one row a part."""

    def __init__(self, subdiv: int, batch: int, device, steps: int, tag: str):
        from geobignn_tpu_torch.config import Config
        from geobignn_tpu_torch.train.trainer import Trainer

        self.cfg = Config(seed=0, granularity=256)
        self.host = _sample.whole_sample(subdiv, batch)
        self.dev, self.steps, self.tag = device, steps, tag
        self.tr = Trainer(self.cfg, _sample.stand_in(self.cfg), None, device=device)
        self.model = self.tr.model
        self.sample = self.host["sample"].to(device)
        self.rows: list = []

    def time(self, name: str, fn, graph: bool = True) -> float:
        """The median ms of fn: on the card one CUDA graph of it replayed
        (`graph`), or its eager calls."""
        t = _probe.timed(fn, self.dev, steps=self.steps, graph=graph)
        self.rows.append(_probe.row(self.tag, part=name, graphed=graph and self.dev.type == "cuda",
                                    **_probe.spread(t)))
        return t["median_ms"]

    # -- the whole step ---------------------------------------------------
    def whole(self) -> dict:
        from geobignn_tpu_torch.train.trainer import _metrics_of

        it = itertools.count()
        tr, smp = self.tr, self.sample
        out = {}
        if tr.one_dispatch():
            out["graphed"] = self.time("full step, graphed (fwd+bwd+adam)",
                                       lambda: tr.fused_step(smp, next(it)), graph=False)
        out["eager"] = self.time("full step, eager (fwd+bwd+adam)",
                                 lambda: tr._captured_step(smp, tr._rotation(next(it))),
                                 graph=False)

        def fwd():
            with torch.no_grad():
                _metrics_of(*self.model(smp), smp, self.cfg)

        out["fwd"] = self.time("forward + loss", fwd)
        return out

    def fwd_bwd(self) -> float:
        from geobignn_tpu_torch.train.trainer import _metrics_of

        def step():
            _metrics_of(*self.model(self.sample), self.sample, self.cfg)[0].backward()
            self.tr.optimizer.zero_grad(set_to_none=True)

        return self.time("forward + backward", step)

    def adam(self) -> float:
        opt = self.tr.optimizer
        for prm in self.model.parameters():
            prm.grad = torch.zeros_like(prm)
        ms = self.time("adam update only", opt.step)
        opt.zero_grad(set_to_none=True)
        return ms

    # -- the parts ----------------------------------------------------------
    def unet(self, side: str) -> float:
        """One branch's U-Net forward and backward (parameters and input)."""
        branch = getattr(self.sample, side)
        gnn = getattr(self.model, "gnn_" + side)
        x = torch.zeros((branch.levels[0].node_mask.shape[0], BRANCH_WIDTH[side]),
                        device=self.dev, requires_grad=True)

        def step():
            gnn(branch, x).sum().backward()
            gnn.zero_grad(set_to_none=True)

        return self.time(f"{side} U-Net fwd+bwd", step)

    def conv_stack(self, side: str, level: int) -> float:
        """The model's convs at one level of one branch (models/dual_gnn.
        CONV_SCHEDULE), each on its own input of ones."""
        from geobignn_tpu_torch.models.dual_gnn import CONV_SCHEDULE

        lvl = getattr(self.sample, side).levels[level]
        n = lvl.node_mask.shape[0]
        gnn = getattr(self.model, "gnn_" + side)
        convs = [getattr(gnn, name) for name, lv, _, _ in CONV_SCHEDULE if lv == level]
        convs = [(conv, torch.ones((n, conv.u.shape[0]), device=self.dev, requires_grad=True))
                 for conv in convs]

        def step():
            sum(conv(x, lvl).sum() for conv, x in convs).backward()
            for conv, x in convs:
                conv.zero_grad(set_to_none=True)
                x.grad = None

        return self.time(f"{side} L{level + 1} convs x{len(convs)} fwd+bwd", step)

    def pools(self, side: str) -> float:
        from geobignn_tpu_torch.models.dual_gnn import pool_features

        br = getattr(self.sample, side)
        x1 = torch.ones((br.levels[0].node_mask.shape[0], 32), device=self.dev,
                        requires_grad=True)

        def step():
            x2 = F.pad(pool_features(x1, br.steps[0:2]), (0, 32))  # 64 channels at L2
            x3 = pool_features(x2, br.steps[2:4])
            (x2.sum() + x3.sum()).backward()
            x1.grad = None

        return self.time(f"{side} pool x4 fwd+bwd", step)

    def unpools(self, side: str) -> float:
        from geobignn_tpu_torch.ops import table as tbl

        br = getattr(self.sample, side)
        x3 = torch.ones((br.levels[2].node_mask.shape[0], 128), device=self.dev,
                        requires_grad=True)

        def step():
            u2 = tbl.gather_unpool(x3, br.unpool2, br.unpool2_rev)
            u1 = tbl.gather_unpool(u2[:, :64], br.unpool1, br.unpool1_rev)
            (u1.sum() + u2.sum()).backward()
            x3.grad = None

        return self.time(f"{side} unpool x2 fwd+bwd", step)

    def fc(self, side: str) -> float:
        from geobignn_tpu_torch.models.dual_gnn import _act

        fc1 = getattr(self.model, f"fc_{side}1")
        x = torch.ones((getattr(self.sample, side).levels[0].node_mask.shape[0], 32),
                       device=self.dev)

        def step():
            _act(fc1(x)).float().sum().backward()
            fc1.zero_grad(set_to_none=True)

        return self.time(f"{side} fc 32->1024 fwd+bwd", step)

    def rebuild(self) -> float:
        from geobignn_tpu_torch import geometry
        from geobignn_tpu_torch.ops import table as tbl

        smp = self.sample
        vp = torch.ones((smp.v.levels[0].node_mask.shape[0], 3), device=self.dev,
                        requires_grad=True)

        def step():
            corners = tbl.table_gather(vp, smp.fv_indices, smp.fv_rev)
            nrm = geometry.safe_normalize(torch.linalg.cross(
                corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0], dim=-1))
            (corners.mean(dim=1).sum() + nrm.sum()).backward()
            vp.grad = None

        return self.time("cross-domain rebuild fwd+bwd", step)

    def loss(self) -> float:
        from geobignn_tpu_torch.train.trainer import _metrics_of

        smp = self.sample
        gen = torch.Generator(device=self.dev).manual_seed(0)
        vp, np_ = (torch.randn((getattr(smp, s).levels[0].node_mask.shape[0], 3),
                               device=self.dev, generator=gen).requires_grad_(True)
                   for s in ("v", "f"))

        def step():
            _metrics_of(vp, np_, smp, self.cfg)[0].backward()
            vp.grad = np_.grad = None

        return self.time("loss fwd+bwd", step)


def main(argv=None) -> dict:
    ap = _probe.parser(__doc__)
    ap.add_argument("--subdiv", type=int, default=7)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = _probe.device_of(args.device)
    parts = Parts(args.subdiv, args.batch, dev, args.steps, "profile-large")
    h = parts.host
    print(f"[profile-large] {_probe.card(dev)}; {args.batch} x {h['noisy'].n_faces} faces, "
          f"rows vertex {h['sample'].v.x.shape[0]}, facet {h['sample'].f.x.shape[0]}; host "
          f"build {h['host_s']:.2f} s; levels " + ", ".join(
              f"{s}L{i + 1} {_kind(lvl)}" for s in ("v", "f")
              for i, lvl in enumerate(getattr(h["sample"], s).levels)))
    whole = parts.whole()
    each = [parts.conv_stack(s, lv) for s in ("v", "f") for lv in range(3)]
    each += [f(s) for s in ("v", "f") for f in (parts.pools, parts.unpools, parts.fc)]
    each += [parts.rebuild(), parts.loss()]
    full = whole.get("graphed", whole["eager"])
    _probe.row("profile-large", part="sum of parts", ms=sum(each),
               of_step=sum(each) / full, step_ms=full,
               step="graphed" if "graphed" in whole else "eager")
    return dict(whole=whole, parts=parts.rows, sum_ms=sum(each))


def _kind(lvl) -> str:
    if lvl.blk_idx is not None:
        return f"block-sparse {tuple(lvl.band.shape)}"
    if lvl.band is not None:
        return f"banded {tuple(lvl.band.shape)}" + (
            f" + sub-band {tuple(lvl.jband.shape)}" if lvl.jband is not None else "")
    return "table" if lvl.nbr is not None else "coo"


if __name__ == "__main__":
    main()
