"""The plain DualGNN: forward, L1 losses, eval sums, backward and Adam.

Written from the model's equations (GeoBi-GNN, code/network.py:254-300
and code/train_dual.py, as the port documents them), over unpadded COO
edge lists in plain torch: gathers, matmuls and `index_add_`.  No kernel,
band, table, padding, CUDA graph or rematerialization; float32 with TF32
off, at the operand precision the configuration states (`Precision`).

A conv's head softmax is formed from its per-node halves,

    p_h(j) = exp(u_h . x_j - s_j),   r_h(i) = exp(c_h - u_h . x_i - t_i),
    D(i,j) = sum_h r_h(i) p_h(j),    q_h(i,j) = r_h(i) p_h(j) / D(i,j)

(s, t a node's shift: the maximum over the heads, or the middle of the
span where any node's span passes WIDE_SPAN), and the aggregate rounds
its operands where the configuration states them in bf16: 1 / D, p x (or
p times the product of x and W), the sum times r and W, with float32
sums between them:

    out_i = ( sum_j sum_h q_h(i,j) W_h x_j + sum_h softmax(c)_h W_h x_i )
            / (deg_i + 1) + b

The fc heads run in bf16 where `fc_precision` says so: inputs, kernels,
bias and the hidden layer in it, products summed in float32.  Rounding
passes gradients straight through.

Each branch is a U-Net of 8 such convs over three levels with max pooling
through the host-built cluster maps and copy-back unpooling with skip
concatenation; LeakyReLU 0.2.  The vertex branch regresses position
offsets; the facet branch reads the face centroids and normals of the
denoised vertices and regresses unit normals.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

SLOPE = 0.2
EPS_NORMALIZE = 1e-12


@contextlib.contextmanager
def exact_matmuls():
    """float32 matmuls without TF32, restored afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def conv_schedule(widths: dict):
    """(name, level, C_in or None for the branch input, C_out) of a branch."""
    return [(c[0], c[1], c[2], c[3]) for c in widths["convs"]]


def param_shapes(widths: dict) -> dict:
    """{parameter name: shape} of the model, named as the port names them."""
    h = widths["heads"]
    out = {}
    for branch, c0 in (("gnn_v", widths["in_v"]), ("gnn_f", widths["in_f"])):
        for name, _, ci, co in conv_schedule(widths):
            ci = c0 if ci is None else ci
            out[f"{branch}.{name}.u"] = (ci, h)
            out[f"{branch}.{name}.c"] = (h,)
            out[f"{branch}.{name}.w"] = (h, ci, co)
            out[f"{branch}.{name}.b"] = (co,)
    hid, last = widths["fc_hidden"], widths["convs"][-1][3]
    for head in ("v", "f"):
        out[f"fc_{head}1.kernel"] = (last, hid)
        out[f"fc_{head}1.bias"] = (hid,)
        out[f"fc_{head}2.kernel"] = (hid, 3)
        out[f"fc_{head}2.bias"] = (3,)
    return out


def _act(x):
    return F.leaky_relu(x, SLOPE)


def _normalize(x):
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=EPS_NORMALIZE ** 2))


class Graph:
    """One level's edges (dst, src) and real in-degrees, on a device."""

    def __init__(self, edge_index, n, device):
        ei = torch.as_tensor(edge_index, dtype=torch.int64, device=device)
        self.row, self.col = ei[0], ei[1]
        self.deg = torch.zeros(n, device=device).index_add_(
            0, self.row, torch.ones(self.row.shape[0], device=device))
        self.n = n


WIDE_SPAN = 20.0  # a node's span of u.x over the heads past which shifts are centred


@dataclasses.dataclass(frozen=True)
class Precision:
    """The dtypes the configuration states: the aggregates' operands and
    the fc heads' (None: float32 throughout)."""
    operands: torch.dtype | None = None
    heads: torch.dtype | None = None


def precision_of(conf: dict) -> Precision:
    """The Precision of a configuration file; its activations must be float32."""
    c = conf["config"]
    if c.get("precision", "float32") != "float32":
        raise ValueError("the reference runs float32 activations only")
    ops = conf.get("aggregate_operands", "float32")
    return Precision(None if ops == "float32" else getattr(torch, ops),
                     None if c.get("fc_precision") in (None, "float32")
                     else getattr(torch, c["fc_precision"]))


def cd(t, dtype):
    """t rounded to `dtype` and back, its gradient passed straight through;
    t itself without a dtype."""
    if dtype is None:
        return t
    return t + (t.to(dtype).to(t.dtype) - t).detach()


def halves(x, u, c):
    """The per-node halves p, r (N, H) of the head softmax."""
    a = x @ u
    ca = c - a
    hi, lo = a.amax(dim=1, keepdim=True), a.amin(dim=1, keepdim=True)
    if bool(((hi - lo) > WIDE_SPAN).any()):
        s, t = (hi + lo) / 2, -(hi + lo) / 2
    else:
        s, t = hi, ca.amax(dim=1, keepdim=True)
    return torch.exp(a - s.detach()), torch.exp(ca - t.detach())


def feast_conv(p: dict, x, g: Graph, operands=None):
    u, c, w, b = p["u"], p["c"], p["w"], p["b"]
    heads, c_in, c_out = w.shape
    n = x.shape[0]
    pj, ri = halves(x, u, c)
    d = (ri[g.row] * pj[g.col]).sum(dim=1)
    a = cd(1.0 / torch.clamp(d, min=1e-12), operands)[:, None]  # (E, 1)
    if c_out < c_in:  # transform first: H*C_out columns
        y = cd(x, operands) @ cd(w.permute(1, 0, 2).reshape(c_in, heads * c_out), operands)
        v = cd(y * pj.repeat_interleave(c_out, dim=1), operands)
        z = x.new_zeros((n, heads * c_out)).index_add_(0, g.row, a * v[g.col])
        zr = cd(z * ri.repeat_interleave(c_out, dim=1), operands)
        num = zr.reshape(n, heads, c_out).sum(dim=1)
    else:  # aggregate first: H*C_in columns
        v = cd((pj[:, :, None] * x[:, None, :]).reshape(n, heads * c_in), operands)
        z = x.new_zeros((n, heads * c_in)).index_add_(0, g.row, a * v[g.col])
        zr = cd(z * ri.repeat_interleave(c_in, dim=1), operands)
        num = zr @ cd(w.reshape(heads * c_in, c_out), operands)
    w_self = torch.einsum("h,hco->co", torch.softmax(c, dim=0), w)
    return (num + x @ w_self) / (g.deg + 1.0)[:, None] + b


def max_pool(x, cluster, n_out):
    out = x.new_zeros((n_out, x.shape[1]))
    idx = cluster[:, None].expand(-1, x.shape[1])
    return out.scatter_reduce(0, idx, x, reduce="amax", include_self=False)


class Branch:
    """A branch's graphs and maps on the device, from a host.Branch."""

    def __init__(self, hb, device):
        t = lambda a: torch.as_tensor(a, device=device)
        self.x = t(hb.x).float()
        self.y = t(hb.y).float()
        l1, l2 = hb.levels
        self.graphs = (Graph(hb.edge_index, hb.n, device),
                       Graph(l1.edge_index, l1.n_out, device),
                       Graph(l2.edge_index, l2.n_out, device))
        self.pools = tuple([(t(c), s) for c, s in zip(lv.step_clusters, lv.step_sizes)]
                           for lv in (l1, l2))
        self.unpool = (t(l1.unpool), t(l2.unpool))


class Sample:
    def __init__(self, hs, device):
        self.v = Branch(hs.v, device)
        self.f = Branch(hs.f, device)
        self.fv = torch.as_tensor(hs.fv, dtype=torch.int64, device=device)


def gnn(params: dict, prefix: str, br: Branch, x, widths, operands=None):
    def conv(name, h, lvl):
        p = {k: params[f"{prefix}.{name}.{k}"] for k in "ucwb"}
        return feast_conv(p, h, br.graphs[lvl], operands)

    def pool(h, k):
        for cluster, n_out in br.pools[k]:
            h = max_pool(h, cluster, n_out)
        return h

    x1 = _act(conv("l_conv1", x, 0))
    x2 = _act(conv("l_conv2", pool(x1, 0), 1))
    x3 = _act(conv("l_conv3", pool(x2, 1), 2))
    x3 = _act(conv("l_conv4", x3, 2))
    u2 = conv("r_conv1", x3[br.unpool[1]], 1)
    x2 = _act(conv("r_conv2", torch.cat([x2, u2], dim=1), 1))
    u1 = conv("r_conv3", x2[br.unpool[0]], 0)
    return _act(conv("r_conv4", torch.cat([x1, u1], dim=1), 0))


def _head(params, name, feat, dtype=None):
    """fc2(act(fc1(feat))) in `dtype` (inputs, kernels, bias and hidden
    layer), the output in float32."""
    dt = dtype or feat.dtype
    lin = lambda t, k: t.to(dt) @ params[f"fc_{name}{k}.kernel"].to(dt) \
        + params[f"fc_{name}{k}.bias"].to(dt)
    return lin(_act(lin(feat, 1)), 2).float()


def forward(params: dict, s: Sample, widths: dict, rot=None, prec: Precision = Precision()):
    """(vertex positions, unit face normals, vertex targets, normal targets,
    the vertex head's offsets), the inputs and targets turned by `rot`
    (3, 3) first where given."""
    def turn(a):
        return a if rot is None else a @ rot

    xv = torch.cat([turn(s.v.x[:, :3]), turn(s.v.x[:, 3:6])], dim=1)
    xf0 = torch.cat([turn(s.f.x[:, :3]), turn(s.f.x[:, 3:6])], dim=1)
    yv, yf = turn(s.v.y), turn(s.f.y)
    offset = _head(params, "v", gnn(params, "gnn_v", s.v, xv, widths, prec.operands),
                   prec.heads)
    vert = offset + xv[:, :3]
    corners = vert[s.fv]  # (F, 3, 3)
    cent = corners.mean(dim=1)
    nrm = _normalize(torch.linalg.cross(corners[:, 1] - corners[:, 0],
                                        corners[:, 2] - corners[:, 0], dim=-1))
    xf = torch.cat([xf0, cent, nrm], dim=1)
    normals = _normalize(_head(params, "f", gnn(params, "gnn_f", s.f, xf, widths,
                                                prec.operands), prec.heads))
    return vert, normals, yv, yf, offset


def metrics(vert, normals, yv, yf) -> dict:
    """The L1 losses and the errors, each a mean over the real nodes."""
    dn = ((normals - yf) ** 2).sum(dim=1)
    ang = torch.arccos(torch.clamp(1.0 - dn / 2.0, -1.0, 1.0)) * (180.0 / math.pi)
    return dict(loss_v=(vert - yv).abs().sum(dim=1).mean(),
                loss_f=(normals - yf).abs().sum(dim=1).mean(),
                error_v=torch.sqrt(((vert - yv) ** 2).sum(dim=1)).mean(),
                error_f=ang.mean(), n_v=vert.shape[0], n_f=normals.shape[0])


def random_rotation(generator: torch.Generator) -> torch.Tensor:
    """Rz @ Ry @ Rx from three uniform angles in [0, 2 pi) drawn from the
    generator (the reference's RandomRotate parameterisation)."""
    a = torch.rand(3, generator=generator, device=generator.device) * (2.0 * math.pi)
    ca, sa = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a[0]), torch.zeros_like(a[0])
    rx = torch.stack([torch.stack([one, zero, zero]),
                      torch.stack([zero, ca[0], -sa[0]]),
                      torch.stack([zero, sa[0], ca[0]])])
    ry = torch.stack([torch.stack([ca[1], zero, sa[1]]),
                      torch.stack([zero, one, zero]),
                      torch.stack([-sa[1], zero, ca[1]])])
    rz = torch.stack([torch.stack([ca[2], -sa[2], zero]),
                      torch.stack([sa[2], ca[2], zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


class Adam:
    """Adam (torch's formula), float32 moments, constant learning rate."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def train_steps(weights: dict, samples, rot_seeds, widths: dict, lr: float,
                device, prec: Precision = Precision()):
    """The reference's first steps from `weights` (copied), one sample and
    one rotation seed a step: (each step's loss, the first step's gradient
    by leaf, the parameters after the last step by leaf, the first
    forward's positions, normals and vertex offsets)."""
    params = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
              for k, v in weights.items()}
    opt = Adam(params, lr)
    losses, first_grads, first_out = [], None, None
    with exact_matmuls():
        for hs, seed in zip(samples, rot_seeds):
            s = Sample(hs, device)
            gen = torch.Generator(device=device).manual_seed(seed)
            rot = random_rotation(gen)
            out = forward(params, s, widths, rot, prec)
            if first_out is None:
                first_out = (out[0].detach().float(), out[1].detach().float(),
                             out[4].detach().float())
            m = metrics(*out[:4])
            loss = m["loss_v"] + m["loss_f"]
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if first_grads is None:
                first_grads = {k: g.detach().float().clone() for k, g in grads.items()}
            opt.step(grads)
            losses.append(float(loss.detach()))
            del s, m, loss, grads, out
    return (losses, first_grads, {k: v.detach().float() for k, v in params.items()},
            first_out)


@torch.no_grad()
def eval_means(weights: dict, samples, widths: dict, device, prec: Precision = Precision()):
    """(node-weighted means of the losses and errors over `samples`, as the
    eval pass reports them (no rotation); the first sample's positions,
    normals and vertex offsets)."""
    params = {k: v.detach().to(device, torch.float32) for k, v in weights.items()}
    sums = dict(loss_v=0.0, loss_f=0.0, error_v=0.0, error_f=0.0, n_v=0, n_f=0)
    first_out = None
    with exact_matmuls():
        for hs in samples:
            out = forward(params, Sample(hs, device), widths, None, prec)
            if first_out is None:
                first_out = (out[0].float(), out[1].float(), out[4].float())
            m = metrics(*out[:4])
            for k, n in (("loss_v", "n_v"), ("error_v", "n_v"),
                         ("loss_f", "n_f"), ("error_f", "n_f")):
                sums[k] += float(m[k]) * m[n]
            sums["n_v"] += m["n_v"]
            sums["n_f"] += m["n_f"]
    means = {k: sums[k] / sums["n_" + k[-1]] for k in ("loss_v", "loss_f", "error_v", "error_f")}
    return means, first_out
