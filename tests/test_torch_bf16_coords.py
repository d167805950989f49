"""bf16 activations at whole-mesh coordinates.

With precision="bfloat16" the JAX model forms the factorized softmax's
logits a = x @ u in bf16, from u cast to bf16
(geobignn_tpu/models/dual_gnn.py).  At level 0 of a whole mesh, whose
positions in mean edge lengths run to hundreds, a runs to hundreds of |u|,
where one bf16 ulp of a (2-4) is an O(1) change of a head's weight.  The
port forms a in float32 from x's bf16 values and the float32 u
(ops/banded.factorized_softmax, models/dual_gnn.FeaStConv), and rounds p
and r to bf16 once.  That is a deviation from the JAX package, so it has a
witness: the port's bf16-vs-float32 distance is no larger than the JAX
package's own, on one conv here (test_bf16_conv_distance_witness) and on
the whole model's forward over a whole mesh under the same seeded weights
(`python tests/test_torch_bf16_coords.py <subdivisions>` prints both
packages' on add_noise(icosphere(subdivisions), 0.2, seed=0) whole, with
the JAX convs in Pallas interpret mode: about 80 s at icosphere(3)-(4);
chip_smoke.py --large holds the card's at icosphere(6) against the JAX
package's there).  `... conv` prints the conv's over a range of shifts.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import torch

from geobignn_tpu import native as jnative
from geobignn_tpu.config import Config as JConfig
from geobignn_tpu.data import batching as jbatching
from geobignn_tpu.data import builder as jbuilder
from geobignn_tpu import graphs as jgraphs
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.models import DualGNN as JDualGNN
from geobignn_tpu.ops import banded as jbanded
from geobignn_tpu.ops import banded_pallas
from geobignn_tpu.ops.feastconv import FeastParams
from geobignn_tpu_torch import geometry
from geobignn_tpu_torch import params as tparams
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import batching, builder, synth
from geobignn_tpu_torch.models.dual_gnn import DualGNN
from geobignn_tpu_torch.ops import banded as tbanded
from geobignn_tpu_torch.ops import banded_cuda
from geobignn_tpu_torch.structs import round_up

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

HEADS = 9


def _far_inputs(shift: float):
    """Level-0-like features of icosphere(3): positions in mean edge lengths
    moved `shift` of them along each axis, then the unit positions; u at the
    seeded model's scale (normal x 0.1), c seeded."""
    mesh = synth.icosphere(3)
    pts = mesh.points / np.linalg.norm(
        mesh.points[mesh.ev_indices[:, 0]] - mesh.points[mesh.ev_indices[:, 1]], axis=1).mean()
    x = np.concatenate([pts + shift, mesh.points], axis=1).astype(np.float32)
    rng = np.random.default_rng(3)
    u = (rng.normal(size=(6, HEADS)) * 0.1).astype(np.float32)
    c = (rng.normal(size=HEADS) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(c)


def test_factorized_softmax_bf16_at_far_coordinates():
    """factorized_softmax on bf16 x far from the origin (positions to ~215
    mean edge lengths) and the float32 u: the p and r of the float32
    function on the same rounded x, each rounded to bf16 once, bit for bit.
    Forming a in bf16 from u cast to bf16, the JAX package's order, moves
    some logit by more than a quarter: its head weight by more than 28%."""
    x, u, c = _far_inputs(200.0)
    xb = x.to(torch.bfloat16)
    p, r = tbanded.factorized_softmax(xb, u, c.to(torch.bfloat16))
    assert p.dtype == r.dtype == torch.bfloat16
    p32, r32 = tbanded.factorized_softmax(xb.float(), u, c.to(torch.bfloat16).float())
    assert torch.equal(p, p32.to(torch.bfloat16)) and torch.equal(r, r32.to(torch.bfloat16))
    a = xb.float() @ u
    assert float(a.abs().max()) > 100.0  # hundreds of |u|: a bf16 ulp of 0.5-1 or more
    # the JAX package's order: a rounded to bf16 from the bf16 u, off by up
    # to half an ulp of a and |x| times u's rounding: a head weight exp(a)
    # moves by exp of that
    a16 = (xb @ u.to(torch.bfloat16)).float()
    err = float((a16 - a).abs().max())
    assert err > 0.25, err


def conv_distances(shift: float) -> dict:
    """One level-0 banded FeaStConv (6 -> 32, the model's l_conv1 with its
    seed-0 weights) on icosphere(3)'s vertex band, its positions in mean
    edge lengths moved `shift` of them along each axis: each package's conv
    with bf16 activations (its parameters cast as its model casts them; the
    aggregate's operands bf16 in all four) against its conv in float32,
    over max|out| of the float32 conv; and the span of u.x over the heads."""
    mesh = jsynth.icosphere(3)
    ei = jgraphs.build_vertex_graph_1ring(mesh.ev_indices, mesh.n_vertices)
    n = mesh.n_vertices
    perm = jbanded.rcm_order(ei.astype(np.int64), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    ei_r = np.stack([inv[ei[0]], inv[ei[1]]])
    m = jbanded.band_mask_np(ei_r, round_up(n + 1, 64), 64)
    n_pad = m.shape[0] * m.shape[1]
    pts = mesh.points[perm]
    pts = pts / np.linalg.norm(pts[ei_r[0]] - pts[ei_r[1]], axis=1).mean()
    x = np.zeros((n_pad, 6), np.float32)
    x[:n, :3] = pts + np.float32(shift)
    x[:n, 3:] = mesh.points[perm]
    deg = np.zeros(n_pad, np.float32)
    np.add.at(deg, ei_r[0], 1.0)
    conv = DualGNN(device="cpu", seed=0).gnn_v.l_conv1
    prm = {k: getattr(conv, k).detach() for k in ("u", "c", "w", "b")}
    a = x[:n] @ prm["u"].numpy()
    tm, td = torch.from_numpy(m), torch.from_numpy(deg)
    outs = {}
    for name, dt, jdt in (("bf16", torch.bfloat16, jnp.bfloat16),
                          ("f32", torch.float32, jnp.float32)):
        tp = {k: v.to(dt) for k, v in prm.items()}
        tp["u"] = prm["u"]  # the model's banded convs keep u in float32
        outs["port", name] = banded_cuda.feast_conv_banded_kernel(
            tp, torch.from_numpy(x).to(dt), tm, td).float().numpy()[:n]
        jp = FeastParams(**{k: jnp.asarray(v.numpy()).astype(jdt) for k, v in prm.items()})
        outs["jax", name] = np.asarray(banded_pallas.feast_conv_banded_pallas(
            jp, jnp.asarray(x).astype(jdt), jnp.asarray(m), jnp.asarray(deg)),
            np.float32)[:n]
    scale = float(np.abs(outs["port", "f32"]).max())
    out = {"span": float((a.max(1) - a.min(1)).max()), "max_abs_a": float(np.abs(a).max())}
    for pkg in ("jax", "port"):
        out[pkg] = float(np.abs(outs[pkg, "bf16"] - outs[pkg, "f32"]).max()) / scale
    out["f32_port_vs_jax"] = float(np.abs(outs["port", "f32"] - outs["jax", "f32"]).max()) / scale
    return out


def test_bf16_conv_distance_witness():
    """The witness of the deviation, one conv: at positions moved 16 mean
    edge lengths (icosphere(5)'s whole-mesh scale, where u.x spans 15 over
    the heads, under banded.WIDE_SPAN: both packages shift by the maxima
    and their float32 convs agree within 1e-3 of max|out|, the bf16
    aggregate operands' distance), the port's bf16-vs-float32 distance no
    larger than the JAX package's own (readings: 1.16e-2 against 2.42e-2;
    at a shift of 8, 5.5e-3 against 1.81e-2; `python
    tests/test_torch_bf16_coords.py conv`)."""
    d = conv_distances(16.0)
    assert d["span"] < tbanded.WIDE_SPAN and d["f32_port_vs_jax"] <= 1e-3, d
    assert d["port"] <= d["jax"], d


def _whole_sample(config, synth_mod, builder_mod, batching_mod, subdiv):
    """add_noise(icosphere(subdiv), 0.2, seed=0) whole, as one union sample
    under Config(granularity=256) (chip_smoke.py's [large] build), and the
    sample's mean edge length in its normalized coordinates."""
    clean = synth_mod.icosphere(subdiv)
    noisy = synth_mod.add_noise(clean, 0.2, seed=0)
    bc = config(granularity=256).build_config()
    bv, bf, meta = builder_mod.build_raw(noisy, clean, bc)
    single, _ = builder_mod.build_dual_sample(noisy, clean, bc)
    widths = builder_mod.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    sample = builder_mod.attach_tables(batching_mod.union_batch([single]), widths)
    mel = geometry.mean_edge_length_np(noisy.points, noisy.ev_indices) * float(
        np.asarray(sample.scale).reshape(-1)[0])
    return sample, noisy, mel


def bf16_vs_f32(subdiv: int) -> dict:
    """Each package's forward with bf16 activations against its forward
    with float32 activations (bf16 fc heads in all four, the seed-0 weights
    of the port's DualGNN in both packages; the JAX convs in Pallas
    interpret mode), on the whole-mesh sample: the positions' largest
    distance in mean edge lengths and the normals'."""
    s_j, noisy, mel = _whole_sample(JConfig, jsynth, jbuilder, jbatching, subdiv)
    s_t = _whole_sample(Config, synth, builder, batching, subdiv)[0].to("cpu")
    n_v, n_f = noisy.n_vertices, noisy.n_faces
    state = DualGNN(fc_dtype=torch.bfloat16, device="cpu", seed=0).state_dict()
    jparams = tparams.to_jax_params(state)
    outs = {}
    for name, dt, jdt in (("bf16", torch.bfloat16, jnp.bfloat16),
                          ("f32", torch.float32, jnp.float32)):
        model = DualGNN(compute_dtype=dt, fc_dtype=torch.bfloat16, device="cpu")
        model.load_state_dict(state)
        with torch.no_grad():
            outs["port", name] = [t.float().numpy() for t in model(s_t)]
        jmodel = JDualGNN(compute_dtype=jdt, fc_dtype=jnp.bfloat16)
        outs["jax", name] = [np.asarray(t, np.float32) for t in jmodel.apply(jparams, s_j)]
    out = {"faces": int(n_f), "max_abs_position_mel": float(
        np.abs(outs["port", "f32"][0][:n_v]).max() / mel)}
    for pkg in ("jax", "port"):
        (vb, nb), (vf, nf) = outs[pkg, "bf16"], outs[pkg, "f32"]
        out[pkg] = {"positions_mel": float(np.abs(vb[:n_v] - vf[:n_v]).max() / mel),
                    "normals": float(np.abs(nb[:n_f] - nf[:n_f]).max())}
    return out


if __name__ == "__main__":  # python tests/test_torch_bf16_coords.py <subdivisions>
    import sys

    import conftest  # noqa: F401  (the JAX CPU settings of the test suite)

    testing.match_reference_native(jnative)
    if sys.argv[1] == "conv":
        for shift in (0.0, 8.0, 16.0, 25.0, 50.0, 100.0, 200.0):
            print(json.dumps(dict(shift=shift, **conv_distances(shift))))
    else:
        print(json.dumps(bf16_vs_f32(int(sys.argv[1]))))
