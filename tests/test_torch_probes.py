"""The port's measuring scripts (geobignn_tpu_torch/examples/: the twins of
the JAX repo's examples/ probes) on the CPU at icosphere(2-3): each main()
runs to its end and prints its rows; halo_scaling_report's bytes and
rounds equal the JAX package's accounting.halo_comm_report on the same
mesh and part counts; kernel_probe's bytes and operations follow the
formula of its docstring; trace_step's attribution sums to its total."""

from __future__ import annotations

import numpy as np
import pytest

from geobignn_tpu import native as jnative
from geobignn_tpu.data import synth as jsynth
from geobignn_tpu.data.builder import BuildConfig as JBuildConfig
from geobignn_tpu.parallel import accounting as jaccounting
from geobignn_tpu.parallel.halo_train import build_halo_train_sample as jbuild_halo
from geobignn_tpu_torch import testing
from geobignn_tpu_torch.examples import (bench_dynamic, halo_scaling_report, kernel_probe,
                                         probe_dynamic, probe_f1_327k, probe_serial,
                                         profile_large, profile_step, trace_step)

testing.share_cores()  # torch's CPU threads: this test worker's share of the cores

CPU = ["--device", "cpu", "--steps", "1"]
# each twin at a small size on the CPU, and the row tags it must print
RUNS = {
    "kernel_probe": (kernel_probe, CPU + ["--n", "768", "--tile", "128"], ["kernel-probe"] * 2),
    "kernel_probe_bs": (kernel_probe, CPU + ["--n", "768", "--tile", "128", "--blocksparse",
                                             "4", "--c-in", "32", "--c-out", "64"],
                        ["kernel-probe"] * 2),
    "trace_step": (trace_step, CPU + ["--subdiv", "2"], ["trace-step"]),
    "trace_step_halo": (trace_step, CPU + ["--subdiv", "2", "--halo-parts", "2"],
                        ["trace-step"]),
    "profile_step": (profile_step, CPU + ["--subdiv", "2", "--batch", "2"],
                     ["profile-step"] * 12 + ["profile-step-share"] * 12),
    "profile_large": (profile_large, CPU + ["--subdiv", "2"], ["profile-large"] * 17),
    "probe_serial": (probe_serial, CPU + ["--n", "768", "--tile", "128"],
                     ["probe-serial"] * 4),
    "probe_f1_327k": (probe_f1_327k, CPU + ["--subdiv", "3"], ["probe-f1"] * 5),
    "bench_dynamic": (bench_dynamic, CPU + ["--subdiv", "2"], ["bench-dynamic"] * 3),
    "probe_dynamic": (probe_dynamic, CPU + ["--subdiv", "2"], ["probe-dynamic"] * 6),
    "halo_scaling_report": (halo_scaling_report, ["--cells", "2:2,4", "--step-ms", "5"],
                            ["halo-scaling"] * 2),
}


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The JAX package's native path as this machine supports it: its
    loader may have read a library another process was still writing."""
    testing.match_reference_native(jnative)


def _rows(out: str, tag: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(f"[{tag}] {{")]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_twin_runs_and_prints_its_rows(name, tmp_path, capsys):
    mod, argv, tags = RUNS[name]
    if mod is trace_step:
        argv = argv + ["--trace-dir", str(tmp_path / "trace")]
    if mod is halo_scaling_report:
        argv = argv + ["--out", str(tmp_path / "halo_scaling.json")]
    mod.main(argv)
    out = capsys.readouterr().out
    for tag in set(tags):
        assert len(_rows(out, tag)) == tags.count(tag), out


@pytest.mark.parametrize("subdiv,parts", [(3, 4), (3, 8)])
def test_halo_scaling_bytes_and_rounds_equal_jax(subdiv, parts):
    """The port's report against the JAX package's accounting on the JAX
    package's own halo build of the same mesh: every byte and round figure
    exactly, and the per-part compute (the link rates differ: the JAX
    default is a TPU link's, the port's an NVLink's)."""
    mine = halo_scaling_report.report(subdiv, parts, 5.0)
    m_o = jsynth.icosphere(subdiv)
    m_n = jsynth.add_noise(m_o, 0.2, seed=0)
    hs = jbuild_halo(m_n, m_o, JBuildConfig(granularity=256, reorder=False), n_parts=parts,
                     seed=0)
    theirs = jaccounting.halo_comm_report(hs.structure, step_ms_single_chip=5.0)
    for k in ("n_parts", "step_payload_mb", "step_real_mb", "step_dense_mb",
              "padding_overhead", "n_rounds_step", "t_compute_ms"):
        assert mine[k] == theirs[k], (k, mine[k], theirs[k])
    assert len(mine["sensitivity"]) == 12


@pytest.mark.parametrize("k_blocks,c_in,c_out", [(0, 64, 32), (0, 32, 64), (4, 64, 32)])
def test_kernel_probe_counts_follow_its_formula(k_blocks, c_in, c_out):
    """kernel_probe's forward bytes and operations against its docstring's
    formula, written out here from the shapes and the set mask slots; the
    forward+backward row adds the backward's."""
    n, tile, heads = 768, 128, 9
    ops = kernel_probe.inputs(n, tile, c_in, c_out, heads, 12, k_blocks, "cpu")
    w = kernel_probe.work(ops)
    s = int((ops["m"] != 0).sum())
    tf = c_out < c_in
    k = heads * (c_out if tf else c_in)
    win = (k_blocks or 3) * tile
    byts = 4 * (2 * n * heads + n * c_in + heads * c_in * c_out + n * c_out) \
        + (n // tile) * tile * win + 8 * (n // tile) * k_blocks
    n_ops = 2 * s * (heads + k) + n * k + (
        2 * n * heads * c_out * c_in + n * k if tf else n * k + 2 * n * k * c_out)
    assert w["fwd"] == dict(bytes=byts, ops=n_ops)
    assert w["bwd"]["bytes"] > byts and w["bwd"]["ops"] > 0
    rows = kernel_probe.main(["--device", "cpu", "--steps", "1", "--n", str(n), "--tile",
                              str(tile), "--c-in", str(c_in), "--c-out", str(c_out),
                              "--blocksparse", str(k_blocks)])
    assert rows[0]["bytes"] == byts and rows[0]["ops"] == n_ops
    assert rows[1]["bytes"] == byts + w["bwd"]["bytes"]
    assert rows[1]["ops"] == n_ops + w["bwd"]["ops"]
    assert np.isclose(rows[0]["bound_ms"], max(byts / 3.35e12, n_ops / 989e12) * 1e3)


def test_trace_step_attribution_sums_to_its_total(tmp_path):
    """Every row of the trace is attributed: the rows by name and by group
    each sum to the busy time, and busy plus idle is the step."""
    att = trace_step.main(["--device", "cpu", "--subdiv", "2", "--trace-dir",
                           str(tmp_path / "trace")])
    steps = 2
    for rows in (att["by_name"], att["by_group"]):
        assert np.isclose(sum(rows.values()) / 1e3 / steps, att["busy_ms"])
    assert np.isclose(att["busy_ms"] + att["idle_ms"], att["step_ms"])
    assert 0 < att["busy_share"] <= 1.0 and (tmp_path / "trace" / "trace.json").exists()
