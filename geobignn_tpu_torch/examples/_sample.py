"""The probes' host build of one whole add_noise(icosphere(subdiv), 0.2,
seed=0) mesh, as the JAX repo's bench.py builds it (`_host_build`), through
the port's data/synth, data/builder and data/batching; the edge messages of
one step are data/dataset.branch_messages', the count of the JAX repo's
bench_baseline_torch.messages_per_step (3 convs at levels 1 and 2, 2 at
level 3, over the real edges)."""

from __future__ import annotations

import functools
import time

from geobignn_tpu_torch.config import Config
from geobignn_tpu_torch.data import batching, builder, dataset, synth


@functools.lru_cache(maxsize=2)  # probes run in one process share a build
def whole_sample(subdiv: int, batch: int = 1) -> dict:
    """The union sample of `batch` copies of the whole mesh under
    BuildConfig(granularity=256, reorder=True) with its bands and tables
    (build_raw, build_dual_sample, widths_for with bands, attach_tables),
    on the host: the sample of the JAX repo's bench.py and examples/ probes.
    Returns the meshes, the union sample, its real vertex and facet rows,
    the edge messages of one step and the build's seconds."""
    t0 = time.perf_counter()
    bc = builder.BuildConfig(granularity=256, reorder=True)
    clean = synth.icosphere(subdiv)
    noisy = synth.add_noise(clean, 0.2, seed=0)
    bv, bf, meta = builder.build_raw(noisy, clean, bc)
    single, _ = builder.build_dual_sample(noisy, clean, bc)
    widths = builder.widths_for(bv, bf, meta["fv_indices"], with_bands=True)
    sample = builder.attach_tables(batching.union_batch([single] * batch), widths)
    return dict(subdiv=subdiv, noisy=noisy, clean=clean, sample=sample,
                n_v=bv.n_nodes, n_f=bf.n_nodes,
                msgs=batch * (dataset.branch_messages(bv) + dataset.branch_messages(bf)),
                host_s=time.perf_counter() - t0)


def stand_in(cfg: Config):
    """A one-mesh dataset that holds a Trainer whose steps are given their
    sample (fused_step, _captured_step): icosphere(1), never read."""
    return dataset.InMemoryDataset(
        [(synth.add_noise(synth.icosphere(1), 0.2, seed=0), synth.icosphere(1))],
        cfg.build_config())


def train_step(tr, sample):
    """step(seed): one training step of the Trainer `tr` on `sample`, its
    shape's CUDA graph on the card (Trainer.fused_step), eager elsewhere."""
    if tr.one_dispatch():
        return lambda seed: tr.fused_step(sample, seed)
    return lambda seed: tr._captured_step(sample, tr._rotation(seed))
