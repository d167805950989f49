"""Run configuration: typed dataclass + JSON round-trip.

Counterpart of geobignn_tpu/config.py, copied with the same fields and
defaults so a run's params.json reads into either package.  The port reads
the model and build fields (`build_config`, heads, pool_type,
fc_precision, force_depth, sub_size); the parallel and training fields are
carried for the round-trip.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from geobignn_tpu_torch.data.builder import BuildConfig


@dataclasses.dataclass
class Config:
    # data
    data_type: str = "Synthetic"
    dataset_dir: str = "dataset"
    flag: str = "run"
    seed: int | None = None
    filter_patch_count: int = 100
    sub_size: int = 20000

    # losses
    loss_v: str = "L1"
    loss_n: str = "L1"
    loss_v_scale: float = 1.0
    loss_n_scale: float = 1.0

    # pooling / model
    wei_param: float = 2.0
    edge_weight_type: int = 10
    pool_type: str = "max"
    heads: int = 9
    fusion_features: int = 0  # >0: opt-in DualFusionLayer of this width
    # over the vertex<->facet incidence, fused features concat'd onto both
    # branch inputs (reference net_util.py:248-278 preserved as capability;
    # this flag makes it trainable).  Single-chip / dp / dcn only.
    dynamic_pool: bool = False  # in-forward pooling (pool/dynamic.py):
    # exact reference parity for activation-dependent edge-weight types;
    # auto-enabled for the learned types 3-5, which static hierarchies
    # cannot represent (their affinities need live activations + learnable
    # attention params).  Single-chip or dp/dcn-replicated (gp=1);
    # costs ~4x/16x coarse-level
    # lane work (padded sizes cannot shrink in-graph).

    # optimization
    max_epoch: int = 1000
    batch_size: int = 1  # gradient-accumulation factor
    lr_sch: str = "lmd"  # lmd | step | multi_step | exp | auto
    lr: float = 1e-3
    lr_step: tuple = (10,)
    lr_decay: float = 1.0
    optimizer: str = "adam"  # adam | sgd | rmsprop
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0

    # restore
    restore: bool = False
    model_path: str | None = None

    # TPU-native extras
    augment: bool = True  # random SO(3) rotation during training
    preload: bool = True  # cache padded samples on device (fits small corpora)
    prefetch_depth: int = 2  # background fetches in flight when not preloading
    buckets_growth: float = 0.0  # >1: geometric SizePlan buckets (streaming
    # mode only) instead of one dataset-wide merged plan; bounds padding
    # waste by the growth factor at the cost of one compile per bucket
    preprocess_seed: int = 0  # hierarchy-matching seed; FIXED by default so
    # the content-hash preprocessing cache hits across runs (the training
    # seed must not leak into cache keys)
    granularity: int = 128
    reorder: bool = True  # RCM node ordering -> banded gather-free convs
    dp: int = 1
    gp: int = 1
    dcn: int = 1  # cross-host data-parallel replicas (multi-host pods)
    halo_parts: int = 0  # >1: halo-sharded whole-mesh TRAINING — each mesh
    # node-partitioned over `halo_parts` chips with per-conv boundary
    # exchange (train/halo_trainer.py); mutually exclusive with dp/gp/dcn
    halo_banded: bool = False  # halo convs through the banded Pallas
    # kernels (per-partition RCM slot order)
    fc_precision: str = "bfloat16"  # fc-head matmul dtype: the heads are
    # dense (no scatters), params stay f32 and outputs cast back, so bf16
    # here is parity-insensitive and measured +4% end-to-end on v5e
    # (docs/RESULTS.md round 4); "float32" restores the old exact path
    auto_resume: bool = False  # continue the latest run of this
    # data_type/flag from its ckpt_last (fault-tolerant restart: rerun the
    # same command after preemption and training resumes exactly)
    precision: str = "float32"  # float32 | bfloat16
    log_dir: str = "log"

    # derived (set in __post_init__; kept serializable)
    force_depth: bool = dataclasses.field(default=False)

    def __post_init__(self):
        self.force_depth = self.data_type in ("Kinect_v1", "Kinect_v2")
        if isinstance(self.lr_step, list):
            self.lr_step = tuple(self.lr_step)

    def validate(self) -> "Config":
        """Fail FAST on contradictory mode combinations (the interactions
        used to fail late and far from the misconfiguration):

          * bucketed streaming needs preload=False and is single-chip;
          * halo training is exclusive with dp/gp/dcn and dynamic pooling;
          * dynamic pooling allows dp/dcn but never gp;
          * precision / lr_sch / optimizer names are checked up front.
        """
        n_chips = self.dcn * self.dp * self.gp
        if self.buckets_growth > 1.0:
            if self.preload:
                raise ValueError(
                    "buckets_growth > 1 (bucketed SizePlans) requires "
                    "preload=False — per-bucket plans cannot be stacked "
                    "into one device-resident dataset"
                )
            if n_chips > 1:
                raise ValueError(
                    "buckets_growth > 1 is single-chip only (the sharded "
                    "step compiles one global batch shape)"
                )
        if self.halo_parts and self.halo_parts > 1:
            if n_chips > 1:
                raise ValueError("halo_parts is exclusive with dp/gp/dcn")
            if self.dynamic_pool or self.edge_weight_type in (3, 4, 5):
                raise ValueError(
                    "halo training uses precomputed owner-constrained "
                    "hierarchies; dynamic pooling (edge_weight_type 3-5) "
                    "is not available there"
                )
        if self.precision == "bfloat16" and (
            self.dynamic_pool or self.edge_weight_type in (3, 4, 5)
        ):
            raise ValueError(
                "precision='bfloat16' is not plumbed through dynamic "
                "pooling (it runs f32)"
            )
        if self.fusion_features:
            if self.gp > 1 or (self.halo_parts and self.halo_parts > 1):
                raise ValueError(
                    "fusion_features: the DualFusionLayer aggregates over "
                    "the full vertex<->facet incidence and is not "
                    "partition-aware — use single-chip / dp / dcn"
                )
            if self.dynamic_pool or self.edge_weight_type in (3, 4, 5):
                raise ValueError(
                    "fusion_features is not available with dynamic pooling"
                )
        if (self.dynamic_pool or self.edge_weight_type in (3, 4, 5)) and self.gp > 1:
            raise ValueError(
                "dynamic pooling cannot be graph-partitioned (gp must be "
                "1); data-parallel dp/dcn replication IS supported — the "
                "in-forward matching is per-sample"
            )
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision '{self.precision}'")
        if self.fc_precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown fc_precision '{self.fc_precision}'")
        if self.lr_sch not in ("lmd", "step", "multi_step", "exp", "auto"):
            raise ValueError(f"unknown lr_sch '{self.lr_sch}'")
        if self.optimizer not in ("adam", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer '{self.optimizer}'")
        if self.pool_type not in ("max", "mean"):
            raise ValueError(f"unknown pool_type '{self.pool_type}'")
        return self

    # ------------------------------------------------------------------
    def build_config(self) -> BuildConfig:
        return BuildConfig(
            weight_type=self.edge_weight_type,
            wei_param=self.wei_param,
            pool_type=self.pool_type,
            with_depth=self.force_depth,
            granularity=self.granularity,
            seed=self.preprocess_seed,
            reorder=self.reorder,
        )

    def loss_cfg(self) -> dict:
        return dict(
            loss_v=self.loss_v,
            loss_n=self.loss_n,
            loss_v_scale=self.loss_v_scale,
            loss_n_scale=self.loss_n_scale,
        )

    # ------------------------------------------------------------------
    def to_json(self, path: str | None = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2, default=str)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, src: str) -> "Config":
        if os.path.exists(src):
            with open(src) as f:
                d = json.load(f)
        elif src.lstrip().startswith("{"):
            d = json.loads(src)
        else:
            raise FileNotFoundError(f"config file not found: {src}")
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def with_updates(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)
