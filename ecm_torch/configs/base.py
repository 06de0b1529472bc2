"""Experiment presets of the port: the same dataclasses, field names,
defaults and presets as ``ecm_tpu/configs/base.py``.

The "auto" knobs resolve on CUDA the way the JAX ones resolve on a TPU, at
eval on a CUDA tensor: ``regress_mode`` -> "fused", ``agg_fused`` "auto" ->
on, and ``agg_layout`` "auto" -> "grouped" when max_disp/4 % 16 == 0 (else
"standard"); on the CPU they resolve to the plain paths. "grouped" keeps the
JAX name of the aggregation's layer-kernel dispatch; the port computes it on
NDHWC volumes. ``remat`` is a training knob (activation checkpointing of the
hourglasses) with no effect on the eval forward; ``build`` passes it to
``ECMStereo`` only, as ``ecm_tpu`` does, so ``ECMBasic`` keeps its default
(True). The models of ``models.DTYPE_ONLY`` (``raft_stereo``, ``igev_stereo``:
the port's own; ``ecm_tpu`` has neither) take none of the ECM knobs:
``build`` passes them their dtype alone, float16 (the published mixed
precision) where ``bf16`` is set, and the overrides.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "stackhourglass"  # stackhourglass | basic | raft_stereo | igev_stereo
    max_disp: int = 192
    feature_channels: int = 32
    cost_mode: str = "concat"  # concat | correlation
    context_fusion: str = "add"  # add | film | both | none
    use_pallas: bool = False  # in the port: the CUDA cost-volume kernel
    bf16: bool = True
    remat: bool = True
    regress_mode: str = "auto"  # auto | fullres | fused | lowres
    agg_layout: str = "auto"  # auto | standard | grouped (stackhourglass)
    agg_fused: str = "off"  # off | auto | on (fused CUDA conv pairs)

    def build(self, device=None, generator=None, **overrides):
        import torch

        from ecm_torch.models import DTYPE_ONLY, build_model

        if self.name in DTYPE_ONLY:
            # the published widths and iterations (the model's defaults);
            # "bf16" selects the published mixed precision, float16
            kw = dict(dtype=torch.float16 if self.bf16 else torch.float32)
            kw.update(overrides)
            return build_model(self.name, device=device, generator=generator, **kw)
        kw = dict(
            max_disp=self.max_disp,
            feature_channels=self.feature_channels,
            cost_mode=self.cost_mode,
            context_fusion=self.context_fusion,
            use_pallas=self.use_pallas,
            regress_mode=self.regress_mode,
            dtype=torch.bfloat16 if self.bf16 else torch.float32,
        )
        if self.name in ("stackhourglass", "ecm"):
            kw["remat"] = self.remat
            kw["agg_layout"] = self.agg_layout
            kw["agg_fused"] = self.agg_fused
        kw.update(overrides)
        return build_model(self.name, device=device, generator=generator, **kw)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "sceneflow"  # sceneflow | kitti2015 | kitti2012 | synthetic
    datapath: str = ""
    crop: tuple[int, int] = (256, 512)  # (H, W) train crop
    global_batch: int = 4
    workers: int = 4
    seed: int = 1
    synthetic_distinct: int | None = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 10_000
    epochs: int | None = None
    lr: float = 1e-3
    lr_drops: tuple[tuple[int, float], ...] = ()  # (step, new_lr)
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 1000
    log_every: int = 20
    eval_every: int = 0
    mesh_data: int | None = None  # None = all devices
    mesh_disp: int = 1


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()


CONFIGS: dict[str, ExperimentConfig] = {
    # 1) single KITTI 2015 pair, 384x1248, max-disp 192, one-device inference
    "kitti_infer": ExperimentConfig(
        model=ModelConfig(),
        data=DataConfig(dataset="kitti2015", global_batch=1),
        train=TrainConfig(num_steps=0),
    ),
    # 2) SceneFlow FlyingThings3D subset, batch 4, one device
    "sceneflow_single": ExperimentConfig(
        model=ModelConfig(remat=False),
        data=DataConfig(dataset="sceneflow", global_batch=4),
        train=TrainConfig(num_steps=20_000),
    ),
    # 3) full SceneFlow train + KITTI fine-tune, one host data-parallel
    "sceneflow_dp": ExperimentConfig(
        data=DataConfig(dataset="sceneflow", global_batch=12),
        train=TrainConfig(num_steps=150_000, mesh_data=None),
    ),
    "kitti_finetune": ExperimentConfig(
        data=DataConfig(dataset="kitti2015", global_batch=12),
        train=TrainConfig(
            num_steps=60_000, lr=1e-3, lr_drops=((40_000, 1e-4),), mesh_data=None
        ),
    ),
    # 4) Middlebury high-res with disparity-axis cost-volume sharding
    "middlebury_disp_sharded": ExperimentConfig(
        model=ModelConfig(max_disp=384),
        data=DataConfig(dataset="middlebury", global_batch=1),
        train=TrainConfig(num_steps=0, mesh_data=1, mesh_disp=4),
    ),
    # 5) multi-host training, global batch >= 64
    "sceneflow_multihost": ExperimentConfig(
        data=DataConfig(dataset="sceneflow", global_batch=64),
        train=TrainConfig(num_steps=150_000, mesh_data=None),
    ),
    # tiny-overfit correctness gate on synthetic data (4 fixed batches)
    "overfit_gate": ExperimentConfig(
        model=ModelConfig(max_disp=48, bf16=False),
        data=DataConfig(
            dataset="synthetic", global_batch=2, crop=(128, 256), synthetic_distinct=4
        ),
        train=TrainConfig(num_steps=600, log_every=50, ckpt_every=10_000),
    ),
    # the same gate in the grouped layout
    "overfit_gate_grouped": ExperimentConfig(
        model=ModelConfig(max_disp=64, bf16=True, agg_layout="grouped"),
        data=DataConfig(
            dataset="synthetic", global_batch=2, crop=(128, 256), synthetic_distinct=4
        ),
        train=TrainConfig(num_steps=600, log_every=50, ckpt_every=10_000),
    ),
}

# the port's first slice: kitti_infer with the standard-layout kernel path
SLICE_OVERRIDES = dict(
    agg_layout="standard", agg_fused="on", use_pallas=True, regress_mode="fused"
)
# the second slice: kitti_infer along the JAX package's default TPU path
# (grouped layer kernels), with the cost-volume and regression kernels
SLICE2_OVERRIDES = dict(agg_layout="grouped", use_pallas=True, regress_mode="fused")
# the third slice: training along this preset, whose "auto" layout is the
# grouped path on CUDA (gband_conv_s1 at the seven full-resolution s1 convs)
TRAIN_SLICE = "sceneflow_single"
