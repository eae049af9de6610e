"""Experiment registry (counterpart of mvtb_tpu/experiments/registry.py):
the reference's ~90 script clones as configs.

Each entry captures one training script's knobs. The reference encodes
these as copy-pasted files differing in 1-10 constant lines; here one
``ExperimentConfig`` and :mod:`mvtb_tpu_torch.experiments.runner` replace
each clone. Corruption specs map onto the fused on-device
:class:`~mvtb_tpu_torch.ops.fused.StylizeConfig`. The entries are data,
equal field by field to the JAX package's (``tests/test_torch_registry.py``);
the runner runs every kind (``segmentation``, the GAN kinds and the
learnable ones), and :mod:`mvtb_tpu_torch.experiments.manifest` maps each
reference script to its entry, name for name.

Semantics note (verified against the scripts): every reference
experiment whose *name* says "spikes" — the stacked one-channel families
(``125_/126_/127_``) and the whole ``300_instutional_distribution`` sweep
including the combos — actually applies ``RandPlaneWaves_ellipsoid(55, 55,
30, intensity_value=I, prob=1)`` (e.g. ``spikes10_domain.py:123``,
``stylized_gibbs12p5_spikes15_FLAIR.py:130``), i.e. a plane-wave write on the
(55, 55, 30) ellipsoid shell, NOT ``RandKSpaceSpikeNoise``. True k-space
spike noise appears only in the augmentation scripts
(``30_augmentation/baseline_domain_augment_spikes9-11.py:120``) and inside
``Spikes_UNet``. Configs below encode what the scripts do, keeping the
reference's (misleading) names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from mvtb_tpu_torch.ops.fused import StylizeConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    kind: str = "segmentation"  # segmentation | learnable_gibbs | learnable_spikes
    #                           | dcgan | recon_gan | recon_gan_freq | gibbs_gan
    # model
    in_channels: int = 4
    out_channels: int = 3
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256)
    strides: Tuple[int, ...] = (2, 2, 2, 2)
    num_res_units: int = 2
    # "bfloat16" computes activations in bf16 with float32 parameters and
    # optimizer state; "float32" keeps the reference's float32 activations
    # (on a CUDA card cuDNN runs float32 convolutions at TF32 by default,
    # see runner.run).
    model_dtype: str = "bfloat16"
    # data
    spatial: Tuple[int, ...] = (128, 128, 64)
    # synthetic-data generator when no real dataset root is configured:
    # "textured" puts the label signal in high-k texture (the scientifically
    # meaningful vehicle — corruption destroys it, as on real MRI);
    # "smooth" is the cheap blob generator for smoke/bench runs.
    data_kind: str = "textured"
    select_channel: Optional[Tuple[int, int]] = None  # (image_chan, label_chan)
    # random modality choice per sample (MultimodalSlicesd, the _3modalities
    # scripts): tuple of candidate image channels + the fixed label channel.
    multimodal_channels: Optional[Tuple[int, ...]] = None
    multimodal_label: int = 1
    # corruption (fused, on-device)
    train_stylize: Optional[StylizeConfig] = None
    val_stylize: Optional[StylizeConfig] = None
    # optimization (reference defaults: baseline.py:209-219)
    epochs: int = 180
    batch_size: int = 2
    lr: float = 1e-4
    weight_decay: float = 1e-5
    val_interval: int = 2
    # learnable-layer experiments
    alpha0: float = 0.7
    fd_mode: bool = False   # True -> reference finite-difference alpha updates
    train_alpha: bool = True  # False -> alpha stays fixed (the no-GD scripts:
    #   the reference's alpha is a bare requires_grad tensor, never registered
    #   with the optimizer, so without the Gibbs_GD loop it does not move)
    fd_h: float = 0.01
    fd_lr: float = 0.02
    spike_intensity: float = 11.0
    freeze_unet: bool = False       # train only the stylization parameter
    unet_optimizer: str = "adam"    # "adam" | "sgd" (reference GD variants)
    transfer_from: Optional[str] = None  # checkpoint dir or registry name
    in_dist_val: bool = False  # validate on held-in hospitals (…_GD_inDist)
    # GAN experiments
    gan_lr: float = 2e-4
    gan_beta1: float = 0.5
    # GAN stability knobs, reference defaults (no smoothing, same d lr):
    # see train/gan.py dcgan_step and the mitigated() profile
    gan_real_label: float = 1.0
    gan_d_lr: Optional[float] = None
    # base feature width: DCGAN G/D use gan_nf directly (reference ngf=ndf=128,
    # networks.py); ReconGAN nets use gan_nf//8 (reference nf=16)
    gan_nf: int = 128
    nz: int = 100
    zf_p: float = 0.2
    cyclic_alpha: float = 1.0
    cyclic_gamma: float = 10.0


REGISTRY: Dict[str, ExperimentConfig] = {}


def _register(cfg: ExperimentConfig) -> None:
    if cfg.name in REGISTRY:
        raise ValueError(f"duplicate experiment {cfg.name}")
    REGISTRY[cfg.name] = cfg


def _fmt(v: float) -> str:
    return str(v).replace(".", "p").replace("p0", "") if float(v) == int(v) else \
        str(v).replace(".", "p")


# The reference's plane-wave sampling ellipsoid, shared by every "spikes"
# and "planes" script: AA, BB, CC = 55, 55, 30 (spikes10_domain.py:80).
_SHELL = (55.0, 55.0, 30.0)


def _planes(intensity: float, **extra) -> StylizeConfig:
    return StylizeConfig(plane_axes=_SHELL, plane_intensity=float(intensity),
                         plane_prob=1.0, **extra)


# --- T1 family: 4-channel BraTS, 20_Gibbs_filters/ --------------------------

_register(ExperimentConfig(name="baseline"))
# baseline_aug14.py = the re-run of the clean baseline (identical pipelines,
# different checkpoint name); kept as its own row for name-for-name parity.
_register(ExperimentConfig(name="baseline_aug14"))

for r in [9, 10, 12.5, 15, 20, 25, 35, 55]:
    sty = StylizeConfig(disk_r=float(r), disk_prob=1.0)
    _register(ExperimentConfig(
        name=f"gibbs{_fmt(r)}", train_stylize=sty, val_stylize=sty))

_register(ExperimentConfig(  # stylized_gibbs10-25: r ~ U[10, 25]
    name="gibbs_sampled10_25",
    train_stylize=StylizeConfig(disk_r=(10.0, 25.0), disk_prob=1.0),
    val_stylize=StylizeConfig(disk_r=(10.0, 25.0), disk_prob=1.0)))

_register(ExperimentConfig(  # gibbs_data_augmentation.py: train-time RandGibbsNoised
    name="gibbs_augmentation",
    train_stylize=StylizeConfig(gibbs_alpha=(0.0, 1.0), gibbs_prob=1.0)))

# --- 30_plane_waves_filters/ -------------------------------------------------

for intensity in [12, 13, 14, 15, 16, 16.5, 17]:
    _register(ExperimentConfig(
        name=f"planes{_fmt(intensity)}",
        train_stylize=_planes(intensity), val_stylize=_planes(intensity)))

# --- 40_salt_and_pepper/ -----------------------------------------------------

for p in [0.05, 0.15, 0.25, 0.35]:
    sty = StylizeConfig(sap_p=float(p), sap_prob=1.0)
    _register(ExperimentConfig(
        name=f"sap{_fmt(p)}", train_stylize=sty, val_stylize=sty))

# --- 50_wraparound/ ----------------------------------------------------------

for a in [0.0, 0.25, 0.5, 0.75]:
    sty = StylizeConfig(wrap_alpha=float(a), wrap_prob=1.0)
    _register(ExperimentConfig(
        name=f"wrap{_fmt(a)}", train_stylize=sty, val_stylize=sty))
# stylized_wrap0__test.py: the smoke variant (tiny cache, val every epoch)
_register(ExperimentConfig(
    name="wrap0_test", val_interval=1, epochs=2,
    train_stylize=StylizeConfig(wrap_alpha=0.0, wrap_prob=1.0),
    val_stylize=StylizeConfig(wrap_alpha=0.0, wrap_prob=1.0)))

# --- one-channel baselines (100_T2_basline/, 120_Gibbs_oneChannel/) ---------
# BraTS modality order: (FLAIR, T1w, T1gd, T2w); labels TC=0, WT=1, ET=2.

_register(ExperimentConfig(name="baseline_T2", in_channels=1, out_channels=1,
                           select_channel=(3, 0)))  # T2 -> TC
_register(ExperimentConfig(name="baseline_FLAIR", in_channels=1, out_channels=1,
                           select_channel=(0, 1)))  # FLAIR -> WT

for r in [9, 12.5, 15, 20, 25]:
    sty = StylizeConfig(disk_r=float(r), disk_prob=1.0)
    _register(ExperimentConfig(
        name=f"gibbs{_fmt(r)}_FLAIR", in_channels=1, out_channels=1,
        select_channel=(0, 1), train_stylize=sty, val_stylize=sty))

# --- 140_salt_and_pepper_oneChannel/ -----------------------------------------

for p in [0.15, 0.25]:
    sty = StylizeConfig(sap_p=float(p), sap_prob=1.0)
    _register(ExperimentConfig(
        name=f"sap{_fmt(p)}_FLAIR", in_channels=1, out_channels=1,
        select_channel=(0, 1), train_stylize=sty, val_stylize=sty))

# --- stacked corruptions (125_/126_/127_, FLAIR 1-channel) -------------------
# Pipeline order Gibbs -> planes -> wrap -> sap (127_.../:138-141); the
# "spikes" in the names are plane-wave writes (see module docstring).

for plane_i in [12, 13, 14, 15, 16, 17]:
    sty = _planes(plane_i, disk_r=12.5, disk_prob=1.0)
    _register(ExperimentConfig(
        name=f"gibbs12p5_spikes{plane_i}_FLAIR", in_channels=1, out_channels=1,
        select_channel=(0, 1), train_stylize=sty, val_stylize=sty))

for wrap_a in [0.0, 0.25, 0.5, 0.75]:
    sty = _planes(15, disk_r=12.5, disk_prob=1.0,
                  wrap_alpha=float(wrap_a), wrap_prob=1.0)
    _register(ExperimentConfig(
        name=f"gibbs12p5_spikes15_wrap{_fmt(wrap_a)}_FLAIR",
        in_channels=1, out_channels=1, select_channel=(0, 1),
        train_stylize=sty, val_stylize=sty))

for sap_p in [0.05, 0.15, 0.25, 0.35]:
    sty = _planes(15, disk_r=12.5, disk_prob=1.0, wrap_alpha=0.5,
                  wrap_prob=1.0, sap_p=float(sap_p), sap_prob=1.0)
    _register(ExperimentConfig(
        name=f"gibbs12p5_spikes15_wrap0p5_sap{_fmt(sap_p)}_FLAIR",
        in_channels=1, out_channels=1, select_channel=(0, 1),
        train_stylize=sty, val_stylize=sty))

# _3modalities variants: one random modality of {FLAIR, T1w, T1gd} per sample
# (MultimodalSlicesd([0,1,2], label 1) — baseline_3modalities.py:149).
_register(ExperimentConfig(
    name="baseline_3modalities", in_channels=1, out_channels=1,
    multimodal_channels=(0, 1, 2), multimodal_label=1))
_sty_3mod = _planes(15, disk_r=12.5, disk_prob=1.0, wrap_alpha=0.5,
                    wrap_prob=1.0, sap_p=0.05, sap_prob=1.0)
_register(ExperimentConfig(
    name="gibbs12p5_spikes15_wrap0p5_sap0p05_3modalities",
    in_channels=1, out_channels=1, multimodal_channels=(0, 1, 2),
    multimodal_label=1, train_stylize=_sty_3mod, val_stylize=_sty_3mod))

# --- TCGA hospital-distribution (300_instutional_distribution/) --------------
# 1-channel whole-tumor; 110 epochs (baseline_domain.py:206).

_register(ExperimentConfig(name="baseline_domain", in_channels=1,
                           out_channels=1, epochs=110))
_register(ExperimentConfig(name="baseline_domain_30_epochs", in_channels=1,
                           out_channels=1, epochs=30))
# 350_stylized_layers/baseline_domain.py (+ its _2 rerun): the baseline
# re-evaluated on the held-out test-set manifests.
_register(ExperimentConfig(name="baseline_domain_test", in_channels=1,
                           out_channels=1, epochs=110))

for r in [10, 15, 20, 25, 30, 35, 40, 45, 55, 65, 75, 85, 95]:
    sty = StylizeConfig(disk_r=float(r), disk_prob=1.0)
    _register(ExperimentConfig(
        name=f"gibbs{r}_domain", in_channels=1, out_channels=1, epochs=110,
        train_stylize=sty, val_stylize=sty))

for i in [6, 7, 8, 9, 9.5, 10, 10.5, 11, 12]:
    sty = _planes(i)
    _register(ExperimentConfig(
        name=f"spikes{_fmt(i)}_domain", in_channels=1, out_channels=1,
        epochs=110, train_stylize=sty, val_stylize=sty))

for p in [0.05, 0.10, 0.125, 0.15, 0.175, 0.20, 0.25]:
    sty = StylizeConfig(sap_p=float(p), sap_prob=1.0)
    _register(ExperimentConfig(
        name=f"sap{_fmt(p)}_domain", in_channels=1, out_channels=1,
        epochs=110, train_stylize=sty, val_stylize=sty))

# combo sweep: disk mask + plane write + salt&pepper, all prob=1
# (gibbs35_spikes10_sap0p08_domain.py:127-129 and its 11 siblings).
for g, i, p, ptag in [(30, 10, 0.08, "0p08"),
                      (35, 8, 0.08, "0p08"), (35, 9, 0.08, "0p08"),
                      (35, 10, 0.06, "0p06"), (35, 10, 0.08, "0p08"),
                      (35, 10, 0.10, "0p10"), (35, 10, 0.12, "0p12"),
                      (40, 10, 0.08, "0p08"), (45, 10, 0.08, "0p08"),
                      (55, 8, 0.0, "0p0"), (55, 8, 0.05, "0p05")]:
    sty = _planes(i, disk_r=float(g), disk_prob=1.0,
                  sap_p=float(p), sap_prob=1.0)
    _register(ExperimentConfig(
        name=f"gibbs{g}_spikes{i}_sap{ptag}_domain",
        in_channels=1, out_channels=1, epochs=110,
        train_stylize=sty, val_stylize=sty))

# --- data-augmentation variants (300_.../30_augmentation/) -------------------

for a in [0.2, 0.3, 0.4, 0.5]:
    _register(ExperimentConfig(
        name=f"domain_augment_alpha{_fmt(a)}", in_channels=1, out_channels=1,
        epochs=110,
        train_stylize=StylizeConfig(gibbs_alpha=(0.0, float(a)), gibbs_prob=0.1)))
for lo, hi in [(9.0, 11.0), (10.0, 11.0)]:
    _register(ExperimentConfig(
        name=f"domain_augment_spikes{_fmt(lo)}_{_fmt(hi)}", in_channels=1,
        out_channels=1, epochs=110,
        train_stylize=StylizeConfig(spike=True, spike_range=(lo, hi),
                                    spike_prob=0.1)))

# Decathlon Heart (Task02) & Spleen (Task09) variants. As committed, the
# heart script's RandGibbsNoised line is commented out (5_heart/
# baseline_domain_augment_alpha0p4.py:119) — both a clean baseline and the
# named augmentation config are registered per organ.
for organ, organ_epochs in [("heart", 110), ("spleen", 100)]:
    _register(ExperimentConfig(
        name=f"baseline_{organ}", in_channels=1, out_channels=1,
        epochs=organ_epochs))
    _register(ExperimentConfig(
        name=f"{organ}_augment_gibbs", in_channels=1, out_channels=1,
        epochs=organ_epochs,
        train_stylize=StylizeConfig(gibbs_alpha=(0.0, 0.4), gibbs_prob=0.1)))

# --- learnable-layer (GD) experiments (350_stylized_layers/) -----------------

# finite-difference GD sweep over the initial alpha (gibbs{a}_layer_domain_GD)
for a0 in [0.4, 0.5, 0.6, 0.69, 0.7, 0.71, 0.75, 0.8, 0.85, 0.9, 1.0]:
    _register(ExperimentConfig(
        name=f"gibbs{_fmt(a0)}_layer_GD", kind="learnable_gibbs",
        in_channels=1, out_channels=1, epochs=110, alpha0=float(a0),
        fd_mode=True))
# gradient variant: alpha trained by autodiff through the soft mask
# (replaces the reference's two extra forward passes per step)
for a0 in [0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]:
    _register(ExperimentConfig(
        name=f"gibbs{_fmt(a0)}_layer_grad", kind="learnable_gibbs",
        in_channels=1, out_channels=1, epochs=110, alpha0=float(a0),
        fd_mode=False))
# fixed-alpha variants (gibbs{a}_layer_domain: no GD loop, so alpha never
# moves — it is a bare requires_grad tensor outside the optimizer)
for a0 in [0.5, 0.7, 1.0]:
    _register(ExperimentConfig(
        name=f"gibbs{_fmt(a0)}_layer_fixed", kind="learnable_gibbs",
        in_channels=1, out_channels=1, epochs=110, alpha0=float(a0),
        fd_mode=False, train_alpha=False))
# Adam-lr variants of the fixed-alpha model (…_lr0p001 / …_lr0p005)
for lr in [1e-3, 5e-3]:
    _register(ExperimentConfig(
        name=f"gibbs0p7_layer_fixed_lr{_fmt(lr)}", kind="learnable_gibbs",
        in_channels=1, out_channels=1, epochs=110, alpha0=0.7,
        fd_mode=False, train_alpha=False, lr=lr))

# spike-layer GD sweep (spikes{I}_layer_domain_GD.py: h=0.05, lr=0.1)
for i in [5, 9, 11, 13, 15]:
    _register(ExperimentConfig(
        name=f"spikes{i}_layer_GD", kind="learnable_spikes",
        in_channels=1, out_channels=1, epochs=110, spike_intensity=float(i),
        fd_mode=True, fd_h=0.05, fd_lr=0.1))

# frozen-UNet variants: warm-start the UNet from the trained baseline and
# freeze it (gibbs0p7_layer_domain_frozenUnet*.py:218-233)
_register(ExperimentConfig(
    name="gibbs0p7_layer_frozen", kind="learnable_gibbs", in_channels=1,
    out_channels=1, epochs=110, alpha0=0.7, fd_mode=False, train_alpha=False,
    freeze_unet=True, transfer_from="baseline_domain"))
for a0 in [0.4, 0.7]:
    _register(ExperimentConfig(
        name=f"gibbs{_fmt(a0)}_layer_GD_frozen", kind="learnable_gibbs",
        in_channels=1, out_channels=1, epochs=110, alpha0=float(a0),
        fd_mode=True, freeze_unet=True, transfer_from="baseline_domain"))
# …_frozenUnet_SGD: no GD loop either — frozen warm-started UNet under
# SGD(5e-4, momentum 0) with the alpha fixed (its only moving parts are BN
# buffers; kept for name-for-name parity)
_register(ExperimentConfig(
    name="gibbs0p7_layer_frozen_sgd", kind="learnable_gibbs", in_channels=1,
    out_channels=1, epochs=110, alpha0=0.7, fd_mode=False, train_alpha=False,
    freeze_unet=True, transfer_from="baseline_domain",
    unet_optimizer="sgd", lr=5e-4))
# in-distribution validation + transfer-from-30-epoch-baseline GD variants
_register(ExperimentConfig(
    name="gibbs0p7_layer_GD_inDist", kind="learnable_gibbs", in_channels=1,
    out_channels=1, epochs=110, alpha0=0.7, fd_mode=True, in_dist_val=True))
_register(ExperimentConfig(
    name="gibbs0p7_layer_GD_transferUnet30epochs", kind="learnable_gibbs",
    in_channels=1, out_channels=1, epochs=110, alpha0=0.7, fd_mode=True,
    transfer_from="baseline_domain_30_epochs"))

# --- GANs (50_reconstruction/, 351_adversarial_gibbs/) -----------------------

_register(ExperimentConfig(name="dcgan", kind="dcgan", in_channels=1,
                           spatial=(128, 128), epochs=200, batch_size=4))
_register(ExperimentConfig(name="recon_gan", kind="recon_gan", in_channels=2,
                           spatial=(128, 128), epochs=200, batch_size=4,
                           gan_lr=1e-4, cyclic_alpha=1.0, cyclic_gamma=10.0))
_register(ExperimentConfig(name="recon_gan_freq", kind="recon_gan_freq",
                           in_channels=2, spatial=(128, 128), epochs=400,
                           batch_size=4, gan_lr=1e-4, cyclic_alpha=15.0,
                           cyclic_gamma=0.1))
_register(ExperimentConfig(name="gibbs_gan", kind="gibbs_gan", in_channels=1,
                           spatial=(128, 128), epochs=200, batch_size=4,
                           gan_lr=1e-4, cyclic_alpha=15.0, cyclic_gamma=0.1))


def get(name: str) -> ExperimentConfig:
    return REGISTRY[name]


def names() -> list:
    return sorted(REGISTRY)


def fast_science(cfg: ExperimentConfig) -> ExperimentConfig:
    """The fast profile for NON-PARITY synthetic-science runs: batch 16
    and the ``plane_fast`` backend (the fused plane kernel with single-pass
    bf16 products, the 1e-2 relative accuracy tier).

    Reference-parity configs must NOT go through this: batch size changes
    BatchNorm-free training dynamics only mildly but breaks step-count
    parity, and plane_fast's bf16 dots are outside the f32 parity tier.
    Use for robustness_gain-style reruns where the science is a relative
    effect, not a reference number.
    """
    def _fast(s):
        return dataclasses.replace(s, fft_backend="plane_fast") \
            if s is not None else None

    return dataclasses.replace(
        cfg, name=cfg.name + "_fast", batch_size=16,
        train_stylize=_fast(cfg.train_stylize),
        val_stylize=_fast(cfg.val_stylize))


def mitigated(cfg: ExperimentConfig, real_label: float = 0.9,
              d_lr: Optional[float] = None) -> ExperimentConfig:
    """GAN-collapse mitigation profile: one-sided
    label smoothing on D's real targets (default 0.9) and, optionally, a
    TTUR-style separate D learning rate. A deliberate, measured divergence
    from the reference loops — use for the synthetic-slice runs where the
    reference hyperparameters D-dominance-collapse
    (``reports/dcgan_full/README.md``; the ReconGAN runs reproduce the same
    failure)."""
    return dataclasses.replace(cfg, name=cfg.name + "_mitigated",
                               gan_real_label=real_label, gan_d_lr=d_lr)
