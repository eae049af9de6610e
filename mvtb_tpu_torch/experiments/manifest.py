"""Name-for-name coverage manifest: reference script -> registry config
(counterpart of mvtb_tpu/experiments/manifest.py, its ``SCRIPT_MAP``
copied).

``SCRIPT_MAP`` lists every ``*.py`` under the reference's ``10_scripts/`` and
``50_reconstruction/`` trees and the :mod:`mvtb_tpu_torch.experiments.registry`
entry that reproduces it (the port's registry holds the JAX package's
entries, field for field). ``LIBRARY_MAP`` maps the library modules that
are components rather than experiments to the port's module that rebuilds
them.
"""

from __future__ import annotations

# Experiment scripts -> registry names. Many-to-one is legitimate: reruns
# (`_2`), debug-print variants, and editor checkpoints share their config.
SCRIPT_MAP = {
    # --- 20_Gibbs_filters (4-channel BraTS, T1 template) ---
    "10_scripts/20_Gibbs_filters/baseline.py": "baseline",
    "10_scripts/20_Gibbs_filters/baseline_aug14.py": "baseline_aug14",
    "10_scripts/20_Gibbs_filters/gibbs_data_augmentation.py": "gibbs_augmentation",
    "10_scripts/20_Gibbs_filters/stylized_gibbs9.py": "gibbs9",
    "10_scripts/20_Gibbs_filters/stylized_gibbs10.py": "gibbs10",
    "10_scripts/20_Gibbs_filters/stylized_gibbs12p5.py": "gibbs12p5",
    "10_scripts/20_Gibbs_filters/stylized_gibbs15.py": "gibbs15",
    "10_scripts/20_Gibbs_filters/stylized_gibbs20.py": "gibbs20",
    "10_scripts/20_Gibbs_filters/stylized_gibbs25.py": "gibbs25",
    "10_scripts/20_Gibbs_filters/stylized_gibbs35.py": "gibbs35",
    "10_scripts/20_Gibbs_filters/stylized_gibbs10-25.py": "gibbs_sampled10_25",
    "10_scripts/.ipynb_checkpoints/stylized_gibbs55-checkpoint.py": "gibbs55",
    # --- 30_plane_waves_filters ---
    "10_scripts/30_plane_waves_filters/stylized_planes12.py": "planes12",
    "10_scripts/30_plane_waves_filters/stylized_planes13.py": "planes13",
    "10_scripts/30_plane_waves_filters/stylized_planes14.py": "planes14",
    "10_scripts/30_plane_waves_filters/stylized_planes15.py": "planes15",
    "10_scripts/30_plane_waves_filters/stylized_planes16.py": "planes16",
    "10_scripts/30_plane_waves_filters/stylized_planes16p5.py": "planes16p5",
    "10_scripts/30_plane_waves_filters/stylized_planes17.py": "planes17",
    # --- 40_salt_and_pepper ---
    "10_scripts/40_salt_and_pepper/stylized_saltAndPepper_05.py": "sap0p05",
    "10_scripts/40_salt_and_pepper/stylized_saltAndPepper_15.py": "sap0p15",
    "10_scripts/40_salt_and_pepper/stylized_saltAndPepper_25.py": "sap0p25",
    "10_scripts/40_salt_and_pepper/stylized_saltAndPepper_35.py": "sap0p35",
    # --- 50_wraparound ---
    "10_scripts/50_wraparound/stylized_wrap0.py": "wrap0",
    "10_scripts/50_wraparound/stylized_wrap0p25.py": "wrap0p25",
    "10_scripts/50_wraparound/stylized_wrap0p5.py": "wrap0p5",
    "10_scripts/50_wraparound/stylized_wrap0p75.py": "wrap0p75",
    "10_scripts/50_wraparound/stylized_wrap0__test.py": "wrap0_test",
    # --- one-channel baselines ---
    "10_scripts/100_T2_basline/baseline_T2.py": "baseline_T2",
    "10_scripts/120_Gibbs_oneChannel/baseline_FLAIR.py": "baseline_FLAIR",
    "10_scripts/120_Gibbs_oneChannel/stylized_gibbs9_FLAIR.py": "gibbs9_FLAIR",
    "10_scripts/120_Gibbs_oneChannel/stylized_gibbs12p5_FLAIR.py": "gibbs12p5_FLAIR",
    "10_scripts/120_Gibbs_oneChannel/stylized_gibbs15_FLAIR.py": "gibbs15_FLAIR",
    "10_scripts/120_Gibbs_oneChannel/stylized_gibbs20_FLAIR.py": "gibbs20_FLAIR",
    "10_scripts/120_Gibbs_oneChannel/stylized_gibbs25_FLAIR.py": "gibbs25_FLAIR",
    # --- stacked corruptions (the "spikes" are plane-wave writes) ---
    "10_scripts/125_gibbs_spikes_OneChannel/stylized_gibbs12p5_spikes12_FLAIR.py":
        "gibbs12p5_spikes12_FLAIR",
    "10_scripts/125_gibbs_spikes_OneChannel/stylized_gibbs12p5_spikes13_FLAIR.py":
        "gibbs12p5_spikes13_FLAIR",
    "10_scripts/125_gibbs_spikes_OneChannel/stylized_gibbs12p5_spikes14_FLAIR.py":
        "gibbs12p5_spikes14_FLAIR",
    "10_scripts/125_gibbs_spikes_OneChannel/stylized_gibbs12p5_spikes15_FLAIR.py":
        "gibbs12p5_spikes15_FLAIR",
    "10_scripts/125_gibbs_spikes_OneChannel/stylized_gibbs12p5_spikes16_FLAIR.py":
        "gibbs12p5_spikes16_FLAIR",
    "10_scripts/125_gibbs_spikes_OneChannel/stylized_gibbs12p5_spikes17_FLAIR.py":
        "gibbs12p5_spikes17_FLAIR",
    "10_scripts/126_gibbs_spikes_wraparound_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p0_FLAIR.py":
        "gibbs12p5_spikes15_wrap0_FLAIR",
    "10_scripts/126_gibbs_spikes_wraparound_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p25_FLAIR.py":
        "gibbs12p5_spikes15_wrap0p25_FLAIR",
    "10_scripts/126_gibbs_spikes_wraparound_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p5_FLAIR.py":
        "gibbs12p5_spikes15_wrap0p5_FLAIR",
    "10_scripts/126_gibbs_spikes_wraparound_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p75_FLAIR.py":
        "gibbs12p5_spikes15_wrap0p75_FLAIR",
    "10_scripts/127_gibbs_spikes_wraparound_sap_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p5_sap0p05_FLAIR.py":
        "gibbs12p5_spikes15_wrap0p5_sap0p05_FLAIR",
    "10_scripts/127_gibbs_spikes_wraparound_sap_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p5_sap0p15_FLAIR.py":
        "gibbs12p5_spikes15_wrap0p5_sap0p15_FLAIR",
    "10_scripts/127_gibbs_spikes_wraparound_sap_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p5_sap0p25_FLAIR.py":
        "gibbs12p5_spikes15_wrap0p5_sap0p25_FLAIR",
    "10_scripts/127_gibbs_spikes_wraparound_sap_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p5_sap0p35_FLAIR.py":
        "gibbs12p5_spikes15_wrap0p5_sap0p35_FLAIR",
    "10_scripts/127_gibbs_spikes_wraparound_sap_OneChannel/"
    "baseline_3modalities.py": "baseline_3modalities",
    "10_scripts/127_gibbs_spikes_wraparound_sap_OneChannel/"
    "stylized_gibbs12p5_spikes15_wrap0p5_sap0p05_3modalities.py":
        "gibbs12p5_spikes15_wrap0p5_sap0p05_3modalities",
    "10_scripts/140_salt_and_pepper_oneChannel/stylized_sap15_FLAIR.py":
        "sap0p15_FLAIR",
    "10_scripts/140_salt_and_pepper_oneChannel/stylized_sap25_FLAIR.py":
        "sap0p25_FLAIR",
    # --- 300_instutional_distribution (TCGA hold-out-hospital) ---
    "10_scripts/300_instutional_distribution/baseline_domain.py": "baseline_domain",
    "10_scripts/300_instutional_distribution/baseline_domain_30_epochs.py":
        "baseline_domain_30_epochs",
    "10_scripts/300_instutional_distribution/gibbs10_domain.py": "gibbs10_domain",
    "10_scripts/300_instutional_distribution/gibbs15_domain.py": "gibbs15_domain",
    "10_scripts/300_instutional_distribution/gibbs20_domain.py": "gibbs20_domain",
    "10_scripts/300_instutional_distribution/gibbs25_domain.py": "gibbs25_domain",
    "10_scripts/300_instutional_distribution/gibbs30_domain.py": "gibbs30_domain",
    "10_scripts/300_instutional_distribution/gibbs35_domain.py": "gibbs35_domain",
    "10_scripts/300_instutional_distribution/gibbs40_domain.py": "gibbs40_domain",
    "10_scripts/300_instutional_distribution/gibbs45_domain.py": "gibbs45_domain",
    "10_scripts/300_instutional_distribution/gibbs55_domain.py": "gibbs55_domain",
    "10_scripts/300_instutional_distribution/gibbs65_domain.py": "gibbs65_domain",
    "10_scripts/300_instutional_distribution/gibbs75_domain.py": "gibbs75_domain",
    "10_scripts/300_instutional_distribution/gibbs85_domain.py": "gibbs85_domain",
    "10_scripts/300_instutional_distribution/gibbs95_domain.py": "gibbs95_domain",
    "10_scripts/300_instutional_distribution/spikes6_domain.py": "spikes6_domain",
    "10_scripts/300_instutional_distribution/spikes7_domain.py": "spikes7_domain",
    "10_scripts/300_instutional_distribution/spikes8_domain.py": "spikes8_domain",
    "10_scripts/300_instutional_distribution/spikes9_domain.py": "spikes9_domain",
    "10_scripts/300_instutional_distribution/spikes9p5_domain.py": "spikes9p5_domain",
    "10_scripts/300_instutional_distribution/spikes10_domain.py": "spikes10_domain",
    "10_scripts/300_instutional_distribution/spikes10p5_domain.py": "spikes10p5_domain",
    "10_scripts/300_instutional_distribution/spikes11_domain.py": "spikes11_domain",
    "10_scripts/300_instutional_distribution/spikes12_domain.py": "spikes12_domain",
    # sap_domain.py is a mislabeled copy: its body is the spikes script with
    # INTENSITY = 8 (JOB_NAME f"spikes{INTENSITY}_..." at its :86).
    "10_scripts/300_instutional_distribution/sap_domain.py": "spikes8_domain",
    "10_scripts/300_instutional_distribution/sap05_domain.py": "sap0p05_domain",
    "10_scripts/300_instutional_distribution/sap10_domain.py": "sap0p1_domain",
    "10_scripts/300_instutional_distribution/sap125_domain.py": "sap0p125_domain",
    "10_scripts/300_instutional_distribution/sap15_domain.py": "sap0p15_domain",
    "10_scripts/300_instutional_distribution/sap175_domain.py": "sap0p175_domain",
    "10_scripts/300_instutional_distribution/sap20_domain.py": "sap0p2_domain",
    "10_scripts/300_instutional_distribution/sap25_domain.py": "sap0p25_domain",
    "10_scripts/300_instutional_distribution/gibbs30_spikes10_sap0p08_domain.py":
        "gibbs30_spikes10_sap0p08_domain",
    "10_scripts/300_instutional_distribution/gibbs35_spikes8_sap0p08_domain.py":
        "gibbs35_spikes8_sap0p08_domain",
    "10_scripts/300_instutional_distribution/gibbs35_spikes9_sap0p08_domain.py":
        "gibbs35_spikes9_sap0p08_domain",
    "10_scripts/300_instutional_distribution/gibbs35_spikes10_sap0p06_domain.py":
        "gibbs35_spikes10_sap0p06_domain",
    "10_scripts/300_instutional_distribution/gibbs35_spikes10_sap0p08_domain.py":
        "gibbs35_spikes10_sap0p08_domain",
    "10_scripts/300_instutional_distribution/gibbs35_spikes10_sap0p10_domain.py":
        "gibbs35_spikes10_sap0p10_domain",
    "10_scripts/300_instutional_distribution/gibbs35_spikes10_sap0p12_domain.py":
        "gibbs35_spikes10_sap0p12_domain",
    "10_scripts/300_instutional_distribution/gibbs40_spikes10_sap0p08_domain.py":
        "gibbs40_spikes10_sap0p08_domain",
    "10_scripts/300_instutional_distribution/gibbs45_spikes10_sap0p08_domain.py":
        "gibbs45_spikes10_sap0p08_domain",
    "10_scripts/300_instutional_distribution/gibbs55_spikes8_sap0p0_domain.py":
        "gibbs55_spikes8_sap0p0_domain",
    "10_scripts/300_instutional_distribution/gibbs55_spikes8_sap0p05_domain.py":
        "gibbs55_spikes8_sap0p05_domain",
    # --- 30_augmentation ---
    "10_scripts/300_instutional_distribution/30_augmentation/"
    "baseline_domain_augment_alpha0p2.py": "domain_augment_alpha0p2",
    "10_scripts/300_instutional_distribution/30_augmentation/"
    "baseline_domain_augment_alpha0p3.py": "domain_augment_alpha0p3",
    "10_scripts/300_instutional_distribution/30_augmentation/"
    "baseline_domain_augment_alpha0p4.py": "domain_augment_alpha0p4",
    "10_scripts/300_instutional_distribution/30_augmentation/"
    "baseline_domain_augment_alpha0p5.py": "domain_augment_alpha0p5",
    "10_scripts/300_instutional_distribution/30_augmentation/"
    "baseline_domain_augment_spikes9-11.py": "domain_augment_spikes9_11",
    "10_scripts/300_instutional_distribution/30_augmentation/"
    "baseline_domain_augment_spikes10-11.py": "domain_augment_spikes10_11",
    # heart: RandGibbsNoised is commented out as committed (its :119) — the
    # named augmentation config carries the script's stated intent
    "10_scripts/300_instutional_distribution/30_augmentation/5_heart/"
    "baseline_domain_augment_alpha0p4.py": "heart_augment_gibbs",
    # spleen: clean Task09 baseline as committed (no corruption in pipeline)
    "10_scripts/300_instutional_distribution/30_augmentation/6_spleen/"
    "baseline_spleen.py": "baseline_spleen",
    # --- 350_stylized_layers (learnable corruption) ---
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "baseline_domain.py": "baseline_domain_test",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "baseline_domain_2.py": "baseline_domain_test",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p4_layer_domain_frozenUnet_GD.py": "gibbs0p4_layer_GD_frozen",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p5_layer_domain.py": "gibbs0p5_layer_fixed",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p5_layer_domain_GD.py": "gibbs0p5_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p6_layer_domain_GD.py": "gibbs0p6_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p69_layer_domain_GD.py": "gibbs0p69_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain.py": "gibbs0p7_layer_fixed",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_GD.py": "gibbs0p7_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_GD_inDist.py": "gibbs0p7_layer_GD_inDist",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_GD_transferUnet30epochs.py":
        "gibbs0p7_layer_GD_transferUnet30epochs",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_frozenUnet.py": "gibbs0p7_layer_frozen",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_frozenUnet_GD.py": "gibbs0p7_layer_GD_frozen",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_frozenUnet_SGD.py": "gibbs0p7_layer_frozen_sgd",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_frozenUnet_print_grad.py": "gibbs0p7_layer_frozen",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_lr0p001.py": "gibbs0p7_layer_fixed_lr0p001",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p7_layer_domain_lr0p005.py": "gibbs0p7_layer_fixed_lr0p005",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p71_layer_domain_GD.py": "gibbs0p71_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p75_layer_domain_GD.py": "gibbs0p75_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p8_layer_domain_GD.py": "gibbs0p8_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p85_layer_domain_GD.py": "gibbs0p85_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs0p9_layer_domain_GD.py": "gibbs0p9_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs1p0_layer_domain.py": "gibbs1_layer_fixed",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "gibbs1p0_layer_domain_2.py": "gibbs1_layer_fixed",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "spikes5_layer_domain_GD.py": "spikes5_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "spikes9_layer_domain_GD.py": "spikes9_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "spikes11_layer_domain_GD.py": "spikes11_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "spikes13_layer_domain_GD.py": "spikes13_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "spikes15_layer_domain_GD.py": "spikes15_layer_GD",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "351_adversarial_gibbs/gibbs_gan.py": "gibbs_gan",
    # --- 50_reconstruction GANs ---
    "50_reconstruction/dcgan.py": "dcgan",
    "50_reconstruction/reconGan/reconGan.py": "recon_gan",
    "50_reconstruction/reconGan/reconGan_freq.py": "recon_gan_freq",
}

# Library/support modules: components, not experiments. Values name the
# port's module that rebuilds the capability.
LIBRARY_MAP = {
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "351_adversarial_gibbs/networks.py": "mvtb_tpu_torch.models.resunet_gan",
    "10_scripts/300_instutional_distribution/350_stylized_layers/"
    "351_adversarial_gibbs/tcga_data.py": "mvtb_tpu_torch.data.tcga",
    # 2x2 rotation-matrix gradient toy exploring grads through a geometric
    # parameter (the port of the JAX package's example, as its value names)
    "10_scripts/300_instutional_distribution/350_stylized_layers/rotate.py":
        "mvtb_tpu_torch.examples.rotate_gradient",
    "50_reconstruction/__init__.py": "mvtb_tpu_torch",
    "50_reconstruction/data/__init__.py": "mvtb_tpu_torch.data",
    "50_reconstruction/dcgan/__init__.py": "mvtb_tpu_torch.models.dcgan",
    "50_reconstruction/networks.py": "mvtb_tpu_torch.models.dcgan",
    "50_reconstruction/brats_data.py": "mvtb_tpu_torch.data.slices",
    "50_reconstruction/reconGan/brats_data.py": "mvtb_tpu_torch.data.slices",
    "50_reconstruction/reconGan/networks.py": "mvtb_tpu_torch.models.resunet_gan",
    "50_reconstruction/reconGan/utils2.py": "mvtb_tpu_torch.ops.corruptions",
}
