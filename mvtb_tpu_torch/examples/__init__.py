"""The study scripts: the ports of the JAX package's ``examples/``, one
module each, run as ``python -m mvtb_tpu_torch.examples.<name>`` (on the
card unless ``--device cpu``; the JAX scripts' environment knobs apply) or
through each module's ``run(**params)``. Outputs go to ``runs_torch/<name>``.

* ``robustness_gain`` -- stylized-trained against baseline under each
  corruption family (the core claim; ``FAST=1`` trains on the plane kernel);
* ``cross_corruption_matrix`` -- every model on every corruption, with a
  learnable-alpha row;
* ``holdout_hospital`` -- the generalization gap to a held-out hospital;
* ``fullvol_probe`` -- one full-volume (240x240x160) train step: ms, peak
  memory, the out-of-memory boundary (twin: ``fullvol_tpu_probe.py``);
* ``full_scale_run`` -- the reference-length run and its resume drill;
* ``brats_rehearsal`` -- NIfTI tree -> preprocess -> train -> sweep ->
  tables -> plot, in one command;
* ``evaluation_sweep`` -- the comparison notebooks' sweep harness;
* ``stylized_gibbs12p5`` -- a reference script's loop through the shims;
* ``recon_gan_recovery`` -- the reconstruction GANs' PSNR gain;
* ``dcgan_fid_report`` -- DCGAN training with a frozen-encoder FID curve;
* ``learnable_trajectory`` -- Gibbs alpha by finite differences and by
  autograd;
* ``spikes_fd_vs_grad`` -- the spike intensity by both estimators;
* ``fourier_disk_masks`` -- the k-space mask gallery;
* ``rotate_gradient`` -- a gradient through a rotation angle.
"""
