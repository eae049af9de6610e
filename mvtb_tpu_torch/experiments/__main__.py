"""CLI: run registry experiments on the card.

    python -m mvtb_tpu_torch.experiments list
    python -m mvtb_tpu_torch.experiments run gibbs12p5 --chunked \
        --epochs 2 --steps 4 --workdir runs/gibbs12p5 [--fast] [--resume]
    python -m mvtb_tpu_torch.experiments run gibbs12p5 --device cpu ...
    python -m mvtb_tpu_torch.experiments run gibbs12p5 --arch swin_unetr \
        --chunked --fast --epochs 2 --steps 4 --pool 16

    python -m mvtb_tpu_torch.experiments run gibbs0p7_layer_GD --chunked \
        --epochs 4 --steps 8 --workdir runs/gibbs0p7_layer_GD [--resume]
    python -m mvtb_tpu_torch.experiments run dcgan --chunked --epochs 4 \
        --steps 8 --ckpt-every 2 --workdir runs/dcgan [--mitigated]
    python -m mvtb_tpu_torch.experiments domain gibbs15_domain --epochs 2 \
        --workdir runs/gibbs15_domain

The counterpart of the JAX package's CLI (mvtb_tpu/experiments/__main__.py);
it prints the same one summary JSON line. ``--device`` defaults to
``cuda``. ``--pool`` and ``--val-batches`` set ``run``'s pool and held-out
sizes; ``--ckpt-every`` the checkpoint (and DCGAN FID) cadence of chunked
GAN and learnable runs; ``--mitigated`` runs a GAN config's mitigation profile
(``registry.mitigated``: one-sided label smoothing 0.9); ``--arch
swin_unetr`` / ``--arch segmamba`` trains a segmentation config's data with
SwinUNETR / SegMamba on 128^3 crops in place of its UNet (models the JAX
package does not have).
``domain`` runs ``run_domain_experiment`` with ``--epochs``, ``--steps``,
``--seed``, ``--workdir``, ``--quiet`` and ``--device``, as the JAX CLI
passes them, refuses each of ``run``'s own options (``RUN_ONLY``), which
it would not use, and prints the summary line with the ``gap`` record.
"""

from __future__ import annotations

import argparse
import json
import sys


# the options of ``run`` that ``domain`` refuses (``run_domain_experiment``
# takes none of them)
RUN_ONLY = ("fast", "chunked", "resume", "pool", "val_batches", "mitigated", "ckpt_every",
            "arch")


def _run_options(p: argparse.ArgumentParser, refused: bool) -> None:
    """``run``'s own options; on a command that ``refused`` them, declared
    with no default, so that only a given one appears in the namespace."""
    from mvtb_tpu_torch.models import SEG_ARCHS

    def add(*names, **kw):
        if refused:
            kw["default"] = argparse.SUPPRESS
        p.add_argument(*names, **kw)

    add("--fast", action="store_true",
        help="fast_science profile: batch 16 + plane_fast backend (non-parity "
             "synthetic runs only)")
    add("--chunked", action="store_true",
        help="one chunk (one host read) per epoch over a pool on the device")
    add("--resume", action="store_true",
        help="continue a chunked run from the latest checkpoint in --workdir")
    add("--pool", type=int, default=48, help="training pool size of a chunked run")
    add("--val-batches", type=int, default=12, help="batches in the fixed held-out set")
    add("--mitigated", action="store_true",
        help="GAN-collapse mitigation profile: one-sided label smoothing 0.9 "
             "(registry.mitigated)")
    add("--ckpt-every", type=int, default=None,
        help="checkpoint/FID cadence in epochs (chunked GAN and learnable runs)")
    add("--arch", choices=sorted(SEG_ARCHS), default="unet",
        help="segmentation model: the config's UNet, or SwinUNETR or SegMamba at its "
             "published widths on 128^3 crops")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mvtb_tpu_torch.experiments")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list registry experiment names")

    for cmd in ("run", "domain"):
        p = sub.add_parser(cmd, help=f"{cmd} an experiment")
        p.add_argument("name")
        p.add_argument("--epochs", type=int, default=None)
        p.add_argument("--steps", type=int, default=8,
                       help="steps per epoch (synthetic data)")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--workdir", default=None)
        p.add_argument("--quiet", action="store_true")
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda; cpu runs the plain "
                            "versions of the kernels)")
        _run_options(p, cmd == "domain")

    args = parser.parse_args(argv)

    from mvtb_tpu_torch.experiments import names, run, run_domain_experiment

    if args.cmd == "list":
        for n in names():
            print(n)
        return 0
    fn = run_domain_experiment if args.cmd == "domain" else run
    kwargs = {}
    target = args.name
    if args.cmd == "domain":
        for flag in RUN_ONLY:
            if flag in vars(args):
                parser.error(f"--{flag.replace('_', '-')} is only supported with the "
                             "'run' command")
    if args.cmd == "run":
        kwargs = {"val_batches": args.val_batches, "chunked": args.chunked,
                  "resume": args.resume, "pool": args.pool, "fast": args.fast,
                  "ckpt_every": args.ckpt_every, "arch": args.arch}
        if args.mitigated:
            from mvtb_tpu_torch.experiments.registry import get, mitigated
            from mvtb_tpu_torch.experiments.runner import GAN_KINDS

            base = get(args.name)
            if base.kind not in GAN_KINDS:
                parser.error(f"--mitigated applies to GAN configs only "
                             f"({args.name} is kind={base.kind!r})")
            target = mitigated(base)
    result = fn(target, epochs=args.epochs, steps_per_epoch=args.steps,
                seed=args.seed, workdir=args.workdir, verbose=not args.quiet,
                device=args.device, **kwargs)
    summary = {k: v for k, v in result.items()
               if k in ("best_dice", "gap", "wall_time_s")}
    print(json.dumps(summary, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
