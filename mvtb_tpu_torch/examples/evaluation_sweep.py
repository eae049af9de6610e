"""Cross-corruption evaluation sweep -- the comparison notebooks' workflow
(``20_results/80_common_evaluations/comparison_on_*.ipynb``) as a script
(the port of ``examples/evaluation_sweep.py``).

Trains two small models through the runner (a clean baseline and a
Gibbs-stylized one), evaluates both on a grid of corrupted validation sets
through the sweep harness (``TransformSweep``, ``ModelEvaluation``), and
writes each model's Dice table (JSON and pickle, like the reference's
``model_evaluation`` records) and, where matplotlib imports, the
grouped-bar comparison figure.

Run on the card: ``python -m mvtb_tpu_torch.examples.evaluation_sweep``
(env: EPOCHS, WORKDIR; default WORKDIR ``runs_torch/evaluation_sweep``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from mvtb_tpu_torch._device import DeviceLike, resolve_device
from mvtb_tpu_torch.examples import _common as C

KNOBS = {"EPOCHS": ("epochs", int), "WORKDIR": ("workdir", str)}


def run(epochs: int = 2, workdir: Optional[str] = None, spatial=(64, 64, 32),
        steps_per_epoch: int = 6, device: DeviceLike = None, verbose: bool = True) -> dict:
    """Train, sweep, save; returns ``{model: eval_dict}``."""
    from mvtb_tpu_torch.data.synthetic import decathlon_style_dicts
    from mvtb_tpu_torch.eval.harness import ModelEvaluation, TransformSweep
    from mvtb_tpu_torch.experiments import ExperimentConfig, run as run_experiment
    from mvtb_tpu_torch.ops.fused import StylizeConfig
    from mvtb_tpu_torch.transforms import GibbsNoise, SaltAndPepper, WrapArtifactd

    dev = resolve_device(device)
    workdir = workdir or C.outdir("evaluation_sweep")
    os.makedirs(workdir, exist_ok=True)
    spatial = tuple(spatial)
    small = dict(channels=(8, 16, 32), strides=(2, 2), spatial=spatial, batch_size=2,
                 val_interval=max(epochs, 1))
    results = {}
    for name, sty in [("baseline", None),
                      ("gibbs12.5", StylizeConfig(disk_r=12.5, disk_prob=1.0))]:
        cfg = ExperimentConfig(name=name, train_stylize=sty, **small)
        if verbose:
            print(f"== training {name} ==")
        results[name] = run_experiment(cfg, epochs=epochs, steps_per_epoch=steps_per_epoch,
                                       verbose=verbose, device=dev)

    # the validation pool and the named corruption grid of the notebooks
    samples = decathlon_style_dicts(7, 8, channels=4, spatial=spatial, n_classes=3)

    def gibbs(alpha):
        t = GibbsNoise(alpha, as_tensor_output=False, device=dev)
        return lambda d: {**d, "image": np.asarray(t(d["image"]))}

    grid = {
        "clean": None,
        "gibbs0.3": gibbs(0.3),
        "gibbs0.6": gibbs(0.6),
        "wrap0.5": WrapArtifactd(keys="image", alpha=0.5, device=dev),
        "sap0.15": SaltAndPepper(p=0.15, keys="image", device=dev).set_random_state(0),
    }
    eval_dicts = {}
    for name, result in results.items():
        ev = ModelEvaluation(result["state"].model,
                             instance_name=os.path.join(workdir, f"{name}_model"), device=dev)
        for ds_name, loader in TransformSweep(samples, grid, batch_size=2):
            ev.add_eval(ds_name, loader)
            if verbose:
                print(f"{name} on {ds_name}: mean dice {ev.eval_dict[ds_name][0]:.4f}")
        ev.save()
        eval_dicts[name] = dict(ev.eval_dict)

    def plot():
        from mvtb_tpu_torch.eval.plots import plot_model_performance

        return plot_model_performance(eval_dicts, os.path.join(workdir, "comparison.png"))

    C.best_effort_plot(plot)
    if verbose:
        print("tables (+ figure where matplotlib imports) written to", workdir)
    return eval_dicts


def main(argv=None) -> dict:
    return C.env_main(run, KNOBS, argv, __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
