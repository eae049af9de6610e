"""Config-driven experiment system of the port (counterpart of
mvtb_tpu/experiments): the registry and the runner."""

from mvtb_tpu_torch.experiments.registry import REGISTRY, ExperimentConfig, get, names
from mvtb_tpu_torch.experiments.runner import run, run_domain_experiment

__all__ = ["REGISTRY", "ExperimentConfig", "get", "names", "run", "run_domain_experiment"]
