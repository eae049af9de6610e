"""``monai.networks``."""
