"""The benchmark of the PyTorch port (``mvtb_tpu_torch``) on one NVIDIA
H100: ``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``harness.py`` for the layout."""
