"""Example programs of the port (counterparts of the root ``examples/``
programs): ``python -m cardiac_ablation_ecm2_tpu_torch.examples.<name>``."""
