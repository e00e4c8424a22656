"""Benchmark entry points of the port (``python -m
cardiac_ablation_ecm2_tpu_torch.benchmarks.<name>``)."""
