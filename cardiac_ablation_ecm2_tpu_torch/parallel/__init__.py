"""Sharded paths over ``torch.distributed`` (counterpart of
``cardiac_ablation_ecm2_tpu/parallel``): one process per rank, each with
its own block of elements, halo exchange by point-to-point sends and
global inner products by ``all_reduce``."""
