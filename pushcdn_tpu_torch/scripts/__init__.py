"""Operator scripts run as modules: ``python -m
pushcdn_tpu_torch.scripts.local_cluster``."""
