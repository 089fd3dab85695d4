"""Deployment binaries (reference L10, SURVEY.md §1): ``broker``,
``marshal``, ``client`` plus the chaos generators ``bad_broker``,
``bad_connector``, ``bad_sender``. Run as ``python -m
pushcdn_tpu_torch.bin.broker`` etc.; ``python -m
pushcdn_tpu_torch.scripts.local_cluster`` wires a full local deployment
(process-compose parity)."""
