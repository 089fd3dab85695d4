"""Deployment binaries (reference L10, SURVEY.md §1): ``broker``,
``marshal`` and ``client``, run as ``python -m pushcdn_tpu_torch.bin.broker``
etc. The JAX package's chaos generators (``bad_broker``, ``bad_connector``,
``bad_sender``) are not copied yet."""
