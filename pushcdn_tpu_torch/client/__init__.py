"""The elastic, self-healing client (parity ``cdn-client``, SURVEY.md §2d)."""

from pushcdn_tpu_torch.client.client import Client, ClientConfig  # noqa: F401
