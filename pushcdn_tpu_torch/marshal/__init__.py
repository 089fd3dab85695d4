"""The marshal: authentication gateway / load balancer.

Capability parity with the reference's ``cdn-marshal`` crate (SURVEY.md §2c).
"""

from pushcdn_tpu_torch.marshal.marshal import Marshal, MarshalConfig  # noqa: F401
