"""Discovery: membership, load, permits, whitelist.

Capability parity with cdn-proto/src/discovery/ (SURVEY.md §1 L5).
"""

from pushcdn_tpu_torch.proto.discovery.base import (  # noqa: F401
    BrokerIdentifier,
    DiscoveryClient,
)
from pushcdn_tpu_torch.proto.discovery.embedded import Embedded  # noqa: F401
