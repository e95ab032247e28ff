"""Online serving layer: a resident session, coalesced probe batches and
pooled host-to-device transfers over the exact-join engine (the port of
``repro.serve``)."""

from repro_torch.serve.coalescer import ProbeTicket, RequestCoalescer
from repro_torch.serve.entrypoints import EntrypointCache, pow2_bucket
from repro_torch.serve.session import JoinSession
from repro_torch.serve.transfer import TransferPool

__all__ = [
    "EntrypointCache",
    "JoinSession",
    "ProbeTicket",
    "RequestCoalescer",
    "TransferPool",
    "pow2_bucket",
]
