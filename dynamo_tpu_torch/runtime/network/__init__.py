"""Cross-process request plane transports — the port's copy of
dynamo_tpu/runtime/network/__init__.py.

Reference parity: lib/runtime/src/pipeline/network/ — the default raw-TCP
request plane (tcp/{server,client}.rs) with the two-part msgpack codec
(codec/two_part.rs) and a per-process shared ingress listener
(ingress/shared_tcp_endpoint.rs). TCP is the cross-process default and the
in-process LocalRequestPlane covers process-local mode. The msgpack the
frames carry is network/msgpack_lite.py's (the card's machine has no
``msgpack``). The HTTP request plane is not ported yet (ROADMAP A4c-H).
"""

from dynamo_tpu_torch.runtime.network.codec import (
    FrameReader,
    FrameWriter,
    pack_frame,
)
from dynamo_tpu_torch.runtime.network.tcp import TcpRequestPlane

__all__ = ["FrameReader", "FrameWriter", "pack_frame", "TcpRequestPlane"]
