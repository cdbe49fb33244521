"""Control-plane services entrypoint (discd discovery + the event broker) —
the port's copy of dynamo_tpu/discd/__main__.py, with the same flags and the
same ``discd ready: …`` line. It runs on a machine with neither msgpack nor
pyzmq: discd speaks the port's codec and the broker the port's ZMTP.

The single-process stand-in for the reference's etcd + nats-server pair.

    python -m dynamo_tpu_torch.discd --port 6180 --xsub 6181 --xpub 6182

Port 0 (for --port, --xsub, --xpub, --replay-port) binds a free port; the
ready line names the ports bound.
"""
from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.runtime.discovery.discd import DiscdServer
from dynamo_tpu_torch.runtime.events.zmq_plane import EventBroker
from dynamo_tpu_torch.utils.logging import configure_logging


async def main() -> None:
    parser = argparse.ArgumentParser("dynamo-tpu control plane services")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6180, help="discd KV port")
    parser.add_argument("--xsub", type=int, default=6181, help="event broker XSUB port")
    parser.add_argument("--xpub", type=int, default=6182, help="event broker XPUB port")
    parser.add_argument("--no-events", action="store_true", help="discovery only")
    parser.add_argument("--events-log", default=None,
                        help="durable event log path (JetStream role): "
                        "persists every event with a sequence number and "
                        "serves replay on --replay-port")
    parser.add_argument("--replay-port", type=int, default=6183)
    parser.add_argument("--snapshot", default=None,
                        help="keyspace+lease snapshot file: restored at "
                        "startup, written on change — a crashed discd comes "
                        "back with the same keys and live lease ids (the "
                        "etcd-durability role, single-node form)")
    args = parser.parse_args()

    configure_logging()
    server = DiscdServer(args.host, args.port, snapshot_path=args.snapshot)
    await server.start()
    broker = None
    if not args.no_events:
        broker = EventBroker(
            args.host, args.xsub, args.xpub,
            log_path=args.events_log,
            replay_port=args.replay_port if args.events_log else 0,
        )
        broker.start()
    print(
        f"discd ready: discovery {args.host}:{server.bound_port}"
        + (f", events {broker.address}" if broker else "")
        + (f", replay :{broker.replay_port}" if broker and broker.log_path else ""),
        flush=True,
    )
    try:
        await asyncio.Event().wait()
    finally:
        if broker:
            await broker.close()
        await server.stop()


if __name__ == "__main__":
    asyncio.run(main())
